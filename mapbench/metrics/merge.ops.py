"""Device operations (kernels, copies, fills) launched inside one merge,
its EDT included, per merge."""


def read(t):
    n = len(t.rec.stamps.get("merge", []))
    return t.ops_in(("merge", "edt", "edt_slab")) / n if n else None
