"""The comparison that decides `correct`: the engine's map after the window
against the plain reference's replay of the same frames.

The engine's results are read from its public state, its archive rows
(the documented packed format, decoded here), its host mirror and its
last frame's outputs; every closest-site coordinate is made global.  Each
number compared is a count of differing items, or of blocks the archive
dropped on either side, and each limit is 0: the map is exact and the
archive drops nothing (the configuration's guarantees).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.mapper import INV, VB

INV16 = 32767  # the engine's int16 "no closest site"
FIELDS = ("occ_val", "vox_type", "dist_sq", "coc")
LIMITS = {"canvas_diff": 0, "archive_diff": 0, "archive_dropped": 0, "mirror_diff": 0,
          "output_diff": 0}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _global_coc(rel, anchor):
    """int16 relative cocs [..., 3] with anchor [..., 3] -> int64 global,
    INV where none."""
    rel = np.asarray(rel)
    ok = rel[..., :1] != INV16
    return np.where(ok, rel.astype(np.int64) + anchor, INV)


def _unpack_rows(rows):
    """Packed block rows uint32 [n, 512, 3] -> fields [n, 8, 8, 8(, 3)]:
    w0 = dist | occ << 20 | type << 28; w1 = coc x | coc y << 16; w2 =
    coc z (int16 each)."""
    w0, w1, w2 = rows[..., 0], rows[..., 1], rows[..., 2]
    s16 = lambda v: (v & 0xFFFF).astype(np.uint16).view(np.int16)
    n = rows.shape[0]
    shp = (n, VB, VB, VB)
    return {"dist_sq": (w0 & 0xFFFFF).astype(np.int64).reshape(shp),
            "occ_val": ((w0 >> 20) & 0xFF).astype(np.uint8).reshape(shp),
            "vox_type": ((w0 >> 28) & 0xF).astype(np.int8).reshape(shp),
            "coc": np.stack([s16(w1), s16(w1 >> 16), s16(w2)], -1).reshape(shp + (3,))}


def snapshot(mapper) -> dict:
    """The engine's results on the host: canvas, archive, mirror, outputs."""
    st = mapper.state
    origin = _np(st.origin_blk).astype(np.int64)
    canvas = {"origin_blk": origin, "occ_val": _np(st.occ_val),
              "vox_type": _np(st.vox_type), "dist_sq": _np(st.dist_sq).astype(np.int64),
              "coc": _global_coc(_np(st.coc), origin * VB), "present": _np(st.present)}
    n = int(_np(st.n_arch))
    keys = _np(st.arch_keys)[:n].astype(np.int64)
    rows = _np(st.a_packed)[:n].view(np.uint32).reshape(n, 512, 3)
    f = _unpack_rows(rows)
    archive = {}
    for i, key in enumerate(map(tuple, keys.tolist())):
        blk = {k: f[k][i] for k in FIELDS}
        blk["coc"] = _global_coc(blk["coc"], np.asarray(key) * VB)
        archive[key] = blk
    mirror = {}
    for key, blk in (mapper.mirror.blocks.items() if mapper.mirror is not None else ()):
        c = np.asarray(blk["coc"]).astype(np.int64)
        mirror[tuple(int(k) for k in key)] = {
            "occ_val": np.asarray(blk["occ_val"]), "vox_type": np.asarray(blk["vox_type"]),
            "dist_sq": np.asarray(blk["dist_sq"]).astype(np.int64),
            "coc": np.where(c[..., :1] != INV16, c, INV)}
    raw = mapper.last_output.raw
    c = _np(raw["coc"]).astype(np.int64)
    out = {"edt": _np(raw["edt"]), "glb_type": _np(raw["glb_type"]),
           "dist_sq": _np(raw["dist_sq"]).astype(np.int64),
           "coc": np.where(c[..., :1] != INV16, c, INV)}
    return {"canvas": canvas, "archive": archive, "mirror": mirror, "outputs": out,
            "arch_dropped": int(_np(st.arch_dropped))}


def ref_snapshot(ref) -> dict:
    """A reference mapper's results in snapshot()'s form (the control's
    side of a comparison)."""
    canvas = {k: _np(v) for k, v in ref.canvas().items()}
    return {"canvas": canvas, "archive": ref.archive, "mirror": ref.mirror,
            "outputs": {k: _np(v) for k, v in ref.last_out.items()},
            "arch_dropped": ref.dropped}


def _diff_vox(a: dict, b: dict, names) -> int:
    """Voxels where any of the fields `names` differ."""
    bad = None
    for k in names:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        d = (x != y)
        if d.ndim > 3 and d.shape[-1] == 3 and k == "coc":
            d = d.any(-1)
        bad = d if bad is None else bad | d
    return int(bad.sum())


def _diff_blocks(a: dict, b: dict) -> int:
    """Keys held by one side only, plus voxels that differ in blocks both
    hold."""
    n = len(set(a) ^ set(b))
    for k in set(a) & set(b):
        n += _diff_vox(a[k], b[k], FIELDS)
    return n


def compare(eng: dict, ref) -> list:
    """[(name, value, limit)] of the engine's snapshot against a finished
    reference (reference.mapper.RefMapper)."""
    rc = {k: _np(v) for k, v in ref.canvas().items()}
    ec = eng["canvas"]
    if not np.array_equal(ec["origin_blk"], rc["origin_blk"]):
        canvas = int(np.prod(ec["occ_val"].shape))
    else:
        canvas = _diff_vox(ec, rc, FIELDS) + int((ec["present"] != rc["present"]).sum())
    archive = _diff_blocks(eng["archive"], ref.archive)
    # the guarantee itself: the archive drops nothing, on either side
    dropped = eng["arch_dropped"] + ref.dropped
    mirror = _diff_blocks(eng["mirror"], ref.mirror)
    ro = {k: _np(v) for k, v in ref.last_out.items()}
    output = _diff_vox(eng["outputs"], ro, ("edt", "glb_type", "dist_sq", "coc"))
    vals = {"canvas_diff": canvas, "archive_diff": archive, "archive_dropped": dropped,
            "mirror_diff": mirror, "output_diff": output}
    return [(k, vals[k], LIMITS[k]) for k in LIMITS]


def detail(eng: dict, ref) -> dict:
    """Per-field counts, for a run that is not correct."""
    rc = {k: _np(v) for k, v in ref.canvas().items()}
    ec = eng["canvas"]
    out = {"origin": [ec["origin_blk"].tolist(), rc["origin_blk"].tolist()]}
    if np.array_equal(ec["origin_blk"], rc["origin_blk"]):
        for k in FIELDS:
            out[k] = _diff_vox(ec, rc, (k,))
        out["present"] = int((ec["present"] != rc["present"]).sum())
    out["archive_keys"] = [len(eng["archive"]), len(ref.archive),
                           len(set(eng["archive"]) ^ set(ref.archive))]
    out["mirror_keys"] = [len(eng["mirror"]), len(ref.mirror),
                          len(set(eng["mirror"]) ^ set(ref.mirror))]
    out["dropped"] = [eng["arch_dropped"], ref.dropped]
    return out
