"""Host ms of a scroll's two archive sections (the engine's spans
scroll.archive_out, the outgoing blocks packed and archived, and
scroll.archive_in, the entering blocks loaded and the canvas unpacked),
per scroll; the rest of scroll.ms is the shift."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    n = p.calls("scroll.shift") if p is not None else 0
    return p.total_ms("scroll.archive_out", "scroll.archive_in") / n if n else None
