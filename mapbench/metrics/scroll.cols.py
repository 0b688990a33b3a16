"""Block-columns a scroll packs and moves (the engine's counter
scroll.cols, the host's compact-column bucket), per scroll: the size
that scroll.archive_ms grows with."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    return p.mean("scroll.cols") if p is not None else None
