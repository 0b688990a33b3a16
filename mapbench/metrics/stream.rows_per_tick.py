"""Served rows an ingest finds in valid block-columns (the engine's counter
stream.rows: valid columns times the canvas's blocks a column), per
ingest: how many of the rows the fixed unpack decodes carry a column, to
set beside stream.blocks_per_tick, the blocks of them that changed."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    return p.mean("stream.rows") if p is not None else None
