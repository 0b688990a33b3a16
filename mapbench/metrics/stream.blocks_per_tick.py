"""Blocks an ingest writes into the mirror (the engine's counter
stream.blocks), per ingest: the part of stream.ingest_ms that grows with
the blocks that changed."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    return p.mean("stream.blocks") if p is not None else None
