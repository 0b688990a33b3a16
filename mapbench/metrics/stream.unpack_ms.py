"""Host ms of the unpack of every served row at the start of an ingest into
the mirror (the engine's span stream.unpack), per ingest: the fixed part of
stream.ingest_ms, whatever the blocks that changed."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    return p.mean_ms("stream.unpack") if p is not None else None
