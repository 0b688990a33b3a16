"""Changed block-columns left for later ticks when a tick's rows arrive on
the host (the engine's counter stream.backlog_cols, the capacity monitor's
stream_leftover), per tick: the mirror's lag behind the map."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    return p.mean("stream.backlog_cols") if p is not None else None
