"""Host ms of a frame's measurement staged and uploaded to the card before
the sensor model (the engine's span sensor.stage: a point cloud padded on
the host and copied, a depth image copied), per frame."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    return p.mean_ms("sensor.stage") if p is not None else None
