"""Host ms of one merge (pipeline.merge_frame: fusion, the change gate and
its EDT, frontiers, changed blocks), per frame; the gate's readback makes
the host wait there for the device."""


def read(t):
    return t.mean_ms("merge")
