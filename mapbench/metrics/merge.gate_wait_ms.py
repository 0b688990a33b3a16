"""Host ms a merge waits at the change gate's one readback for the device
(the engine's span merge.gate_wait, the stamps of FrameOutput.gate_sync_ms),
per merge: the rest of merge.ms is the host issuing the merge."""
from mapbench import program

program.start()


def read(t):
    p = program.of(t)
    n = p.calls("merge") if p is not None else 0
    return p.total_ms("merge.gate_wait") / n if n else None
