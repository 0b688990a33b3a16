"""Host ms of one ingest of streamed rows into the host mirror
(HostMirror.ingest_rows), per tick."""


def read(t):
    return t.mean_ms("ingest")
