"""Host ms of one streaming tick (the mapper's _stream: the previous
tick's ingest into the mirror, the compaction and the copies started),
per frame."""


def read(t):
    return t.mean_ms("stream")
