"""Host ms a frame spends in the mapper outside its child spans (sensor,
scroll, merge, stream): the mapper layer's own dispatch and bookkeeping."""


def read(t):
    return t.frame_self_ms()
