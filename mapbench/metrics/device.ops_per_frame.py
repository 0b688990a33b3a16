"""Device records (kernels, copies, fills) in the traced window per frame."""


def read(t):
    return len(t.device) / t.frames if t.frames else None
