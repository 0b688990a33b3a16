"""Share of the traced window in which no device record ran, in %."""


def read(t):
    w0, w1 = t.window_ns
    return 100.0 * (1.0 - t.busy_ns() / (w1 - w0)) if w1 > w0 else None
