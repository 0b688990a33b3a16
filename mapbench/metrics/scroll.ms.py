"""Host ms of one canvas scroll (pipeline.scroll_step: archive out, shift,
archive in), per scroll; nothing to read where the canvas never moves."""


def read(t):
    return t.mean_ms("scroll")
