"""Share of the EDT chain's roofline (phase 1 and both envelopes): their
summed bound (bytes each call must move, from its shape, over the card's
bandwidth) over their summed device time, in %."""
from mapbench.roofline import EDT_KERNELS


def read(t):
    return t.roofline_share(EDT_KERNELS)
