"""Share of the roofline of every hand-written kernel that ran (the EDT
chain, the canvas shift, the four block-row copies): summed bound over
summed device time, in %."""
from mapbench.roofline import KERNELS


def read(t):
    return t.roofline_share(tuple(KERNELS))
