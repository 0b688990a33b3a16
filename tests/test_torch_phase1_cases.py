"""The edge cases of phase 1 (csrc/phase1.cu, phase1_packed): int8 type
canvases [X, Y, Z] and their max_width, by name.

Y at and around the 32-bit word boundaries up to the limit 1024, empty and
full columns, a lone site at y = 0 or Y - 1, two sites at equal distance
(the tie goes to the lower y), max_width below Y, Z from 1 to 80 (z-tiles
that the canvas does not fill).  The CPU tests hold the kernel's numpy
model on them (tests/test_torch_phase1.py); tests/test_torch_cuda.py and
chip_smoke.py hold the kernel on the card.  numpy only: this module holds
no tests and imports neither pytest nor JAX.
"""
import numpy as np

OCC, FREE = 2, 1


def canvas(X, Y, Z, seed, frac=0.05):
    """Random types (OCCUPIED with probability frac, else UNKNOWN or FREE);
    column z = 0 of plane 0 empty, z = 1 full, z = 2 a lone site at y = 0,
    z = 3 at y = Y - 1, z = 4 two sites at equal distance from the middle
    (as far as Z reaches)."""
    rng = np.random.default_rng(seed)
    t = np.where(rng.random((X, Y, Z)) < frac, OCC,
                 rng.integers(0, 2, (X, Y, Z))).astype(np.int8)
    cols = [np.full(Y, FREE), np.full(Y, OCC), np.full(Y, FREE),
            np.full(Y, FREE), np.full(Y, FREE)]
    cols[2][0] = OCC
    cols[3][-1] = OCC
    if Y >= 3:
        m = Y // 2
        cols[4][m - min(m, Y - 1 - m)] = cols[4][m + min(m, Y - 1 - m)] = OCC
    for z, col in enumerate(cols[:Z]):
        t[0, :, z] = col
    return t


def case(name):
    if name.startswith("Y"):
        Y = int(name[1:])
        return canvas(3, Y, 5, seed=Y, frac=0.02 if Y > 100 else 0.1), 3 + Y + 5
    if name.startswith("Z"):
        Z = int(name[1:])
        Y = 100 if Z == 1 else 152 if Z == 80 else 40
        return canvas(4, Y, Z, seed=Z), 4 + Y + Z
    if name == "narrow":  # max_width below Y: far voxels are not valid
        return canvas(3, 152, 9, seed=5, frac=0.01), 20
    if name == "empty":
        return np.full((2, 33, 6), FREE, np.int8), 41
    if name == "full":
        return np.full((2, 65, 3), OCC, np.int8), 70
    if name == "ties":  # sites every 2 + z y: many voxels midway between two
        t = np.full((2, 64, 7), FREE, np.int8)
        for z in range(7):
            t[:, z::2 + z, z] = OCC
        return t, 73
    raise KeyError(name)


CASES = ([f"Y{n}" for n in (1, 2, 31, 32, 33, 63, 64, 65, 152, 1024)]
         + [f"Z{n}" for n in (1, 3, 80)] + ["narrow", "empty", "full", "ties"])
