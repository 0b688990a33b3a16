"""The edge cases of the O(N) envelope (csrc/envelope.cu, envelope_packed):
phase-1 packed words [N, ...] int32 and their yb, by name.

Ties, site-free and single-site lanes, N at the idx_bits boundaries, costs
at and just below the cap, falling costs (negative numerators), lane counts
that are not multiples of 32.  The CPU tests hold the kernel's numpy model
on them (tests/test_torch_envelope_packed.py); tests/test_torch_cuda.py and
chip_smoke.py hold the kernel on the card.  numpy and the port only: this
module holds no tests and imports neither pytest nor JAX.
"""
import numpy as np

from gie_mapping_tpu_torch.ops.kernels import envelope as tenv


def words(f, yb, valid, rng):
    """Packed words (f << (yb+1)) | (payload << 1) | valid."""
    p = rng.integers(0, 1 << yb, f.shape)
    w = (f.astype(np.int64) << (yb + 1)) | (p << 1) | valid
    assert (w >= 0).all() and (w < 1 << 31).all()  # phase 1's words are
    return w.astype(np.int32)                       # nonnegative int32


def tie_lanes(N, L, yb):
    """chip_smoke.tie_packed's pattern: many equal-cost sites per lane,
    every 7th lane without a site."""
    w = np.zeros((N, L), np.int32)
    for l in range(L):
        if l % 7 == 0:
            continue
        for i in range(l % 3, N, 2 + l % 5):
            w[i, l] = (((l % 4) ** 2) << (yb + 1)) | ((l % 50) << 1) | 1
    return w


def random_lanes(N, L, yb, seed, density=0.2, fmax=400):
    """Random sites; lane 0 site-free, lane 1 a single site at the far
    end, lane 2 a single site at 0, lane 3 every row a site."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, fmax, (N, L))
    valid = (rng.random((N, L)) < density).astype(np.int64)
    valid[:, 0] = 0
    if L > 3:
        valid[:, 1:3] = 0
        valid[-1, 1] = valid[0, 2] = 1
        valid[:, 3] = 1
    return words(f, yb, valid, rng)


def near_cap(N, L, seed):
    """Costs just below, at and above the cap: yb small enough that f
    reaches past cap = (1 << (31 - idx_bits)) - 1."""
    ib = tenv.env_idx_bits(N)
    cap = (1 << (31 - ib)) - 1
    yb = max(0, min(ib - 2, 6))
    rng = np.random.default_rng(seed)
    f = cap - rng.integers(0, 3 * N, (N, L))
    f[rng.random((N, L)) < 0.1] = cap
    if yb <= ib - 2:  # room in the word for a cost above the cap
        f[rng.random((N, L)) < 0.05] = cap + rng.integers(1, 50)
    f[:, ::5] = rng.integers(0, 50, (N, len(range(0, L, 5))))   # a low site
    valid = (rng.random((N, L)) < 0.5).astype(np.int64)
    valid[:, 1::5] = 0          # one near-cap site: the rows away from it cap
    valid[rng.integers(0, N, len(range(1, L, 5))), np.arange(1, L, 5)] = 1
    return words(f, yb, valid, rng), yb


def falling_costs(N, L, yb, seed):
    """g_q < g_v for v < q: costs fall steeply with the site index, so the
    pop test and the push boundary see negative numerators."""
    rng = np.random.default_rng(seed)
    f = (N - np.arange(N))[:, None] ** 2 * 4 + rng.integers(0, 3, (N, L))
    valid = (rng.random((N, L)) < 0.6).astype(np.int64)
    return words(f, yb, valid, rng)


def case(name):
    if name == "ties":
        return tie_lanes(50, 300, 6), 6
    if name.startswith("random_N"):
        N = int(name[len("random_N"):])
        yb = 8
        return random_lanes(N, 67, yb, seed=N, density=0.05 if N > 100 else 0.3), yb
    if name == "sparse_152":
        return random_lanes(152, 129, 8, seed=7, density=0.01), 8
    if name == "site_free":
        w = random_lanes(40, 45, 5, seed=3, density=0.0)
        w[17, 9] |= 1  # one single-site lane among site-free ones
        return w, 5
    if name.startswith("near_cap_N"):
        return near_cap(int(name[len("near_cap_N"):]), 50, seed=11)
    if name.startswith("falling_N"):
        N = int(name[len("falling_N"):])
        return falling_costs(N, 40, 7, seed=N), 7
    if name == "slab_3d":  # [N, Z, Y] as the gate's slab passes it
        return random_lanes(24, 7 * 9, 5, seed=5).reshape(24, 7, 9), 5
    raise KeyError(name)


CASES = (["ties", "site_free", "sparse_152", "slab_3d"]
         + [f"random_N{n}" for n in (1, 2, 3, 152, 255, 256, 257)]
         + [f"near_cap_N{n}" for n in (1, 2, 3, 152, 257)]
         + [f"falling_N{n}" for n in (3, 152, 257)])
