"""The edge cases of the O(N) envelopes (csrc/envelope.cu), by name:
`case` gives envelope_packed's phase-1 packed words [N, ...] int32 and
their yb; `mid_case` gives envelope_mid's site costs and payloads
[B, N, L] int32.

Ties, site-free and single-site lanes, N at the idx_bits boundaries, costs
at and just below the cap, sites at 1 << 28 (the chain's "no site"),
falling costs (negative numerators), lane counts that are not multiples of
32, several batch rows.  The CPU tests hold the kernels' numpy models on
them (tests/test_torch_envelope_packed.py, tests/test_torch_envelope_mid.py);
tests/test_torch_cuda.py and chip_smoke.py hold the kernels on the card.
numpy and the port only: this module holds no tests and imports neither
pytest nor JAX.
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


# ---- envelope_mid: (f, pay) int32 [B, N, L] ---------------------------------
BIG = 1 << 28  # the chain's cost of a site without a phase-2 distance


def mid_payload(f, rng):
    """The chain's payload form: any bits above a valid bit (f < BIG)."""
    return ((rng.integers(0, 1 << 19, f.shape) << 1)
            | (f < BIG)).astype(np.int32)


def mid_random(B, N, L, seed, density=0.3, fmax=400):
    """Random sites at cost f < fmax, others at BIG; with L > 3, lane 0 of
    every row site-free, lane 1 a single site at N - 1, lane 2 a single
    site at 0, lane 3 a site at every row."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, fmax, (B, N, L))
    f[rng.random((B, N, L)) >= density] = BIG
    if L > 3:
        f[:, :, 0:3] = BIG
        f[:, -1, 1] = rng.integers(0, fmax, B)
        f[:, 0, 2] = rng.integers(0, fmax, B)
        f[:, :, 3] = rng.integers(0, fmax, (B, N))
    return f.astype(np.int32), mid_payload(f, rng)


def mid_ties(B, N, L):
    """Many equal-cost sites per lane (distance ties), every 7th lane
    without a site."""
    f = np.full((B, N, L), BIG, np.int64)
    for b in range(B):
        for l in range(L):
            if (l + b) % 7 == 0:
                continue
            f[b, (l + b) % 3::2 + (l + b) % 5, l] = ((l + b) % 4) ** 2
    return f.astype(np.int32), mid_payload(f, np.random.default_rng(B * N + L))


def mid_near_cap(B, N, L, seed):
    """Costs just below, at and above the cap, BIG, and a low site on every
    5th lane; every 5th lane from 1 has one near-cap site, so rows away from
    it cap."""
    ib = tenv.env_idx_bits(N)
    cap = (1 << (31 - ib)) - 1
    rng = np.random.default_rng(seed)
    f = cap - rng.integers(0, 3 * N, (B, N, L))
    f[rng.random((B, N, L)) < 0.1] = cap
    f[rng.random((B, N, L)) < 0.05] = cap + rng.integers(1, 50)
    f[rng.random((B, N, L)) < 0.3] = BIG
    f[:, :, ::5] = np.where(rng.random((B, N, len(range(0, L, 5)))) < 0.5,
                            rng.integers(0, 50, (B, N, len(range(0, L, 5)))), BIG)
    f[:, :, 1::5] = BIG
    f[:, rng.integers(0, N), 1::5] = cap - rng.integers(0, 3 * N)
    f = np.minimum(f, (1 << 31) - 1)
    return f.astype(np.int32), mid_payload(f, rng)


def mid_falling(B, N, L, seed):
    """Costs falling steeply with the site index: negative numerators at
    the pop test and the push boundary."""
    rng = np.random.default_rng(seed)
    f = (N - np.arange(N))[None, :, None] ** 2 * 4 + rng.integers(0, 3, (B, N, L))
    f[rng.random((B, N, L)) >= 0.6] = BIG
    return f.astype(np.int32), mid_payload(f, rng)


def mid_case(name):
    if name == "mid_ties":
        return mid_ties(3, 50, 45)
    if name == "mid_site_free":
        f, pay = mid_random(2, 40, 33, seed=3, density=0.0)
        f[1, 17, 9] = 5  # one single-site lane among site-free ones
        return f, pay
    if name.startswith("mid_random_N"):
        N = int(name[len("mid_random_N"):])
        return mid_random(2, N, 37, seed=N, density=0.05 if N > 100 else 0.3)
    if name.startswith("mid_L"):
        L = int(name[len("mid_L"):])
        return mid_random(3, 80, L, seed=L + 1, density=0.1)
    if name.startswith("mid_near_cap_N"):
        return mid_near_cap(2, int(name[len("mid_near_cap_N"):]), 40, seed=11)
    if name.startswith("mid_falling_N"):
        N = int(name[len("mid_falling_N"):])
        return mid_falling(2, N, 35, seed=N)
    raise KeyError(name)


MID_CASES = (["mid_ties", "mid_site_free"]
             + [f"mid_random_N{n}" for n in (1, 2, 7, 8, 9, 56, 80, 128, 129, 257)]
             + [f"mid_L{n}" for n in (1, 31, 33, 152)]
             + [f"mid_near_cap_N{n}" for n in (1, 2, 9, 80, 257)]
             + [f"mid_falling_N{n}" for n in (9, 80, 257)])
