"""The O(N) exact envelope of csrc/envelope.cu (envelope_packed), modelled
step for step in numpy, against the port's plain version and the JAX
package's Pallas kernel.

The CUDA kernel cannot run on the CPU, so `fh_envelope` below repeats the
arithmetic of its body (shared with envelope_mid, tests/
test_torch_envelope_mid.py): one column of sites per lane, all lanes in
lockstep as the threads of a warp run them (each lane with its own stack
and pointer, a mask where the CUDA code branches).  Each lane's sites and
rows are cut into six chunks, one warp each.  Pass 1 walks a chunk's
sites in increasing order over a stack of (site, start); pass 2 walks a
chunk's rows with a pointer into every chunk's stack and keeps the min of
their packed keys.  Every case must equal
`envelope_packed_plain` on every lane (site-free lanes included), and the
Pallas kernel (interpret mode, as tests/test_torch_edt.py runs it) wherever
the winner's cost is below the cap, which is the Pallas kernel's own
precondition (envelope_pallas's docstring).

The cases come from tests/test_torch_envelope_cases.py (numpy only), which
also feeds them to the kernel on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch.ops.kernels import envelope as tenv
from test_torch_envelope_cases import CASES, case


@pytest.fixture
def jenv(monkeypatch):
    """The JAX package's envelope module, its Pallas calls in interpret
    mode."""
    from gie_mapping_tpu.ops.pallas import envelope as jenv

    orig = jenv.pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(jenv.pl, "pallas_call", patched)
    jenv._envelope_2d._clear_cache()
    yield jenv
    jenv._envelope_2d._clear_cache()


def c_div(a, d):
    """C's integer division (truncates toward zero), elementwise."""
    q = np.abs(a) // np.abs(d)
    return np.where((a < 0) != (d < 0), -q, q).astype(np.int32)


def floor_div(a, d):
    """Floor division for d > 0, as the kernel spells it from C's `/`."""
    q = c_div(a, d)
    return np.where(a - q * d < 0, q - 1, q).astype(np.int32)


CHUNKS = 6  # kPackedChunks of csrc/envelope.cu


def envelope_fh(w, yb):
    """numpy model of the CUDA envelope_packed kernel: (key, pay) int32
    shaped like w [N, ...].  The kernel unpacks each word where it reads it
    (f = valid ? w >> (yb + 1) : cap, payload = w & mask); the model unpacks
    first, then runs the shared body."""
    shape = w.shape
    N = shape[0]
    w = w.reshape(N, -1).astype(np.int32)
    cap = np.int32((1 << (31 - tenv.env_idx_bits(N))) - 1)
    f = np.where((w & 1) != 0, w >> (yb + 1), cap).astype(np.int32)
    key, pay = fh_envelope(f, w & np.int32((1 << (yb + 1)) - 1), CHUNKS)
    return key.reshape(shape), pay.reshape(shape)


def fh_envelope(f, p, chunks):
    """numpy model of csrc/envelope.cu's shared O(N) body (envelope_fh):
    site costs f and payloads p, int32 [N, L] (a site at f >= cap is
    none) -> (key, pay) int32 [N, L], with `chunks` site chunks per lane."""
    N, L = f.shape
    lanes = np.arange(L)
    ib = tenv.env_idx_bits(N)
    cap = np.int32((1 << (31 - ib)) - 1)
    g = lambda site: f[site, lanes] + site * site
    M = -(-N // chunks)
    stacks = np.zeros((chunks, M, L), np.int32)
    sizes = np.zeros((chunks, L), np.int32)

    # pass 1, one warp per chunk (the warps run in parallel on the card):
    # the stack of (site << 16 | start) of sites [c M, c M + M)
    for c in range(chunks):
        stk, sp = stacks[c], sizes[c]
        for q in range(c * M, min(N, c * M + M)):
            fq = f[q]
            act = fq < cap
            gq = fq + np.int32(q * q)
            while True:  # pop while b(top, q) < start(top)
                top = stk[np.maximum(sp - 1, 0), lanes]
                v, s = top >> 16, top & 0xFFFF
                # floor((gq - gv) / (2 (q - v))) < s <=> gq - gv < s * 2 (q - v)
                pop = act & (sp > 0) & (gq - g(v) < s * 2 * (q - v))
                if not pop.any():
                    break
                sp -= pop
            top = stk[np.maximum(sp - 1, 0), lanes]
            v = top >> 16
            den = np.where(sp > 0, 2 * (q - v), 1)
            start = np.where(sp > 0, floor_div(gq - g(v), den) + 1, 0)
            push = act & (start <= N - 1)
            stk[sp[push], lanes[push]] = (q << 16) | start[push]
            sp += push

    # pass 2, warp c writes rows [c M, c M + M): the lexicographic min of
    # (cost, site) over the chunks' envelopes, chunks in site order and a
    # strict < (ties to the smaller site).  A pointer per chunk, placed by
    # a binary search over the starts and moved at most once per row (the
    # starts strictly increase from 0; past the top, an end marker whose
    # start no row reaches).  A chunk without a site has cost cap.
    end = np.int32(0xFFFF)
    key = np.empty((N, L), np.int32)
    for c in range(chunks):
        x0, x1 = c * M, min(N, c * M + M)
        if x0 >= x1:
            continue
        entry = lambda k, i: np.where(i < sizes[k], stacks[k][np.minimum(i, M - 1), lanes], end)
        nxt, v, fv = [], [], []
        for k in range(chunks):
            lo, hi = np.zeros(L, np.int32), sizes[k] - 1
            while (lo < hi).any():
                mid = (lo + hi + 1) >> 1
                ok = (entry(k, mid) & 0xFFFF) <= x0
                run = lo < hi
                lo = np.where(run & ok, mid, lo)
                hi = np.where(run & ~ok, mid - 1, hi)
            sited = hi >= 0
            v.append(np.where(sited, entry(k, lo) >> 16, 0))
            fv.append(np.where(sited, f[v[k], lanes], cap))
            nxt.append(np.where(sited, lo + 1, 0))
        for x in range(x0, x1):
            bc, bv = np.full(L, cap, np.int32), np.zeros(L, np.int32)
            for k in range(chunks):
                adv = (entry(k, nxt[k]) & 0xFFFF) <= x
                v[k] = np.where(adv, entry(k, nxt[k]) >> 16, v[k])
                fv[k] = np.where(adv, f[v[k], lanes], fv[k])
                nxt[k] = nxt[k] + adv
                cost = (x - v[k]) * (x - v[k]) + fv[k]
                bv = np.where(cost < bc, v[k], bv)
                bc = np.minimum(cost, bc)
            key[x] = (bc << ib) | bv  # bc == cap leaves bv = 0: the capped key
    return key, p[key & ((1 << ib) - 1), lanes]


@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain_every_lane(name):
    w, yb = case(name)
    key, pay = envelope_fh(w, yb)
    pk, pp = (a.numpy() for a in tenv.envelope_packed_plain(torch.from_numpy(w), yb))
    np.testing.assert_array_equal(key, pk)
    np.testing.assert_array_equal(pay, pp)


PALLAS_CASES = ["ties", "site_free", "random_N1", "random_N3", "random_N152",
                "random_N257", "near_cap_N152", "near_cap_N257", "falling_N152"]


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_model_matches_pallas(jenv, name):
    import jax.numpy as jnp

    w, yb = case(name)
    key, pay = envelope_fh(w, yb)
    kk, kp = (np.asarray(a) for a in jenv.envelope_packed_pallas(
        jnp.asarray(w), yb, packed_out=True, fusepay=True))
    ib = tenv.env_idx_bits(w.shape[0])
    below = (key >> ib) < (1 << (31 - ib)) - 1
    np.testing.assert_array_equal(key[below], kk[below])
    np.testing.assert_array_equal(pay[below], kp[below])
    # where nothing is below the cap both report the capped key
    np.testing.assert_array_equal(kk[~below] >> ib, key[~below] >> ib)


def test_cases_cover_the_edges():
    """The cases do reach what they are named for: ties, capped rows,
    site-free lanes, pops, and negative numerators at the push."""
    w, yb = case("ties")
    key, _ = envelope_fh(w, yb)
    f = np.where(w & 1, w >> (yb + 1), 1 << 28)
    d = (np.arange(50)[:, None, None] - np.arange(50)[None, :, None]) ** 2 + f[None]
    assert ((d == d.min(1, keepdims=True)).sum(1) > 1).any()   # equal-cost winners
    w, yb = case("near_cap_N152")
    key, _ = envelope_fh(w, yb)
    ib = tenv.env_idx_bits(152)
    assert ((key >> ib) == (1 << (31 - ib)) - 1).any()
    assert ((key >> ib) == (1 << (31 - ib)) - 2).any() or \
        ((key >> ib) > (1 << (31 - ib)) - 3 * 152).any()
    w, yb = case("falling_N152")
    g = (w >> (yb + 1)) + np.arange(152)[:, None] ** 2
    assert (np.diff(g, axis=0) < 0).any()
