"""The O(N) phase-3 envelope of csrc/envelope.cu (envelope_mid), modelled
step for step in numpy, against the port's plain version and the JAX
package's Pallas kernel.

envelope_mid runs the body that envelope_packed runs (envelope_fh), on
separate costs and payloads [B, N, L] with sites on the middle axis: a CTA
takes 32 lanes of one batch row b, so each (b, lane) is one column of N
sites, and the model (`fh_envelope` of tests/test_torch_envelope_packed.py)
runs every column of every row in lockstep.  Every case must equal
`envelope_mid_plain` on every lane (site-free ones included) at the
kernel's four chunks, and the Pallas kernel (interpret mode, as
tests/test_torch_edt.py runs it) wherever the winner's cost is below the
cap, which is the Pallas kernel's own precondition.

The cases come from tests/test_torch_envelope_cases.py (numpy only), which
also feeds them to the kernel on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch.ops.kernels import envelope as tenv
from test_torch_envelope_cases import BIG, MID_CASES, mid_case
from test_torch_envelope_packed import fh_envelope

MID_CHUNKS = 4  # kMidChunks of csrc/envelope.cu


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
    jenv._envelope_mid_3d._clear_cache()
    yield jenv
    jenv._envelope_mid_3d._clear_cache()


def envelope_mid_fh(f, pay):
    """numpy model of the CUDA envelope_mid kernel: (key, pay) int32 shaped
    like f [B, N, ...]."""
    shape = f.shape
    B, N = shape[:2]
    cols = lambda a: a.reshape(B, N, -1).transpose(1, 0, 2).reshape(N, -1)
    key, p = fh_envelope(cols(f).astype(np.int32), cols(pay), MID_CHUNKS)
    back = lambda a: a.reshape(N, B, -1).transpose(1, 0, 2).reshape(shape)
    return back(key), back(p)


def _plain(f, pay):
    return (a.numpy() for a in tenv.envelope_mid_plain(torch.from_numpy(f),
                                                        torch.from_numpy(pay)))


@pytest.mark.parametrize("name", MID_CASES)
def test_model_matches_plain_every_lane(name):
    f, pay = mid_case(name)
    key, p = envelope_mid_fh(f, pay)
    pk, pp = _plain(f, pay)
    np.testing.assert_array_equal(key, pk)
    np.testing.assert_array_equal(p, pp)


PALLAS_CASES = ["mid_ties", "mid_site_free", "mid_random_N1", "mid_random_N9",
                "mid_random_N80", "mid_random_N129", "mid_L33",
                "mid_near_cap_N80", "mid_falling_N80"]


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_model_matches_pallas(jenv, name):
    import jax.numpy as jnp

    f, pay = mid_case(name)
    key, p = envelope_mid_fh(f, pay)
    kk, kp = (np.asarray(a) for a in jenv.envelope_mid_pallas(
        jnp.asarray(f), (jnp.asarray(pay),), packed_out=True, fusepay=True))
    ib = tenv.env_idx_bits(f.shape[1])
    below = (key >> ib) < (1 << (31 - ib)) - 1
    assert below.any()
    np.testing.assert_array_equal(key[below], kk[below])
    np.testing.assert_array_equal(p[below], kp[below])
    # where nothing is below the cap both report the capped key
    np.testing.assert_array_equal(kk[~below] >> ib, key[~below] >> ib)


def test_cases_cover_the_edges():
    """The cases reach what they are named for: equal-cost winners,
    capped rows beside sited ones, site-free lanes, costs above the cap
    and at BIG, falling costs, lane counts off multiples of 32."""
    f, _ = mid_case("mid_ties")
    N = f.shape[1]
    d = (np.arange(N)[:, None, None, None] - np.arange(N)[None, :, None, None]) ** 2 \
        + np.where(f < BIG, f, 1 << 40)[None].transpose(0, 2, 1, 3)
    assert ((d == d.min(1, keepdims=True)).sum(1) > 1).any()
    f, pay = mid_case("mid_near_cap_N80")
    key, _ = envelope_mid_fh(f, pay)
    ib = tenv.env_idx_bits(80)
    cap = (1 << (31 - ib)) - 1
    capped = (key >> ib) == cap
    assert (capped.any(1) & (~capped).any(1)).any()  # capped rows of sited lanes
    assert (f > cap).any() and (f == BIG).any() and (f == cap).any()
    f, _ = mid_case("mid_site_free")
    assert ((f >= BIG).all(1)).sum() > 1
    f, _ = mid_case("mid_falling_N80")
    g = f + np.arange(80)[None, :, None] ** 2
    assert (np.diff(g, axis=1) < 0).any()
    assert all(mid_case(n)[0].shape[2] % 32 for n in MID_CASES)


def test_cpu_tensors_take_any_n():
    """Above the kernel's N limit the CUDA wrapper raises; CPU tensors take
    the plain version at any N."""
    f = torch.full((1, tenv.ENVELOPE_MID_MAX_N + 1, 3), BIG, dtype=torch.int32)
    f[0, 5] = 1
    key, p = tenv.envelope_mid(f, f.clone())
    assert (key[0, :, 0] & ((1 << tenv.env_idx_bits(f.shape[1])) - 1) == 5).all()
