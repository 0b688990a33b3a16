"""The PyTorch port's EDT chain against the JAX package, bit for bit.

Inputs are made from seeds with numpy and fed to both packages.  The JAX
Pallas kernels run in interpret mode (the `interp` fixture, as
tests/test_envelope_pallas.py runs them) and their XLA twins run as they
do on the CPU; the port runs the plain versions its kernel wrappers take
for CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import gie_mapping_tpu.ops.edt_batch as jeb
from gie_mapping_tpu.ops.pallas import envelope as jenv
from gie_mapping_tpu.ops.pallas import phase1 as jp1
from gie_mapping_tpu_torch.ops import edt_batch as teb
from gie_mapping_tpu_torch.ops.kernels import envelope as tenv
from gie_mapping_tpu_torch.ops.kernels import phase1 as tp1


@pytest.fixture
def interp(monkeypatch):
    orig = jenv.pl.pallas_call  # shared jax.experimental.pallas module

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(jenv.pl, "pallas_call", patched)
    caches = (jenv._envelope_2d, jenv._envelope_mid_3d,
              jp1.phase1_packed_pallas)
    for f in caches:
        f._clear_cache()
    yield
    for f in caches:
        f._clear_cache()


def _types(shape, frac, seed):
    """int8 type canvas: OCCUPIED (2) with probability frac, else FREE or
    UNKNOWN; one y-column without a site and one full of sites."""
    rng = np.random.default_rng(seed)
    t = np.where(rng.random(shape) < frac, 2,
                 rng.integers(0, 2, shape)).astype(np.int8)
    t[0, :, 0] = 1
    t[-1, :, -1] = 2
    return t


T = torch.from_numpy


@pytest.mark.parametrize("shape,frac", [((16, 50, 12), 0.06), ((9, 33, 7), 0.2),
                                        ((8, 8, 130), 0.02)])
def test_phase1_matches_pallas_and_xla(interp, shape, frac):
    t = _types(shape, frac, seed=3)
    mw = sum(shape)
    want = np.asarray(jp1.phase1_packed_pallas(
        jnp.asarray((t == 2).astype(np.int8)), max_width=mw))
    np.testing.assert_array_equal(
        want, np.asarray(jeb.phase1_packed_xla(jnp.asarray(t == 2), mw)))
    np.testing.assert_array_equal(tp1.phase1_packed(T(t), mw).numpy(), want)
    # an x-slab written in place into a larger buffer (the p1-cache patch)
    buf = torch.full(shape, -5, dtype=torch.int32)
    tp1.phase1_packed(T(t[2:6]), mw, out=buf[2:6])
    np.testing.assert_array_equal(buf[2:6].numpy(), want[2:6])
    assert (buf[:2] == -5).all() and (buf[6:] == -5).all()


def _packed_xzy(shape, frac, seed):
    t = _types(shape, frac, seed)
    p = np.asarray(jeb.phase1_packed_xla(jnp.asarray(t == 2), sum(shape)))
    return np.ascontiguousarray(np.transpose(p, (0, 2, 1))), \
        jp1.phase1_pack_bits(shape[1])


@pytest.mark.parametrize("shape,frac", [((24, 20, 12), 0.03), ((40, 17, 9), 0.1)])
def test_envelope_packed_matches_pallas_and_dense(interp, shape, frac):
    w, yb = _packed_xzy(shape, frac, seed=11)
    key_k, pay_k = (np.asarray(a) for a in jenv.envelope_packed_pallas(
        jnp.asarray(w), yb, packed_out=True, fusepay=True))
    key_t, pay_t = (a.numpy() for a in tenv.envelope_packed(T(w), yb))
    sited = ((w & 1) > 0).any(0, keepdims=True) & np.ones_like(w, bool)
    np.testing.assert_array_equal(key_t[sited], key_k[sited])
    np.testing.assert_array_equal(pay_t[sited], pay_k[sited])
    assert (pay_k[~sited] & 1 == 0).all() and (pay_t[~sited] & 1 == 0).all()
    # every lane: the dense XLA envelope on the unpacked word
    f = np.where((w & 1) > 0, w >> (yb + 1), 1 << 28).astype(np.int32)
    key_d, pay_d = (np.asarray(a) for a in jeb.lower_envelope(
        jnp.asarray(f), payloads=(jnp.asarray(w & ((1 << (yb + 1)) - 1)),),
        packed_out=True))
    np.testing.assert_array_equal(key_t, key_d)
    np.testing.assert_array_equal(pay_t, pay_d)


def _mid_inputs(seed):
    rng = np.random.default_rng(seed)
    B, N, L = 6, 21, 37
    f = rng.integers(0, 300, (B, N, L)).astype(np.int32)
    f[rng.random((B, N, L)) < 0.7] = 1 << 28
    f[:, :, ::6] = 1 << 28          # lanes without a site
    f[:, ::4, 1::6] = 7             # equal costs: distance ties
    pay = (rng.integers(0, 1 << 19, (B, N, L)).astype(np.int32) << 1) \
        | (f < (1 << 28)).astype(np.int32)
    return f, pay


def test_envelope_mid_matches_pallas_and_dense(interp):
    f, pay = _mid_inputs(seed=4)
    key_k, pay_k = (np.asarray(a) for a in jenv.envelope_mid_pallas(
        jnp.asarray(f), (jnp.asarray(pay),), packed_out=True, fusepay=True))
    key_t, pay_t = (a.numpy() for a in tenv.envelope_mid(T(f), T(pay)))
    sited = (f < (1 << 28)).any(1, keepdims=True) & np.ones_like(f, bool)
    np.testing.assert_array_equal(key_t[sited], key_k[sited])
    np.testing.assert_array_equal(pay_t[sited], pay_k[sited])
    mv = lambda a: jnp.moveaxis(jnp.asarray(a), 1, 0)
    key_d, pay_d = (np.moveaxis(np.asarray(a), 0, 1) for a in
                    jeb.lower_envelope(mv(f), payloads=(mv(pay),),
                                       packed_out=True))
    np.testing.assert_array_equal(key_t, key_d)
    np.testing.assert_array_equal(pay_t, pay_d)


def _assert_edt_equal(got, want):
    for k in ("dist_sq", "coc", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("shape,frac,seed", [((24, 20, 12), 0.03, 31),
                                             ((32, 40, 16), 0.005, 5),
                                             ((16, 16, 8), 0.0, 2)])
def test_batch_edt_matches_jax_and_scipy(shape, frac, seed):
    t = _types(shape, frac, seed)
    if frac == 0.0:
        t[t == 2] = 1  # no site anywhere
    mw = sum(shape)
    want = jeb.batch_edt(jnp.asarray(t), max_width=mw, pallas=False)
    got = teb.batch_edt(T(t), mw)
    _assert_edt_equal(got, want)
    p1 = tp1.phase1_packed(T(t), mw)
    _assert_edt_equal(teb.batch_edt(T(t), mw, p1_packed=p1), want)
    occ = t == 2
    valid = got["valid"].numpy()
    if occ.any():
        ref = np.rint(ndimage.distance_transform_edt(~occ) ** 2)
        np.testing.assert_array_equal(got["dist_sq"].numpy()[valid],
                                      ref[valid].astype(np.int32))
        # every voxel's coc is a site at exactly that distance
        c = got["coc"].numpy()[valid]
        assert occ[c[:, 0], c[:, 1], c[:, 2]].all()
        idx = np.argwhere(valid)
        np.testing.assert_array_equal(((idx - c) ** 2).sum(-1),
                                      got["dist_sq"].numpy()[valid])
    else:
        assert not valid.any()


@pytest.mark.parametrize("x0,y0,sx,sy", [(0, 0, 8, 16), (8, 16, 16, 24),
                                         (16, 24, 16, 16), (3, 5, 8, 8)])
def test_batch_edt_slab_matches_jax(x0, y0, sx, sy):
    shape = (32, 40, 16)
    t = _types(shape, 0.01, seed=9)
    mw = sum(shape)
    p1 = tp1.phase1_packed(T(t), mw)
    full = teb.batch_edt(T(t), mw)
    want = jeb.batch_edt_slab(jnp.asarray(t), x0, y0, sx=sx, sy=sy,
                              max_width=mw, pallas=False)
    for p in (None, p1):
        got = teb.batch_edt_slab(T(t), x0, y0, sx=sx, sy=sy, max_width=mw,
                                 p1_packed=p)
        _assert_edt_equal(got, want)
        for k in ("dist_sq", "coc", "valid"):
            assert torch.equal(got[k], full[k][x0:x0 + sx, y0:y0 + sy])
