"""Phase 1 of csrc/phase1.cu (phase1_packed), modelled step for step in
numpy, against the port's plain version and the JAX package's Pallas
kernel.

The CUDA kernel cannot run on the CPU, so `phase1_bits` below repeats its
arithmetic: a CTA per (x-plane, tile of tz z-columns), here every plane at
once and tile by tile; a bitmask of occupied y per column, one 32-bit
word per 32 y; per word the last occupied y before it and the first after
it; then every (y, z) in parallel finds its nearest occupied y on either
side with clz / ffs on its own word, or those summaries.  Every case must
equal `phase1_packed_plain` on every voxel at the wrapper's tile width and
at every width the kernel takes (1 to 16), and the Pallas kernel (interpret mode, as
tests/test_torch_edt.py runs it).

The cases come from tests/test_torch_phase1_cases.py (numpy only), which
also feeds them to the kernel on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch.models.pipeline import kernel_limits
from gie_mapping_tpu_torch.ops.kernels import envelope as tenv
from gie_mapping_tpu_torch.ops.kernels import phase1 as tp1
from gie_mapping_tpu_torch.utils.config import PRESETS
from test_torch_phase1_cases import CASES, OCC, case

NONE = 1 << 29  # kNone of csrc/phase1.cu


def msb(v):
    """Index of the highest set bit of each nonzero uint32 (31 - clz)."""
    out = np.full(v.shape, -1, np.int64)
    for i in range(32):
        out = np.where((v >> np.uint32(i)) & np.uint32(1), i, out)
    return out


def lsb(v):
    """Index of the lowest set bit of each nonzero uint32 (ffs - 1)."""
    out = np.full(v.shape, 32, np.int64)
    for i in range(31, -1, -1):
        out = np.where((v >> np.uint32(i)) & np.uint32(1), i, out)
    return out


# phase1_wave on an H100: 132 SMs, 8 CTAs of the 8-column kernel each
H100_WAVE = 132 * 8


def phase1_bits(types, max_width, tile_z=None):
    """numpy model of the CUDA phase1_packed kernel: int32 [X, Y, Z], with
    `tile_z` z-columns per CTA (by default the wrapper's choice on an
    H100)."""
    X, Y, Z = types.shape
    yb = tp1.phase1_pack_bits(Y)
    if tile_z is None:
        tile_z = tp1.phase1_tile(X, Z, H100_WAVE)
    tz = min(tile_z, 1 << (Z - 1).bit_length())
    W = (Y + 31) >> 5
    occ = types == OCC
    out = np.zeros((X, Y, Z), np.int32)
    ys = np.arange(Y)
    for z0 in range(0, Z, tz):  # the CTAs of a plane; zin masks the tail
        zs = np.arange(z0, z0 + tz)
        zs = zs[zs < Z]
        # occupancy bits: a thread per (word, z), bit i of word w = y 32 w + i
        bits = np.zeros((X, W, len(zs)), np.uint32)
        for w in range(W):
            for i in range(min(32, Y - 32 * w)):
                bits[:, w] |= occ[:, 32 * w + i][:, zs].astype(np.uint32) << np.uint32(i)
        # a thread per column walks the words both ways
        before = np.empty(bits.shape, np.int64)
        after = np.empty(bits.shape, np.int64)
        last = np.full((X, len(zs)), -1, np.int64)
        for w in range(W):
            before[:, w] = last
            last = np.where(bits[:, w] != 0, w * 32 + msb(bits[:, w]), last)
        nxt = np.full((X, len(zs)), NONE, np.int64)
        for w in range(W - 1, -1, -1):
            after[:, w] = nxt
            nxt = np.where(bits[:, w] != 0, w * 32 + lsb(bits[:, w]), nxt)
        # a thread per (y, z)
        w, b = (ys >> 5)[None, :, None], (ys & 31)[None, :, None]
        m = np.take_along_axis(bits, np.broadcast_to(w, (X, Y, len(zs))), 1)
        lo = m & (np.uint32(0xFFFFFFFF) >> (31 - b).astype(np.uint32))
        hi = m >> b.astype(np.uint32)
        y = ys[None, :, None]
        lst = np.where(lo != 0, (w * 32) + msb(lo),
                       np.take_along_axis(before, np.broadcast_to(w, m.shape), 1))
        nx = np.where(hi != 0, y + lsb(hi),
                      np.take_along_axis(after, np.broadcast_to(w, m.shape), 1))
        d_fwd = np.where(lst >= 0, y - lst, max_width)
        d_bwd = np.where(nx < NONE, nx - y, max_width)
        g1 = np.minimum(np.minimum(d_fwd, d_bwd), max_width)
        valid = g1 < max_width
        coc = np.where(d_fwd <= d_bwd, lst, nx)
        out[:, :, zs] = np.where(valid, ((g1 * g1) << (yb + 1)) | (coc << 1) | 1, 0)
    return out


def _plain(t, mw):
    return tp1.phase1_packed_plain(torch.from_numpy(t), mw).numpy()


@pytest.mark.parametrize("name", CASES)
def test_model_matches_plain_every_voxel(name):
    t, mw = case(name)
    np.testing.assert_array_equal(phase1_bits(t, mw), _plain(t, mw))


@pytest.mark.parametrize("tile_z", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", ["Y33", "Y152", "Z3", "Z80", "ties"])
def test_model_matches_plain_at_every_tile_width(name, tile_z):
    t, mw = case(name)
    np.testing.assert_array_equal(phase1_bits(t, mw, tile_z), _plain(t, mw))


@pytest.fixture
def jp1(monkeypatch):
    """The JAX package's phase-1 module, its Pallas call in interpret
    mode."""
    from gie_mapping_tpu.ops.pallas import phase1 as jp1

    orig = jp1.pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(jp1.pl, "pallas_call", patched)
    jp1.phase1_packed_pallas._clear_cache()
    yield jp1
    jp1.phase1_packed_pallas._clear_cache()


@pytest.mark.parametrize("name", ["Y1", "Y2", "Y32", "Y65", "Y1024", "Z1",
                                  "Z80", "narrow", "empty", "full", "ties"])
def test_model_matches_pallas(jp1, name):
    import jax.numpy as jnp

    t, mw = case(name)
    want = np.asarray(jp1.phase1_packed_pallas(
        jnp.asarray((t == OCC).astype(np.int8)), max_width=mw))
    np.testing.assert_array_equal(phase1_bits(t, mw), want)


@pytest.mark.parametrize("o,fx", [(0, 1), (1, 2), (3, 1)])
def test_slab_write_leaves_the_rest(o, fx):
    """An x-slab written in place into a larger buffer (the p1-cache
    patch): the slab equals the same planes of the whole canvas's result,
    and no other word changes."""
    t, mw = case("Z80")
    full = phase1_bits(t, mw)
    buf = torch.full(t.shape, -5, dtype=torch.int32)
    tp1.phase1_packed(torch.from_numpy(t[o:o + fx]), mw, out=buf[o:o + fx])
    np.testing.assert_array_equal(buf[o:o + fx].numpy(), full[o:o + fx])
    np.testing.assert_array_equal(phase1_bits(t[o:o + fx], mw), full[o:o + fx])
    assert (buf[:o] == -5).all() and (buf[o + fx:] == -5).all()


def test_tile_rule():
    """8 z-columns per CTA where that grid fits one wave of the card, else
    16; never wider than Z needs, so small Z reach 1, 2 and 4."""
    assert tp1.phase1_tile(152, 80, H100_WAVE) == 16   # 1,520 CTAs at 8
    for X in (32, 48, 64, 96):                          # the p1-cache patches
        assert tp1.phase1_tile(X, 80, H100_WAVE) == 8
    assert tp1.phase1_tile(128, 56, H100_WAVE) == 8     # 896 CTAs
    assert tp1.phase1_tile(240, 168, H100_WAVE) == 16
    assert tp1.phase1_tile(152, 80, 2 * H100_WAVE) == 8  # a card twice as wide
    assert [tp1.phase1_tile(3, z, H100_WAVE) for z in (1, 2, 3, 5)] == [1, 2, 4, 8]


def test_cases_cover_the_edges():
    """Equal-distance ties resolved to the lower y, voxels past max_width,
    lone sites at both ends, columns without a site and full ones."""
    t, mw = case("ties")
    occ = np.flatnonzero(t[0, :, 0] == OCC)
    assert ((np.arange(64)[:, None] - occ[None]) ** 2).min(1).tolist().count(1) > 1
    out = phase1_bits(t, mw)
    coc = (out[0, :, 0] >> 1) & ((1 << tp1.phase1_pack_bits(64)) - 1)
    assert (coc[1::2][:-1] == np.arange(0, 62, 2)).all()  # the lower site
    t, mw = case("narrow")
    out = phase1_bits(t, mw)
    assert (((out & 1) == 0) & (t == OCC).any(1, keepdims=True)).any()
    t, _ = case("Y152")
    col = t[0]
    assert not (col[:, 0] == OCC).any() and (col[:, 1] == OCC).all()
    assert np.flatnonzero(col[:, 2] == OCC).tolist() == [0]
    assert np.flatnonzero(col[:, 3] == OCC).tolist() == [151]


def test_presets_within_the_kernels_limits():
    """Every preset's canvas (and window, which the relax engine's EDT
    runs on) fits phase 1 (Y <= 1024), the phase-2 kernel (N = X) and the
    phase-3 kernel (N = Z); the gate's slabs are parts of the canvas."""
    for name, make in PRESETS.items():
        cfg = make()
        for X, Y, Z in (cfg.canvas_size, cfg.local_size):
            assert tp1.phase1_fits(Y), (name, Y)
            assert X <= tenv.ENVELOPE_PACKED_MAX_N, (name, X)
            assert Z <= tenv.ENVELOPE_MID_MAX_N, (name, Z)
        assert not kernel_limits(cfg), name
