"""The PyTorch port's canvas scroll and changed-block streaming against the
JAX package, bit for bit: the plain versions of the five scroll kernels
against the JAX Pallas kernels (interpret mode), `_do_scroll` on populated
random states, and VolumetricMapper with streaming on over a trajectory that
scrolls in x, in z and by teleport, down to the host mirror."""
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu import map_state as jms
from gie_mapping_tpu.models.mapper import CapacityWarning as JaxCapacityWarning
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.ops.pallas import blockrows as jbr
from gie_mapping_tpu.runtime.host_mirror import HostMirror as JaxHostMirror
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch import map_state as tms
from gie_mapping_tpu_torch.map_state import (FIELDS, state_from_numpy,
                                             state_to_numpy)
from gie_mapping_tpu_torch.models.mapper import CapacityWarning
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.models.pipeline import _slab_menu
from gie_mapping_tpu_torch.ops.kernels import blockrows as kbr
from gie_mapping_tpu_torch.ops.kernels import shift as ksh
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld, scroll_trajectory
from gie_mapping_tpu_torch.runtime.host_mirror import HostMirror, mirror_digest
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo


@pytest.fixture
def interp(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (on the CPU),
    as tests/test_scroll_pallas.py does."""
    orig = jbr.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jbr.pl, "pallas_call", patched)
    fns = (jbr.gather_block_rows, jbr.scatter_block_rows,
           jbr.gather_archive_rows, jbr.scatter_archive_rows,
           jbr.shift_canvas_pallas)
    for f in fns:
        f._clear_cache()
    yield
    for f in fns:
        f._clear_cache()


def _t(a):
    """numpy uint32 -> torch int32 with the same bits (and other arrays as
    they are)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u(t):
    return t.numpy().view(np.uint32)


def _words(rng, shape, sentinel_frac=0.1):
    """Random packed words whose 16-bit halves include the 0x7FFF sentinel
    and 'negative' (>= 0x8000) cocs."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    lo_s = rng.random(shape) < sentinel_frac
    hi_s = rng.random(shape) < sentinel_frac
    w = np.where(lo_s, (w & 0xFFFF0000) | 0x7FFF, w)
    return np.where(hi_s, (w & 0xFFFF) | (0x7FFF << 16), w).astype(np.uint32)


# ---------------------------------------------------------------------------
# the five plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------

def _jax_shift(cv, defaults, shift):
    """The JAX package's shift dispatch (map_state._do_scroll :445-484): the
    static z arm for |zb| <= 2, else the composed xy pass + lane roll."""
    X, Y, L = cv.shape
    s = jnp.asarray(shift, jnp.int32)
    zb = int(shift[2])
    if abs(zb) <= min(2, L // 24 - 1):
        return jbr.shift_canvas_pallas(cv, defaults, s, zshift_blk=zb,
                                       reanchor_blk=s)
    shifted = jbr.shift_canvas_pallas(cv, defaults, s.at[2].set(0),
                                      zshift_blk=0, reanchor_blk=s)
    zl = zb * 24
    rolled = jnp.roll(shifted, -zl, axis=2)
    lane = jnp.arange(L)
    ok = (lane + zl >= 0) & (lane + zl < L)
    return jnp.where(ok[None, None, :], rolled, defaults)


SHIFTS = [(1, 0, 0), (-1, 0, 0), (1, -1, 0), (0, 0, 1), (0, 0, -1),
          (0, 0, 3), (0, 0, -3), (0, 0, 12), (0, 0, -12), (20, 0, 0),
          (-20, 0, 0)]


@pytest.mark.parametrize("shift", SHIFTS, ids=str)
def test_shift_canvas_plain_matches_pallas(interp, shift):
    rng = np.random.default_rng(abs(hash(shift)) % 1000)
    X, Y, Z = 24, 16, 32  # 3 x 2 x 4 blocks: |z| = 3 takes the composed arm
    cv = _words(rng, (X, Y, 3 * Z))
    defaults = np.tile(tms._PACKED_DEFAULT, Z)
    want = np.asarray(_jax_shift(jnp.asarray(cv), jnp.asarray(defaults)
                                 .reshape(1, 1, -1), shift))
    got = ksh.shift_canvas(_t(cv), _t(defaults), shift)
    np.testing.assert_array_equal(_u(got), want)


CB = (3, 2, 4)  # canvas blocks of the row-kernel tests


def _canvas(rng):
    return _words(rng, (CB[0] * 8, CB[1] * 8, CB[2] * 8, 3))


@pytest.mark.parametrize("col_ids", [[0, 5, 5, 2, 0], [3], [1, 1, 1, 1]],
                         ids=["repeats", "one", "all-same"])
def test_gather_block_rows_plain_matches_pallas(interp, col_ids):
    packed = _canvas(np.random.default_rng(1))
    ids = np.asarray(col_ids, np.int32)
    want = np.asarray(jbr.gather_block_rows(jnp.asarray(packed),
                                            jnp.asarray(ids), CB))
    got = kbr.gather_block_rows(_t(packed), _t(ids), CB)
    np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("case", ["partial", "all-invalid"])
def test_scatter_block_rows_plain_matches_pallas(interp, case):
    rng = np.random.default_rng(2)
    packed = _canvas(rng)
    # unique valid target columns; all-invalid entries repeat one parking
    # column that no valid entry targets (the JAX kernel's contract)
    ids = np.asarray([4, 1, 3, 3, 3], np.int32)
    valid = (rng.random(5 * CB[2]) < 0.6).astype(np.int32)
    valid[2 * CB[2]:] = 0
    if case == "all-invalid":
        valid[:] = 0
    rows = _words(rng, (5 * CB[2], 512, 3))
    want = np.asarray(jbr.scatter_block_rows(
        jnp.asarray(packed), jnp.asarray(rows), jnp.asarray(ids),
        jnp.asarray(valid), CB))
    got = kbr.scatter_block_rows(_t(packed), _t(rows), _t(ids), _t(valid), CB)
    np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("case", ["partial", "all-invalid"])
def test_archive_rows_plain_match_pallas(interp, case):
    rng = np.random.default_rng(3)
    B = 12
    arch = _words(rng, (B, 1536))
    ids = np.asarray([7, 0, 7, 11, 2, 2], np.int32)
    want = np.asarray(jbr.gather_archive_rows(jnp.asarray(arch), jnp.asarray(ids)))
    np.testing.assert_array_equal(_u(kbr.gather_archive_rows(_t(arch), _t(ids))),
                                  want)
    # scatter: unique valid targets, invalid entries anywhere (repeated)
    sids = np.asarray([5, 0, 5, 9, 5, 3], np.int32)
    valid = np.asarray([1, 1, 0, 1, 0, 0] if case == "partial" else [0] * 6,
                       np.int32)
    rows = _words(rng, (6, 512, 3))
    want = np.asarray(jbr.scatter_archive_rows(
        jnp.asarray(arch), jnp.asarray(rows), jnp.asarray(sids),
        jnp.asarray(valid)))
    got = kbr.scatter_archive_rows(_t(arch), _t(rows), _t(sids), _t(valid))
    np.testing.assert_array_equal(_u(got), want)


# ---------------------------------------------------------------------------
# _do_scroll against the JAX package on populated random states
# ---------------------------------------------------------------------------

def _scroll_cfg(pkg, max_blocks=4096):
    return pkg.scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2,
                             max_blocks=max_blocks)


def _rand_state(cfg, rng, n_arch):
    """Populated random state as numpy arrays (JAX dtypes): unique archive
    keys around the canvas, random canvas payload with whole-coc sentinels,
    about 70 % of the blocks present."""
    cs, cb = cfg.canvas_size, cfg.canvas_blocks
    st = {f.name: np.array(getattr(jms.MapState.create(cfg), f.name))
          for f in dataclasses.fields(jms.MapState)}
    n_arch = min(n_arch, cfg.max_blocks)
    flat = rng.choice(9 * 9 * 9, n_arch, replace=False)
    st["arch_keys"][:n_arch] = np.stack(np.unravel_index(flat, (9, 9, 9)), -1) - 3
    st["a_packed"][:n_arch] = rng.integers(0, 1 << 20, (n_arch, 1536),
                                           dtype=np.uint32)
    st["n_arch"] = np.int32(n_arch)
    st["occ_val"] = rng.integers(0, 255, cs, dtype=np.uint8)
    st["vox_type"] = rng.integers(0, 4, cs).astype(np.int8)
    st["dist_sq"] = rng.integers(0, 900, cs).astype(np.int32)
    coc = rng.integers(-100, 100, cs + (3,)).astype(np.int16)
    coc[rng.random(cs) < 0.2] = jms.COC_INVALID16
    st["coc"] = coc
    st["present"] = rng.random(cb) < 0.7
    st["dmax_cell"] = rng.integers(-1, 900, st["dmax_cell"].shape).astype(np.int32)
    st["p1c_ok"] = np.bool_(True)
    return st


# one compiled program per config serves every shift (the origin is traced)
_jax_do_scroll = jax.jit(jms._do_scroll, static_argnums=(2,))


def _cols(cfg, new, old):
    m = types.SimpleNamespace(cfg=cfg)
    return TorchMapper._scroll_compact_cols(m, new, old)


def _assert_states(js, tst, msg):
    tn = state_to_numpy(tst)
    for k in FIELDS:
        np.testing.assert_array_equal(tn[k], np.asarray(getattr(js, k)),
                                      err_msg=f"{msg}: {k}")


ORIGINS = {
    "x+1": [(1, 0, 0)], "x-1": [(-1, 0, 0)], "y+1": [(0, 1, 0)],
    "diagonal": [(1, -1, 0)], "z": [(0, 0, 1), (0, 0, -2)],
    "teleport": [(20, 0, 0)],
    "leave-and-return": [(2, 1, 0), (0, 0, 0)],
    "rearchive": [(7, 0, 0), (0, 0, 0), "mutate", (7, 0, 0), (0, 0, 0)],
    "overflow": [(1, 1, 0), (-1, 0, 1)],
}


@pytest.mark.parametrize("case", sorted(ORIGINS))
def test_do_scroll_matches_jax(case):
    max_blocks = 48 if case == "overflow" else 4096
    jc, tc = _scroll_cfg(jcfg, max_blocks), _scroll_cfg(tcfg, max_blocks)
    rng = np.random.default_rng(sorted(ORIGINS).index(case))
    st = _rand_state(jc, rng, n_arch=40)
    js = jms.MapState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = state_from_numpy(st, device="cpu")
    old = np.zeros(3, np.int32)
    n_arch = []
    for step in ORIGINS[case]:
        if step == "mutate":  # change a block that is back from the archive
            vox = tuple(int(v) * 8 + 1 for v in np.argwhere(ts.present.numpy())[0])
            js.occ_val = js.occ_val.at[vox].set(42)
            ts.occ_val[vox] = 42
            continue
        new = np.asarray(step, np.int32)
        js = _jax_do_scroll(js, jnp.asarray(new), jc)
        ts = tms._do_scroll(ts, new, tc, compact_cols=_cols(tc, new, old),
                            old_origin_blk=old)
        _assert_states(js, ts, f"{case} -> {step}")
        n_arch.append(int(ts.n_arch))
        old = new
    if case == "overflow":
        assert int(ts.arch_dropped) > 0
    if case == "rearchive":  # the second visit reuses the same slots
        assert n_arch[0] == n_arch[2] and int(ts.occ_val[vox]) == 42


def test_stream_extract_matches_jax():
    """Changed blocks and a carry over the column cap, at two rotations."""
    jc = jcfg.cow_lady_config(local_size_m=(4.0, 4.0, 1.6))
    tc = tcfg.cow_lady_config(local_size_m=(4.0, 4.0, 1.6))
    rng = np.random.default_rng(5)
    st = _rand_state(jc, rng, n_arch=0)
    js = jms.MapState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = state_from_numpy(st, device="cpu")
    cb = jc.canvas_blocks
    changed = rng.random(cb) < 0.3
    carry = rng.random(cb) < 0.1
    for rot in (0, 37):
        want = jms.stream_extract(js, jnp.asarray(changed), jnp.asarray(carry),
                                  jnp.int32(rot), cfg=jc, k_cols=24,
                                  use_pallas=False)
        got = tms.stream_extract(ts, torch.from_numpy(changed),
                                 torch.from_numpy(carry), rot, cfg=tc,
                                 k_cols=24)
        for name, a, b in zip(("ids", "valid", "rows", "blk_mask", "leftover"),
                              got, want):
            a = a.numpy()
            np.testing.assert_array_equal(a.view(np.uint32) if name == "rows" else a,
                                          np.asarray(b), err_msg=name)


# ---------------------------------------------------------------------------
# the mapper, streaming on, over a scrolling trajectory
# ---------------------------------------------------------------------------

# cow-lady at a small window, streaming on at 16 block-columns per tick (of
# 144), so the carry and the rotation are exercised
STREAM = dict(local_size_m=(4.0, 4.0, 1.6), max_raycast_points=4096,
              edt_gate_min_vox=0, display_glb_edt=True, display_glb_ogm=True,
              stream_k_cols=16)
OUTPUTS = ("edt", "glb_type", "dist_sq", "coc", "gate_level", "gate_slab_vox",
           "fnt_count", "arch_dropped")
WORLD = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
POSES = scroll_trajectory(n_yaw=2, step_x=0.5, n_out=3, dz=1.0, n_back=2,
                          teleport_x=12.0, n_after=0)


def _frame(jm, tm, i, pose):
    jp = jgeo.Projection.from_pose(*pose)
    pts = WORLD.pointcloud(jp, n_rays=4096, max_range=8.0, seed=i)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jo = jm.process_pointcloud(jp, pts).fetch()
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        to = tm.process_pointcloud(tgeo.Projection.from_pose(*pose), pts)
    jcw = [w for w in jw if issubclass(w.category, JaxCapacityWarning)]
    tcw = [w for w in tw if issubclass(w.category, CapacityWarning)]
    return jo, to, len(jcw), len(tcw)


def _assert_frame(jm, tm, jo, to, i):
    _assert_states(jm.state, tm.state, f"frame {i}")
    for k in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(to, k)),
                                      np.asarray(getattr(jo, k)),
                                      err_msg=f"frame {i} output {k}")
    for k in ("changed_blk", "ogm_changed"):
        np.testing.assert_array_equal(getattr(to, k), np.asarray(jo.device(k)),
                                      err_msg=f"frame {i} {k}")
    np.testing.assert_array_equal(tm._origin, jm._origin)


def _assert_stream(jm, tm, i):
    """The in-flight tick: stream_extract's outputs and the leftover count."""
    jids, jvalid, jrows, jmask, jorigin, jlo = jm._stream_pending
    (ids, valid, rows, mask, lo), _, origin = tm._stream_pending
    for name, a, b in (("ids", ids, jids), ("valid", valid, jvalid),
                       ("blk_mask", mask, jmask), ("leftover", lo, jlo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"frame {i} stream {name}")
    np.testing.assert_array_equal(_u(rows), np.asarray(jrows),
                                  err_msg=f"frame {i} stream rows")
    np.testing.assert_array_equal(origin, jorigin)
    np.testing.assert_array_equal(tm._stream_carry.numpy(),
                                  np.asarray(jm._stream_carry))
    assert tm._stream_rot == jm._stream_rot


def _assert_mirrors(jmir, tmir):
    assert list(tmir.blocks) == list(jmir.blocks)
    for key, blk in jmir.blocks.items():
        for name, want in blk.items():
            got = tmir.blocks[key][name]
            assert got.dtype == want.dtype, (key, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{key} {name}")
    assert mirror_digest(tmir.blocks) == mirror_digest(jmir.blocks)
    np.testing.assert_array_equal(tmir.occupied_cloud(0.1), jmir.occupied_cloud(0.1))
    for z in (None, 12):
        for a, b in zip(tmir.edt_cloud(0.1, z), jmir.edt_cloud(0.1, z)):
            np.testing.assert_array_equal(a, b)


def test_mapper_streaming_scroll_bitwise():
    jm = JaxMapper(jcfg.cow_lady_config(**STREAM))
    tm = TorchMapper(tcfg.cow_lady_config(**STREAM), device="cpu")
    shifts, leftovers, levels = [], [], []
    for i, pose in enumerate(POSES):
        before = tm._origin
        jo, to, jw, tw = _frame(jm, tm, i, pose)
        _assert_frame(jm, tm, jo, to, i)
        _assert_stream(jm, tm, i)
        assert jw == tw == 0, f"frame {i}: capacity warnings {jw} / {tw}"
        if before is not None and not np.array_equal(before, tm._origin):
            shifts.append(tm._origin - before)
        leftovers.append(int(tm._stream_pending[0][4]))
        levels.append(to.gate_level)
    # the trajectory scrolls in x both ways, in z and by teleport
    sh = np.asarray(shifts)
    assert (sh[:, 0] > 0).any() and (sh[:, 0] < 0).any() and (sh[:, 2] != 0).any()
    assert (np.abs(sh) >= np.asarray(tm.cfg.canvas_blocks)).any()
    assert max(leftovers) > 0
    n_menu = len(_slab_menu(tm.cfg.canvas_size))
    assert min(levels) < n_menu <= max(levels), levels
    assert jm.flush_stream() == tm.flush_stream() > 0
    jm.check_capacity()
    tm.check_capacity()
    assert tm.capacity_report() == jm.capacity_report()
    assert tm.capacity_report()["n_arch"] > 0
    _assert_mirrors(jm.mirror, tm.mirror)
    # the archive on top: every scrolled-out block as the archive holds it
    assert jm.mirror.ingest_archive(jm.state) == tm.mirror.ingest_archive(tm.state)
    _assert_mirrors(jm.mirror, tm.mirror)
    # the synchronous pull of every present canvas block into fresh mirrors
    jmir, tmir = JaxHostMirror(jm.cfg), HostMirror(tm.cfg)
    assert jmir.ingest(np.asarray(jm.state.present), jm._origin, jm.state) \
        == tmir.ingest(tm.state.present, tm._origin, tm.state) > 0
    _assert_mirrors(jmir, tmir)


def test_mapper_archive_overflow_warns_on_the_same_frame():
    kw = dict(STREAM, max_blocks=24)
    jm = JaxMapper(jcfg.cow_lady_config(**kw))
    tm = TorchMapper(tcfg.cow_lady_config(**kw), device="cpu")
    # a teleport on frame 1 archives every present block; frame 2 reports
    p0 = POSES[0]
    poses = [p0, (p0[0] + np.float32([12.0, 0, 0]), p0[1]),
             (p0[0] + np.float32([12.1, 0, 0]), p0[1])]
    warned = []
    for i, pose in enumerate(poses):
        jo, to, jw, tw = _frame(jm, tm, i, pose)
        _assert_frame(jm, tm, jo, to, i)
        assert jw == tw, f"frame {i}: {jw} JAX warnings, {tw} port warnings"
        warned.append(tw)
    assert warned == [0, 0, 1]
    assert tm.capacity_report() == jm.capacity_report()
    assert tm.capacity_report()["arch_dropped"] > 0
