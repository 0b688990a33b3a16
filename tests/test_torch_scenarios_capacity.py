"""The JAX package's capacity, long-cutoff and state-invariant scenarios
(tests/test_capacity.py, tests/test_long_cutoff.py,
tests/test_state_invariants.py) on the port.

Each scenario runs on both packages from the same numpy inputs
(tests/test_torch_scenario_cases.py); the port's record is held to the
JAX package's bit for bit (every frame's outputs, the final MapState,
capacity_report(), the warnings' classes and texts, the text a strict
mapper raises, the mirror's digest), and then the JAX test's own
assertions are applied to the port's results."""
import warnings

import numpy as np
import pytest
import torch

import test_torch_scenario_cases as sc
from test_torch_scenario_jax import both, jax_api
from gie_mapping_tpu_torch.map_state import MapState, np_unpack_voxels
from gie_mapping_tpu_torch.map_state import stream_extract
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils.constants import (EMPTY_VALUE, VOX_OCCUPIED,
                                                   VOX_UNKNOWN)

COC_INV = 32767


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tests/test_capacity.py
# ---------------------------------------------------------------------------

def test_archive_drop_warns():
    cfg, m, rec, _ = both(sc.archive_drop, mode="warn")
    assert [w[0] for w in rec["warnings"]] == ["CapacityWarning"]
    assert "archive capacity exhausted" in rec["warnings"][0][1]
    assert rec["capacity"]["arch_dropped"] > 0


def test_archive_drop_strict_raises():
    cfg, m, rec, _ = both(sc.archive_drop, mode="strict")
    assert rec["raised"] is not None
    assert "archive capacity exhausted" in rec["raised"]
    assert rec["warnings"] == []


def test_capacity_warn_off_is_silent():
    cfg, m, rec, _ = both(sc.archive_drop, mode="silent")
    assert rec["warnings"] == [] and rec["raised"] is None
    assert rec["capacity"]["arch_dropped"] > 0  # counted, not loud


def test_stream_stall_warns():
    cfg, m, rec, _ = both(sc.stream_stall)
    assert any(c == "CapacityWarning" and "streaming backlog" in t
               for c, t in rec["warnings"])
    assert rec["capacity"]["stream_stall_ticks"] >= 2
    assert rec["mirror"] is not None


def test_stream_rotation_covers_all_columns():
    """Round-robin service: with every column changed on every tick, every
    column is served within ceil(ncols / k) ticks; each tick's ids, valid
    flags, rows and leftover equal the JAX package's."""
    import jax.numpy as jnp

    from gie_mapping_tpu.map_state import MapState as JState
    from gie_mapping_tpu.map_state import stream_extract as jextract

    kw = dict(local_size_m=(6.0, 6.0, 1.2), voxel_width=0.2,
              cutoff_dist=3.0, max_blocks=4096)
    cfg, cfg_j = tcfg.scan2d_config(**kw), jax_api().config.scan2d_config(**kw)
    cb = cfg.canvas_blocks
    ncols = cb[0] * cb[1]
    state, jstate = MapState.create(cfg, device="cpu"), JState.create(cfg_j)
    changed = torch.ones(cb, dtype=torch.bool)
    carry = torch.zeros(cb, dtype=torch.bool)
    k = 8
    seen = set()
    for t in range(-(-ncols // k)):
        got = stream_extract(state, changed, carry, (t * k) % ncols, cfg=cfg,
                             k_cols=k)
        want = jextract(jstate, jnp.ones(cb, bool), jnp.zeros(cb, bool),
                        jnp.int32((t * k) % ncols), cfg=cfg_j, k_cols=k)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = sc.np_of(g), np.asarray(w)
            if g.dtype != w.dtype and g.dtype.itemsize == w.dtype.itemsize:
                g = g.view(w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"tick {t} item {i}")
        ids, valid = sc.np_of(got[0]), sc.np_of(got[1])
        seen |= set(ids[valid].tolist())
    assert seen == set(range(ncols))


def test_relax_cap_warns():
    cfg, m, rec, _ = both(sc.relax_cap)
    assert any(c == "CapacityWarning" and "sweep cap" in t
               for c, t in rec["warnings"])
    assert rec["frames"][0]["relax_iters"] >= cfg.relax_iters


def test_csv_capacity_columns():
    """The CSV log's capacity columns, as the JAX package writes them."""
    from gie_mapping_tpu.runtime.logger import CsvLogger as JLogger
    from gie_mapping_tpu_torch.runtime.logger import CsvLogger

    logs = []
    for cls in (CsvLogger, JLogger):
        log = cls()
        log.log_frame(1.0, 2.0, -1.0, arch_dropped=3, stream_leftover=7)
        logs.append(log.getvalue())
    assert logs[0] == logs[1]
    lines = logs[0].strip().splitlines()
    assert lines[0].endswith("arch dropped,stream leftover")
    assert lines[1].endswith(",3,7")


# ---------------------------------------------------------------------------
# tests/test_long_cutoff.py
# ---------------------------------------------------------------------------

def _warned(make):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        make()
    return [(w.category.__name__, str(w.message)) for w in caught
            if w.category.__name__ == "CutoffNarrowedWarning"]


def test_cutoff_narrowing_warns():
    """A non-fast config whose cutoff passes the halo bound warns
    CutoffNarrowedWarning with the JAX package's text; at or under it, or
    in fast_mode, nothing warns."""
    jc = jax_api().config
    narrowed = dict(voxel_width=0.05, cutoff_dist=100.0, fast_mode=False,
                    local_size_m=(10.0, 10.0, 1.2))
    got = _warned(lambda: tcfg.MapConfig(**narrowed))
    assert got == _warned(lambda: jc.MapConfig(**narrowed))
    assert len(got) == 1 and "narrowed" in got[0][1]
    for kw in (dict(voxel_width=0.1, cutoff_dist=6.0, fast_mode=False),
               dict(voxel_width=0.05, cutoff_dist=100.0, fast_mode=True)):
        assert _warned(lambda: tcfg.MapConfig(**kw)) == []
        assert _warned(lambda: jc.MapConfig(**kw)) == []


def test_shipped_presets_do_not_warn():
    assert sorted(tcfg.PRESETS) == sorted(jax_api().config.PRESETS)
    for name, make in tcfg.PRESETS.items():
        assert _warned(make) == [], name


@pytest.mark.parametrize("merge_mode", ["canvas_edt", "relax"])
def test_fastmode_out_of_window_voxel_keeps_stale(merge_mode):
    """With fast_mode the voxel that left the window keeps its distance to
    the obstacle that disappeared (the reference's window-bounded wave)."""
    cfg, state, rec, _ = both(sc.fastmode_stale, merge_mode=merge_mode)
    X, Y, Z = cfg.local_size
    assert rec["frames"][0]["dist_sq"][2, Y // 2, Z // 2] == 144
    s = rec["state"]
    origin = s["origin_blk"].astype(np.int64) * 8
    vc = np.asarray([2, Y // 2, Z // 2]) - origin
    assert s["dist_sq"][vc[0], vc[1], vc[2]] == 144
    np.testing.assert_array_equal(s["coc"][vc[0], vc[1], vc[2]] + origin,
                                  [14, Y // 2, Z // 2])


def test_archived_block_stale_until_reentry():
    """A voxel archived while its obstacle disappears keeps the stale pair in
    the archive and refreshes on re-entry beside a new obstacle."""
    cfg, state, rec, _ = both(sc.archived_stale)
    X, Y, Z = cfg.local_size
    assert cfg.halo_grids == 8 and cfg.canvas_size[0] == 48
    ym, zm = Y // 2, Z // 2
    assert rec["frames"][1]["dist_sq"][2, ym, zm] == 28 ** 2
    s = rec["states"][2]  # v's block archived, O observed free
    n = int(s["n_arch"])
    slot = next(i for i in range(n) if (s["arch_keys"][i] == [1, 1, 0]).all())
    occ, typ, dist, coc = np_unpack_voxels(
        s["a_packed"][slot].view(np.uint32).reshape(512, 3))
    vi = 2 * 64 + (ym - 8) * 8 + zm
    assert dist[vi] == 28 ** 2
    np.testing.assert_array_equal(coc[vi] + [8, 8, 0], [38, ym, zm])
    out4 = rec["frames"][3]
    assert out4["dist_sq"][2, ym, zm] == 100
    np.testing.assert_array_equal(out4["coc"][2, ym, zm], [20, ym, zm])


# ---------------------------------------------------------------------------
# tests/test_state_invariants.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
def test_committed_state_invariants(fast):
    """After six orbit frames: every valid stored pair is self-consistent
    (I1), in-canvas cocs point at occupied voxels (I2), and no occupied
    canvas voxel is closer than the stored distance (I3)."""
    cfg, m, rec, _ = both(sc.invariants, fast=fast)
    s = rec["state"]
    vox_type, dist = s["vox_type"], s["dist_sq"]
    coc = s["coc"].astype(np.int64)
    origin = s["origin_blk"].astype(np.int64) * 8
    cs = np.asarray(cfg.canvas_size)
    valid = (vox_type != VOX_UNKNOWN) & (dist != EMPTY_VALUE) \
        & (coc[..., 0] != COC_INV)
    if fast:
        off = rec["frames"][-1]["pvt"] - origin
        wmask = np.zeros_like(valid)
        X, Y, Z = cfg.local_size
        wmask[off[0]:off[0] + X, off[1]:off[1] + Y, off[2]:off[2] + Z] = True
        valid &= wmask
    idx = np.argwhere(valid)
    assert len(idx) > (400 if fast else 1000)
    vg = idx + origin
    cg = coc[valid] + origin
    np.testing.assert_array_equal(((vg - cg) ** 2).sum(-1), dist[valid])
    crel = cg - origin
    cin = crel[((crel >= 0) & (crel < cs)).all(-1)]
    assert (vox_type[cin[:, 0], cin[:, 1], cin[:, 2]] == VOX_OCCUPIED).all()
    occ_idx = np.argwhere(vox_type == VOX_OCCUPIED)
    assert len(occ_idx)
    sub = idx[:: max(1, len(idx) // 500)]
    best = ((sub[:, None, :] - occ_idx[None, :, :]) ** 2).sum(-1).min(1)
    assert (dist[sub[:, 0], sub[:, 1], sub[:, 2]] <= best).all()
