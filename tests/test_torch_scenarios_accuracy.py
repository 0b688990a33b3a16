"""The JAX package's accuracy scenarios (tests/test_incremental_horizon.py,
tests/test_gt_global.py) on the port.

Each scenario runs on both packages from the same numpy inputs
(tests/test_torch_scenario_cases.py); the port's record is held to the
JAX package's bit for bit (every frame's outputs, the final MapState,
capacity_report(), warning texts, the mirror's digest, the RMS checks'
results), and then the JAX test's own assertions are applied to the
port's results."""
import numpy as np
import pytest
import torch

import test_torch_scenario_cases as sc
from test_torch_scenario_jax import both
from gie_mapping_tpu_torch.runtime.gt_checker import knn_errors
from gie_mapping_tpu_torch.utils.constants import EMPTY_VALUE, VOX_UNKNOWN


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tests/test_incremental_horizon.py
# ---------------------------------------------------------------------------

def _check_frame(tag, cfg, out_c, out_r, occ):
    """The JAX test's per-frame contract: the engines observe alike and
    agree within one voxel; both are within one voxel of the exact 1-NN
    over the believed-occupied set, and their KNN RMSE is under a voxel."""
    vw = cfg.voxel_width
    d_c, d_r = out_c["dist_sq"], out_r["dist_sq"]
    seen_c = out_c["glb_type"] != VOX_UNKNOWN
    seen_r = out_r["glb_type"] != VOX_UNKNOWN
    v_c = (d_c < EMPTY_VALUE) & seen_c
    v_r = (d_r < EMPTY_VALUE) & seen_r
    np.testing.assert_array_equal(seen_c, seen_r, err_msg=tag)
    assert int(np.sum(v_c != v_r)) == 0, tag
    both_v = v_c & v_r
    gap = np.abs(np.sqrt(d_c[both_v].astype(float))
                 - np.sqrt(d_r[both_v].astype(float)))
    assert gap.max(initial=0.0) <= 1.0, (tag, gap.max())
    assert len(occ)
    for name, dd, vv, out in (("canvas", d_c, v_c, out_c),
                              ("relax", d_r, v_r, out_r)):
        q = np.argwhere(vv)
        vg = q + out["pvt"]
        sub = slice(None, None, max(1, len(q) // 800))
        d2 = ((vg[sub][:, None, :] - occ[None, :, :]) ** 2).sum(-1).min(1)
        gap = np.abs(np.sqrt(dd[vv][sub].astype(float)) - np.sqrt(d2))
        assert gap.max(initial=0.0) <= 1.0, (tag, name, gap.max())
        rmse, mx, _ = knn_errors(occ * vw, vg[sub] * vw,
                                 np.sqrt(dd[vv][sub].astype(float)) * vw)
        assert rmse <= vw, (tag, name, rmse)


def test_adversarial_horizon_engines_and_oracle():
    """11 frames: orbit, a world change (a pillar gone, a box new), a walk
    that scrolls, a teleport 30 m out and back, on both engines; the
    believed-occupied set of the canvas engine after every frame is the
    JAX package's too."""
    def believed(m, out):
        return sc.believed_occupied(m.state, m.cfg)

    cfg, m_c, rec_c, _ = both(sc.horizon, merge_mode="canvas_edt",
                              on_frame=believed)
    _, m_r, rec_r, _ = both(sc.horizon, merge_mode="relax")
    for i, (fc, fr, occ) in enumerate(zip(rec_c["frames"], rec_r["frames"],
                                          rec_c["extra"])):
        _check_frame(f"frame {i}", cfg, fc, fr, occ)
    assert rec_c["capacity"]["arch_dropped"] == 0
    assert rec_r["capacity"]["arch_dropped"] == 0
    assert rec_c["capacity"]["n_arch"] > 0  # the teleport archived


# ---------------------------------------------------------------------------
# tests/test_gt_global.py
# ---------------------------------------------------------------------------

def test_global_rms_routes_to_mirror():
    """profile_glb_rms checks the mirror (its own slot, not the window
    check's) and the CSV gets the global RMSE column."""
    cfg, m, rec, _ = both(sc.gt_global)
    assert m.gt_checker.last_global is not None
    assert m.gt_checker.last is None
    assert m.gt_checker.last_global[0] >= 0
    assert any(float(row[0]) >= 0 for row in rec["csv"][1:])


def test_global_rms_flags_corrupted_stream():
    """Corrupting one streamed block moves the global check's max error by
    the injected magnitude, on both packages alike."""
    cfg, m, rec, jm = both(sc.gt_global)
    checks = []
    for mapper in (m, jm):
        base = mapper.gt_checker.check_global(mapper.mirror, cfg.voxel_width)
        for key in sorted(mapper.mirror.blocks):
            blk = mapper.mirror.blocks[key]
            valid = blk["dist_sq"] < EMPTY_VALUE
            if valid.sum() > 10:
                blk["dist_sq"] = np.where(valid, blk["dist_sq"] + 40 ** 2,
                                          blk["dist_sq"])
                break
        else:  # pragma: no cover
            raise AssertionError("no streamed block with valid EDT values")
        checks.append((base, mapper.gt_checker.check_global(
            mapper.mirror, cfg.voxel_width)))
    assert checks[0] == checks[1]
    (base_rmse, base_mx, _), (rmse2, mx2, _) = checks[0]
    assert mx2 > base_mx + 1.0, (base_mx, mx2)
    assert rmse2 > base_rmse


def test_loc_and_glb_rms_both_run():
    cfg, m, rec, _ = both(sc.gt_global, profile_loc_rms=True)
    assert m.gt_checker.last is not None
    assert m.gt_checker.last_global is not None
