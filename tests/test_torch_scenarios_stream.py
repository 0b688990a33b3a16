"""The JAX package's streamed-map scenarios (tests/test_global_accuracy.py,
tests/test_stream_soak.py) on the port.

Each scenario runs on both packages from the same numpy inputs
(tests/test_torch_scenario_cases.py); the port's record is held to the
JAX package's bit for bit (every frame's outputs, the final MapState,
capacity_report(), warning texts, the streaming leftovers, the mirror's
digest), and then the JAX test's own assertions are applied to the
port's results."""
import numpy as np
import pytest
import torch

import test_torch_scenario_cases as sc
from test_torch_scenario_jax import both
from gie_mapping_tpu_torch.runtime.gt_checker import knn_errors
from gie_mapping_tpu_torch.utils.constants import VB_WIDTH


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tests/test_global_accuracy.py
# ---------------------------------------------------------------------------

def test_global_edt_matches_global_knn():
    """The streamed global EDT against the exact 1-NN over the mirror's
    occupied cloud: a small RMSE tail, the bulk exact."""
    cfg, m, rec, _ = both(sc.global_accuracy)
    occ = m.mirror.occupied_cloud(cfg.voxel_width)
    pos, dist = m.mirror.edt_cloud(cfg.voxel_width)
    assert len(occ) > 10 and len(pos) > 100
    rmse, mx, mean_abs = knn_errors(occ, pos, dist)
    assert rmse < 2.5 * cfg.voxel_width, (rmse, mx)
    assert mean_abs < 0.5 * cfg.voxel_width, (mean_abs, mx)


# ---------------------------------------------------------------------------
# tests/test_stream_soak.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate", [False, True])
def test_stream_soak_mirror_converges(gate):
    """130 frames of a random walk with two teleports, 4 columns a tick:
    the backlog stays bounded and drains, no CapacityWarning fires, every
    mirror block still in the canvas equals the state, and every present
    block that ever changed is mirrored."""
    cfg, m, rec, _ = both(sc.soak, gate=gate)
    cb = np.asarray(cfg.canvas_blocks)
    ncols = int(cb[0] * cb[1])
    assert rec["warnings"] == []
    assert max(rec["leftover"]) <= ncols
    assert max(rec["leftover"]) > 0
    assert m._last_leftover == 0, "backlog failed to drain"

    ever_changed = set()
    for fr, origin in zip(rec["frames"], rec["origins"]):
        for b in np.argwhere(fr["changed_blk"]):
            ever_changed.add(tuple(int(v) for v in b + origin))
    st = rec["state"]
    origin = np.asarray(rec["origins"][-1])
    present = st["present"]
    checked = 0
    for key, blk in m.mirror.blocks.items():
        rel = np.asarray(key) - origin
        if not ((rel >= 0).all() and (rel < cb).all()) or not present[tuple(rel)]:
            continue
        sl = tuple(slice(r * VB_WIDTH, (r + 1) * VB_WIDTH) for r in rel)
        for name in ("occ_val", "vox_type", "dist_sq"):
            np.testing.assert_array_equal(blk[name], st[name][sl],
                                          err_msg=f"{key} {name}")
        rel_coc = st["coc"][sl]
        valid = rel_coc[..., :1] != 32767
        want = np.where(valid, rel_coc.astype(np.int32) + origin * VB_WIDTH,
                        np.int32(32767))
        np.testing.assert_array_equal(blk["coc"], want, err_msg=str(key))
        checked += 1
    assert checked >= 8, checked
    for key in ever_changed:
        rel = np.asarray(key) - origin
        if (rel >= 0).all() and (rel < cb).all() and present[tuple(rel)]:
            assert key in m.mirror.blocks, key
