"""The JAX package's engine and end-to-end scenarios
(tests/test_engine_consistency.py, tests/test_e2e_scan2d.py,
tests/test_fusion_sim.py) on the port.

Each scenario runs on both packages from the same numpy inputs
(tests/test_torch_scenario_cases.py); the port's record is held to the
JAX package's bit for bit (every frame's outputs, the final MapState,
capacity_report(), warning texts), and then the JAX test's own
assertions are applied to the port's results."""
import numpy as np
import pytest
import torch

import test_torch_scenario_cases as sc
from test_torch_scenario_jax import assert_same, both, jax_api
from gie_mapping_tpu_torch.utils.constants import (VOX_FNT, VOX_FREE,
                                                   VOX_OCCUPIED, VOX_UNKNOWN)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tests/test_engine_consistency.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engines_agree_on_first_frame(fast, seed):
    """From an empty map the canvas-EDT and relax engines give the same
    types, and the same distances on observed voxels."""
    outs = {}
    for mode in ("canvas_edt", "relax"):
        _, _, want = sc.engines_first_frame(jax_api(), mode, fast, seed)
        cfg, inst, got = sc.engines_first_frame(sc.port_api("cpu"), mode,
                                                fast, seed)
        assert_same(want, got, f"{mode} fast={fast} seed={seed}")
        outs[mode] = got["frames"][0]
    observed = inst != VOX_UNKNOWN
    a, b = outs["canvas_edt"], outs["relax"]
    np.testing.assert_array_equal(a["glb_type"], b["glb_type"])
    np.testing.assert_array_equal(a["dist_sq"][observed], b["dist_sq"][observed])


def test_dda_mode_through_mapper():
    """raycast_mode='dda' end to end: occupied and free voxels, zero EDT on
    the occupied ones."""
    cfg, m, rec, _ = both(sc.dda_mapper)
    out = rec["frames"][0]
    assert (out["glb_type"] == VOX_OCCUPIED).any()
    assert (out["glb_type"] == VOX_FREE).any()
    assert np.allclose(out["edt"][out["glb_type"] == VOX_OCCUPIED], 0.0)


# ---------------------------------------------------------------------------
# tests/test_e2e_scan2d.py
# ---------------------------------------------------------------------------

def test_scan2d_end_to_end():
    """Four orbit frames: every voxel class present, EDT zero on occupied
    and positive on free voxels, never above the window's brute-force
    distance and equal to it where no outside site can win, no archive
    drop."""
    cfg, m, rec, _ = both(sc.e2e_scan2d, which="run")
    out = rec["frames"][-1]
    X, Y, Z = cfg.local_size
    assert out["edt"].shape == (X, Y, Z) and out["glb_type"].shape == (X, Y, Z)
    types = out["glb_type"]
    assert (types == VOX_FREE).any() and (types == VOX_OCCUPIED).any()
    assert (types == VOX_UNKNOWN).any()
    occ = types == VOX_OCCUPIED
    assert np.allclose(out["edt"][occ], 0.0)
    assert (out["edt"][types == VOX_FREE] > 0).all()
    seen_valid = (out["dist_sq"] < cfg.max_loc_dist_sq) & (types != VOX_UNKNOWN)
    occ_idx, pts = np.argwhere(occ), np.argwhere(seen_valid)
    assert len(occ_idx) and len(pts)
    d2 = ((pts[:, None, :] - occ_idx[None, :, :]) ** 2).sum(-1).min(1)
    got = out["dist_sq"][pts[:, 0], pts[:, 1], pts[:, 2]]
    assert (got <= d2).all()
    size = np.asarray(cfg.local_size)
    bdist = np.minimum(pts + 1, size[None, :] - pts).min(1)
    interior = d2 < bdist ** 2
    assert interior.any()
    np.testing.assert_array_equal(got[interior], d2[interior])
    assert out["arch_dropped"] == 0


def test_scan2d_frontier_marks():
    cfg, m, rec, _ = both(sc.e2e_scan2d, which="frontier")
    out = rec["frames"][0]
    assert out["fnt_count"] > 0
    assert (out["glb_type"] == VOX_FNT).sum() == out["fnt_count"]


def test_incremental_consistency():
    """Re-observing a static world keeps the EDT at its fixed point."""
    cfg, m, rec, _ = both(sc.e2e_scan2d, which="repeat")
    out1, out2 = rec["frames"]
    np.testing.assert_array_equal(out1["glb_type"], out2["glb_type"])
    np.testing.assert_array_equal(out1["dist_sq"], out2["dist_sq"])


# ---------------------------------------------------------------------------
# tests/test_fusion_sim.py
# ---------------------------------------------------------------------------

class DictSim:
    """The occupancy layer's reference semantics (test_fusion_sim.py)."""

    def __init__(self, thresh=180):
        self.occ = {}
        self.thresh = thresh

    def fuse(self, glb, inst):
        old_occ, old_type = self.occ.get(glb, (0, VOX_UNKNOWN))
        if inst == VOX_OCCUPIED:
            val, alpha = 250.0, 0.8
        elif inst == VOX_FREE:
            val, alpha = 0.0, 0.5
        else:
            return
        prev = float(old_occ) if old_type != VOX_UNKNOWN else 0.0
        new = min(max(alpha * val + (1 - alpha) * prev, 1.0), 254.0)
        new_u8 = int(np.uint8(np.float32(new)))
        self.occ[glb] = (new_u8, VOX_OCCUPIED if new_u8 > self.thresh
                         else VOX_FREE)


@pytest.mark.parametrize("n_frames, teleports, seed, stride", [
    (14, (5, 10), 123, 3),
    (100, (25, 50, 75, 90), 321, 4),
], ids=["fuzz", "soak"])
def test_fusion_memory(n_frames, teleports, seed, stride):
    """Random partial observations along a walking pivot with teleports out
    and back: every frame's window types equal the dict simulator's."""
    _, _, want = sc.fusion_fuzz(jax_api(), n_frames, teleports, seed)
    cfg, steps, got = sc.fusion_fuzz(sc.port_api("cpu"), n_frames, teleports,
                                     seed)
    assert_same(want, got, f"fusion {n_frames}")
    X, Y, Z = cfg.local_size
    sim = DictSim(cfg.occupancy_threshold)
    for i, ((inst, pvt), fr) in enumerate(zip(steps, got["frames"])):
        for idx in np.argwhere(inst != VOX_UNKNOWN):
            sim.fuse(tuple(idx + pvt), int(inst[tuple(idx)]))
        g = fr["glb_type"]
        for xi in range(0, X, stride):
            for yi in range(0, Y, stride):
                for zi in range(Z):
                    glb = (xi + pvt[0], yi + pvt[1], zi + pvt[2])
                    want_type = sim.occ.get(glb, (0, VOX_UNKNOWN))[1]
                    t = g[xi, yi, zi]
                    t = VOX_FREE if t == VOX_FNT else t
                    assert t == want_type, (i, glb, t, want_type)
