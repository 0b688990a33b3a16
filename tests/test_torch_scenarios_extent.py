"""The JAX package's world-extent and edge-case scenarios
(tests/test_world_extent.py, tests/test_edge_cases.py) on the port.

Each test runs the scenario on both packages from the same numpy inputs
(tests/test_torch_scenario_cases.py), holds the port's record to the JAX
package's bit for bit (every frame's outputs, the final MapState,
capacity_report(), warning texts, the mirror's digest) and then applies
the JAX test's own assertions to the port's results."""
import numpy as np
import pytest
import torch

import test_torch_scenario_cases as sc
from test_torch_scenario_jax import both
from gie_mapping_tpu_torch.map_state import canvas_geometry
from gie_mapping_tpu_torch.models.mapper import FrameOutput
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
from gie_mapping_tpu_torch.utils.constants import (EMPTY_VALUE, VOX_FREE,
                                                   VOX_OCCUPIED, VOX_UNKNOWN)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_window_exact(cfg, out):
    """test_world_extent.py's window-exactness contract on a port output."""
    types = out.glb_type
    occ_idx = np.argwhere(types == VOX_OCCUPIED)
    assert len(occ_idx) > 10
    coc_loc = out.coc.astype(np.int64) - out.pvt
    in_win = ((coc_loc >= 0) & (coc_loc < np.asarray(cfg.local_size))).all(-1)
    sel = (types != VOX_UNKNOWN) & (out.dist_sq < EMPTY_VALUE) & in_win
    q_idx = np.argwhere(sel)
    assert len(q_idx) > 100
    sub = q_idx[:: max(1, len(q_idx) // 400)]
    best = ((sub[:, None, :] - occ_idx[None, :, :]) ** 2).sum(-1).min(1)
    np.testing.assert_array_equal(best, out.dist_sq[tuple(sub.T)])
    cg = out.coc[tuple(sub.T)].astype(np.int64)
    vg = sub + out.pvt
    np.testing.assert_array_equal(((vg - cg) ** 2).sum(-1),
                                  out.dist_sq[tuple(sub.T)])


def _Out(fr):
    """A recorded frame as the port's FrameOutput."""
    return FrameOutput(fr, None, fr["pvt"])


def test_long_teleport_beyond_int16():
    """Map at the origin, at x = +40,000 voxels (past int16) and back: the
    window EDT is exact at every stop, the far map is the near one moved,
    the origin map comes back from the archive, nothing is dropped, and the
    stored (dist, coc) pairs are self-consistent."""
    cfg, m, rec, _ = both(sc.extent_teleport)
    out0, out1, out2 = (_Out(f) for f in rec["frames"])
    _check_window_exact(cfg, out0)
    assert out1.pvt[0] > 32767
    _check_window_exact(cfg, out1)
    far = sc.FAR * cfg.voxel_width
    np.testing.assert_allclose(out1.local_occupied_cloud(cfg.voxel_width)
                               - [far, 0, 0],
                               out0.local_occupied_cloud(cfg.voxel_width),
                               atol=1e-3)
    _check_window_exact(cfg, out2)
    assert rec["capacity"]["arch_dropped"] == 0
    assert rec["capacity"]["n_arch"] > 0  # the teleport archived the map

    s = rec["state"]
    coc = s["coc"].astype(np.int64)
    dist = s["dist_sq"]
    valid = (s["vox_type"] != VOX_UNKNOWN) & (dist < EMPTY_VALUE) \
        & (coc[..., 0] != 32767)
    idx = np.argwhere(valid)
    assert len(idx) > 500
    np.testing.assert_array_equal(((idx - coc[valid]) ** 2).sum(-1),
                                  dist[valid])


def test_mirror_global_cocs_beyond_int16():
    """Streamed mirror blocks at +40,000 voxels publish global int32 cocs
    that stay self-consistent."""
    cfg, m, rec, jm = both(sc.extent_mirror)
    assert len(m.mirror) > 0 and len(m.mirror) == len(jm.mirror)
    checked = 0
    for key, blk in m.mirror.blocks.items():
        valid = (blk["dist_sq"] < EMPTY_VALUE) & (blk["coc"][..., 0] != 32767)
        if not valid.any():
            continue
        vidx = np.argwhere(valid)
        vg = vidx + np.asarray(key) * 8
        cg = blk["coc"][valid].astype(np.int64)
        assert cg[:, 0].max() > 32767
        np.testing.assert_array_equal(((vg - cg) ** 2).sum(-1),
                                      blk["dist_sq"][valid])
        checked += len(vidx)
    assert checked > 100
    assert sc.mirror_max_global_x(m.mirror) > 32767


@pytest.mark.parametrize("merge_mode", ["canvas_edt", "relax"])
def test_true_2d_map(merge_mode):
    """A Z == 1 window on either engine: occupied voxels, and no published
    distance above the brute-force one over the window's sites."""
    cfg, m, rec, _ = both(sc.true_2d, merge_mode=merge_mode)
    assert cfg.is_2d
    out = _Out(rec["frames"][0])
    occ = out.glb_type == VOX_OCCUPIED
    assert occ.any()
    occ_idx = np.argwhere(occ)
    sel = (out.glb_type != 0) & (out.dist_sq < cfg.max_loc_dist_sq)
    pts = np.argwhere(sel)
    d2 = ((pts[:, None, :] - occ_idx[None, :, :]) ** 2).sum(-1).min(1)
    assert (out.dist_sq[sel] <= d2).all()


def test_vicon_cam_extrinsic_compose():
    """cow-lady's T_V_C composed onto a vicon pose: the port's compose_matrix
    and l2g equal the JAX package's bit for bit, and a camera-frame point
    goes through the composed projection as through vicon then the
    extrinsic."""
    import jax.numpy as jnp

    from gie_mapping_tpu.utils import config as jcfg
    from gie_mapping_tpu.utils import geometry as jgeo

    pos, quat = [1.0, -2.0, 0.5], [0.9238795, 0.0, 0.0, 0.3826834]
    vicon = tgeo.Projection.from_pose(pos, quat)
    cam = vicon.compose_matrix(tcfg.T_V_C)
    jcam = jgeo.Projection.from_pose(pos, quat).compose_matrix(jcfg.T_V_C)
    np.testing.assert_array_equal(sc.np_of(cam.rot), np.asarray(jcam.rot))
    np.testing.assert_array_equal(sc.np_of(cam.trans), np.asarray(jcam.trans))
    p_cam = np.asarray([[0.3, -0.1, 0.9]], np.float32)
    got = sc.np_of(cam.l2g(torch.from_numpy(p_cam)))
    np.testing.assert_array_equal(got,
                                  np.asarray(jcam.l2g(jnp.asarray(p_cam))))
    t = tcfg.T_V_C.astype(np.float32)
    p_vicon = torch.from_numpy(p_cam @ t[:3, :3].T + t[:3, 3])
    np.testing.assert_allclose(got, sc.np_of(vicon.l2g(p_vicon)), atol=1e-5)


def test_far_pivot_roundtrip():
    """canvas_geometry at pivots far beyond int16 equals the JAX package's;
    only int32 grid-coordinate overflow is rejected."""
    from gie_mapping_tpu.map_state import canvas_geometry as jcanvas
    from gie_mapping_tpu.utils import config as jcfg

    kw = dict(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, max_blocks=1024)
    cfg, cfg_j = tcfg.scan2d_config(**kw), jcfg.scan2d_config(**kw)
    for pvt in ([25000, -25000, 100], [40_000_000, 0, 0]):
        got = canvas_geometry(cfg, np.asarray(pvt))
        want = jcanvas(cfg_j, np.asarray(pvt))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        origin_blk, _, off = got
        assert (off >= 0).all()
        assert (np.abs(origin_blk.astype(np.int64) * 8) < 2 ** 31).all()
    for fn, c in ((canvas_geometry, cfg), (jcanvas, cfg_j)):
        with pytest.raises(ValueError):
            fn(c, np.asarray([1 << 31, 0, 0]))


def test_empty_observation_frame():
    """A frame that observes nothing leaves the map untouched."""
    cfg, m, rec, _ = both(sc.empty_frame)
    out1, out2 = (_Out(f) for f in rec["frames"])
    occ_mask = out1.glb_type == VOX_OCCUPIED
    assert occ_mask.any()
    np.testing.assert_array_equal(out2.glb_type[occ_mask],
                                  out1.glb_type[occ_mask])


def test_fence_box0_inactive():
    """Fence box 0 (the inverted flyable-region box) stays inactive: a robot
    far outside it sees only its own sphere, nothing forced occupied."""
    cfg, m, rec, _ = both(sc.fence_box0)
    out = _Out(rec["frames"][0])
    assert (out.glb_type != VOX_OCCUPIED).all()
    assert (out.glb_type == VOX_FREE).any()
