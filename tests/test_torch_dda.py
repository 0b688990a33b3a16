"""The PyTorch port's exact DDA ray cast (ops/raycast.py::pointcloud_raycast,
raycast_mode "dda" in VolumetricMapper.process_pointcloud) against the JAX
package, bit for bit: ray_count and inst_type on random clouds and on the
edge rays of tests/test_torch_sensor_cases.py (axis-aligned, through voxel
edges and corners, same-cell, longer than the walk's limit, starting in an
endpoint's voxel), and the mapper's online frames with scrolls and
streaming at a reduced uav_raycast_fine window."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.ops import raycast as jrc
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.ops import raycast as trc
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld
from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
from test_torch_depth import assert_pair, linear
import test_torch_sensor_cases as cases

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for the port's many small operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WINDOWS = {"golden": (25, 25, 10), "uav_raycast_fine": (50, 50, 15)}


def _both(points, valid, origin, pvt, local_size, for_motion_planner=False):
    kw = dict(local_size=local_size, voxel_width=0.2, ogm_min_h=0.2,
              ogm_max_h=3.0, for_motion_planner=for_motion_planner,
              robot_r2_grids=9)
    ji, jc = jrc.pointcloud_raycast(jnp.asarray(points), jnp.asarray(valid),
                                    jnp.asarray(origin), jnp.asarray(pvt), **kw)
    ti, tc = trc.pointcloud_raycast(T(points), T(valid), origin, pvt, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc),
                                  err_msg="ray_count")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji),
                                  err_msg="inst_type")
    return tc.numpy()


def _pvt(origin, local_size):
    return tgeo.calculate_pivot(np.asarray(origin), 0.2, local_size)


def test_max_dda_steps_matches_jax():
    for ls in ((25, 25, 10), (50, 50, 15), (80, 80, 10), (7, 3, 1)):
        assert trc.max_dda_steps(ls) == jrc.max_dda_steps(ls)
    assert trc.max_dda_steps((50, 50, 15)) == 66


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("seed", [0, 1])
def test_raycast_random_clouds_match_jax(window, seed):
    """Random endpoints (some invalid, some beyond the window or the
    height band); seed 0 from 0.05 m (most rays stop at an endpoint near
    the sensor), seed 1 from 1 m with for_motion_planner's robot sphere."""
    ls = WINDOWS[window]
    origin = np.float32([0.13, -0.27, 1.1])
    pts, valid = cases.random_rays(origin, 4096, seed,
                                   near=0.05 if seed == 0 else 1.0)
    cnt = _both(pts, valid, origin, _pvt(origin, ls), ls,
                for_motion_planner=seed == 1)
    assert (cnt > 0).any()
    if seed == 1:
        assert (cnt < -1).any()  # voxels that several rays cross


@pytest.mark.parametrize("origin", [(0.0, 0.0, 1.0), (0.1, 0.1, 1.1),
                                    (0.3, 0.5, 0.7), (-0.05, 0.21, 1.9)])
def test_raycast_edge_rays_match_jax(origin):
    """Axis-aligned rays, rays through voxel edges and corners, same-cell
    rays, endpoints in the sensor's voxel, rays beyond 0.707 * X voxel
    widths, from origins on voxel faces, centres and elsewhere."""
    origin = np.asarray(origin, np.float32)
    pts = cases.dda_rays(origin)
    for ls in WINDOWS.values():
        _both(pts, np.ones(len(pts), bool), origin, _pvt(origin, ls), ls)


def test_raycast_stops_at_an_endpoint_in_the_sensor_voxel():
    """Rays whose sensor voxel holds an endpoint count nothing there."""
    origin = np.float32([0.1, 0.1, 1.1])
    ls = WINDOWS["golden"]
    pts = np.stack([origin + np.float32([0.02, 0.0, 0.0]),
                    origin + np.float32([1.5, 0.3, 0.0])])
    cnt = _both(pts, np.ones(2, bool), origin, _pvt(origin, ls), ls)
    assert cnt.min() == -1 and cnt.max() == 1


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

DDA_MAP = dict(local_size_m=(5.0, 5.0, 2.0), voxel_width=0.2, cutoff_dist=2.0,
               max_blocks=4096, raycast_mode="dda", fuse_raycast=True,
               max_raycast_points=4096)


def test_process_pointcloud_dda_matches_jax_every_frame():
    """Online DDA frames (eager transform, even with fuse_raycast on) that
    scroll the canvas, with streaming on (the preset's default): state and
    outputs after every frame, then the host mirror, equal the JAX
    package's."""
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = linear(6, step=0.7)
    clouds = [world.pointcloud(tgeo.Projection.from_pose(*p), n_rays=3000,
                               max_range=6.0, seed=i)
              for i, p in enumerate(poses)]
    jm = JaxMapper(jcfg.uav_laser3d_fine_config(**DDA_MAP))
    tm = TorchMapper(tcfg.uav_laser3d_fine_config(**DDA_MAP), device="cpu")
    origins = set()
    for i, (p, c) in enumerate(zip(poses, clouds)):
        jo = jm.process_pointcloud(jgeo.Projection.from_pose(*p), c)
        to = tm.process_pointcloud(tgeo.Projection.from_pose(*p), c)
        assert_pair(jm, jo, tm, to, f"frame {i}")
        origins.add(tuple(tm._origin))
    assert len(origins) >= 2
    assert jm.flush_stream() == tm.flush_stream()
    assert mirror_digest(tm.mirror.blocks) == mirror_digest(jm.mirror.blocks)


def test_pointcloud_batch_refuses_dda():
    m = TorchMapper(tcfg.uav_laser3d_fine_config(**DDA_MAP), device="cpu")
    pts, val = m.stage_pointcloud_batch([np.zeros((4, 3), np.float32)] * 2)
    projs = [tgeo.Projection.from_pose(*p) for p in linear(2)]
    with pytest.raises(ValueError, match="projective"):
        m.process_pointcloud_batch(projs, pts, val)


def test_dda_preset_constructs_on_the_cpu():
    cfg = tcfg.uav_laser3d_fine_config(raycast_mode="dda")
    m = TorchMapper(cfg, device="cpu")
    assert m.cfg.canvas_size == (80, 80, 40)
    assert not tcfg.unported_options(cfg)
    assert trc.max_dda_steps(cfg.local_size) == 66
