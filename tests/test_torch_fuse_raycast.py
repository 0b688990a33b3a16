"""The fuse_raycast rounding of the PyTorch port's sensor->world transform
(Projection.l2g_fused) against the JAX frame programs that run it, and
process_pointcloud with fuse_raycast on against the JAX package's, bit for
bit, frame by frame."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small operations: one intra-op thread
    runs them as fast as eight alone, and does not fight the suite's other
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _poses(rng, k):
    """float32 [k, 9, 3] packed poses (rows 3-5 rotation, row 6 origin)."""
    out = np.zeros((k, 9, 3), np.float32)
    for i in range(k):
        p = tgeo.Projection.from_pose(
            rng.normal(size=3).astype(np.float32) * 3, rng.normal(size=4))
        out[i, 3:6], out[i, 6] = p.rot.numpy(), p.trans.numpy()
    return out


# copies of the transform line of frame_step / scroll_frame_step and of the
# replay scan body (gie_mapping_tpu/models/pipeline.py), jitted as there; the
# scan copy rounds the world points to voxels, as the carve does next
_frame_transform = jax.jit(lambda pts, pose: pts @ pose[3:6].T + pose[6])


@jax.jit
def _scan_transform(pts, poses):
    def body(c, xs):
        p, pose = xs
        w = p @ pose[3:6].T + pose[6]
        return c + jnp.floor(w / 0.1 + 0.5).astype(jnp.int32).sum(), w

    return jax.lax.scan(body, jnp.int32(0), (pts, poses))[1]


@pytest.mark.parametrize("n", [256, 4096, 131072])
def test_l2g_fused_matches_jax_frame_programs(n):
    rng = np.random.default_rng(n)
    pts = (rng.normal(size=(3, n, 3)) * 4).astype(np.float32)
    poses = _poses(rng, 3)
    scan = np.asarray(_scan_transform(pts, poses))
    for k in range(3):
        proj = tgeo.Projection(T(poses[k, 3:6].copy()), T(poses[k, 6].copy()))
        got = _bits(proj.l2g_fused(T(pts[k])).numpy())
        np.testing.assert_array_equal(got, _bits(scan[k]), err_msg=f"scan {k}")
        np.testing.assert_array_equal(
            got, _bits(_frame_transform(pts[k], poses[k])), err_msg=f"frame {k}")
        # the eager rule (fuse_raycast off) rounds x and y differently
        assert (_bits(proj.l2g(T(pts[k])).numpy())[:, :2] != got[:, :2]).any()


# 131,072 points a frame: at 65,536 the parent's division fault (ROADMAP
# C.0) moved no voxel on this path
SMALL = dict(local_size_m=(4.0, 4.0, 1.6), max_raycast_points=131072,
             display_glb_edt=False, display_glb_ogm=False, edt_gate_min_vox=0,
             fuse_raycast=True)


def test_online_fuse_raycast_bitwise_every_frame():
    """process_pointcloud with fuse_raycast on: every MapState field and
    output equal to the JAX package's, frame by frame, over a path that
    scrolls at frame 2 (the gate and the phase-1 cache on)."""
    jm = JaxMapper(jcfg.cow_lady_config(**SMALL))
    tm = TorchMapper(tcfg.cow_lady_config(**SMALL), device="cpu")
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    origins = []
    for i in range(4):
        trans = np.asarray([-1.0 + 0.9 * i, 0.1 * i, 1.2], np.float32)
        quat = (np.cos(0.2 * i), 0.0, 0.0, np.sin(0.2 * i))
        pts = world.pointcloud(tgeo.Projection.from_pose(trans, quat),
                               n_rays=131072, max_range=8.0, seed=i)
        jo = jm.process_pointcloud(jgeo.Projection.from_pose(trans, quat),
                                   pts).fetch()
        to = tm.process_pointcloud(tgeo.Projection.from_pose(trans, quat), pts)
        js, ts = jm.state, state_to_numpy(tm.state)
        for k in FIELDS:
            np.testing.assert_array_equal(ts[k], np.asarray(getattr(js, k)),
                                          err_msg=f"frame {i} state {k}")
        for k in ("edt", "dist_sq", "coc", "glb_type", "gate_level",
                  "fnt_count"):
            np.testing.assert_array_equal(np.asarray(getattr(to, k)),
                                          np.asarray(getattr(jo, k)),
                                          err_msg=f"frame {i} output {k}")
        origins.append(tm._origin.copy())
    assert len({o.tobytes() for o in origins}) > 1  # the canvas scrolled




def test_mapper_uses_the_fused_transform():
    """With fuse_raycast on, process_pointcloud must transform as the JAX
    frame program does: on points whose world positions lie on voxel
    faces, the eager rule moves endpoints to the next voxel, so the state
    after one frame tells the two rules apart."""
    kw = dict(local_size_m=(4.0, 4.0, 1.6), max_raycast_points=4096,
              display_glb_edt=False, display_glb_ogm=False, fuse_raycast=True)
    trans = np.asarray([0.37, -0.21, 1.13], np.float32)
    quat = (0.93, 0.05, -0.04, 0.36)
    proj = tgeo.Projection.from_pose(trans, quat)
    rng = np.random.default_rng(5)
    faces = (np.floor(rng.uniform(-1.9, 1.9, (4096, 3)) * 10) + 0.5) / 10
    faces[:, 2] = np.abs(faces[:, 2]) * 0.6 + 0.05
    world = (faces + np.floor(trans * 10) / 10).astype(np.float32)
    rot = proj.rot.numpy().astype(np.float64)
    pts = ((world - trans.astype(np.float64)) @ rot).astype(np.float32)
    # the two rules put some of these points in different voxels
    fused = tgeo.pos2coord(proj.l2g_fused(T(pts)), 0.1)
    eager = tgeo.pos2coord(proj.l2g(T(pts)), 0.1)
    assert (fused != eager).any(-1).sum() > 10
    jm = JaxMapper(jcfg.cow_lady_config(**kw))
    tm = TorchMapper(tcfg.cow_lady_config(**kw), device="cpu")
    jm.process_pointcloud(jgeo.Projection.from_pose(trans, quat), pts).fetch()
    tm.process_pointcloud(proj, pts)
    ts = state_to_numpy(tm.state)
    for k in FIELDS:
        np.testing.assert_array_equal(ts[k], np.asarray(getattr(jm.state, k)),
                                      err_msg=k)
