"""The PyTorch port's cow-lady point-cloud slice against the JAX package:
VolumetricMapper.process_pointcloud frame by frame, bit for bit, on every
MapState field and every output; a run that starts from a JAX state carried
across; and the committed golden point-cloud scenario, which scrolls."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.models.pipeline import _slab_menu
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.map_state import (FIELDS, state_from_numpy,
                                             state_to_numpy)
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.runtime.datasets import (BoxWorld,
                                                    circular_trajectory,
                                                    yaw_then_translate)
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo

# cow-lady at a small window; edt_gate_min_vox=0 lets the change gate and
# the phase-1 cache engage at this size
SMALL = dict(local_size_m=(4.0, 4.0, 1.6), max_raycast_points=4096,
             display_glb_edt=False, display_glb_ogm=False, edt_gate_min_vox=0)
OUTPUTS = ("edt", "glb_type", "dist_sq", "coc", "gate_level", "gate_slab_vox",
           "fnt_count")
WORLD = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)


def _jax_state(m):
    return {f.name: np.asarray(getattr(m.state, f.name))
            for f in dataclasses.fields(m.state)}


def _step(jm, tm, pose, seed):
    jp = jgeo.Projection.from_pose(*pose)
    pts = WORLD.pointcloud(jp, n_rays=4096, max_range=8.0, seed=seed)
    jo = jm.process_pointcloud(jp, pts).fetch()
    to = tm.process_pointcloud(tgeo.Projection.from_pose(*pose), pts)
    return jo, to


def _assert_same(jm, tm, jo, to, frame):
    js, ts = _jax_state(jm), state_to_numpy(tm.state)
    for k in FIELDS:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=f"frame {frame} state {k}")
    for k in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(to, k)),
                                      np.asarray(getattr(jo, k)),
                                      err_msg=f"frame {frame} output {k}")
    np.testing.assert_array_equal(to.changed_blk,
                                  np.asarray(jo.device("changed_blk")))
    np.testing.assert_array_equal(to.ogm_changed,
                                  np.asarray(jo.device("ogm_changed")))
    np.testing.assert_array_equal(tm._origin, jm._origin)


def test_slice_bitwise_every_frame():
    jm = JaxMapper(jcfg.cow_lady_config(**SMALL))
    tm = TorchMapper(tcfg.cow_lady_config(**SMALL), device="cpu")
    poses = yaw_then_translate(n_yaw=5, n_move=3)
    jm.warmup(robot_pos=poses[0][0])
    tm.warmup(robot_pos=poses[0][0])
    levels = []
    for i, pose in enumerate(poses):
        jo, to = _step(jm, tm, pose, seed=i)
        _assert_same(jm, tm, jo, to, i)
        levels.append(to.gate_level)
    n_menu = len(_slab_menu(tm.cfg.canvas_size))
    # the run covers the full branch and a gated slab branch
    assert n_menu in levels and min(levels) < n_menu, levels
    assert (to.glb_type == 2).any() and (to.glb_type == 3).any()


def test_zero_site_frames_then_sites():
    """Frames whose map holds no site take the constant-fill branch; the
    first frame with sites after them takes the full branch."""
    jm = JaxMapper(jcfg.cow_lady_config(**SMALL))
    tm = TorchMapper(tcfg.cow_lady_config(**SMALL), device="cpu")
    poses = yaw_then_translate(n_yaw=3, n_move=0)
    rng = np.random.default_rng(8)
    far = rng.normal(size=(4096, 3)).astype(np.float32)
    far *= 30.0 / np.linalg.norm(far, axis=-1, keepdims=True)  # beyond the window
    levels = []
    for i, pose in enumerate(poses):
        if i < 2:
            jo = jm.process_pointcloud(jgeo.Projection.from_pose(*pose), far).fetch()
            to = tm.process_pointcloud(tgeo.Projection.from_pose(*pose), far)
        else:
            jo, to = _step(jm, tm, pose, seed=i)
        _assert_same(jm, tm, jo, to, i)
        levels.append(to.gate_level)
    n_menu = len(_slab_menu(tm.cfg.canvas_size))
    assert levels == [n_menu + 1, n_menu + 1, n_menu], levels


def test_slice_from_carried_jax_state():
    """Both packages continue from the same non-trivial state: the JAX
    mapper's, carried across with state_from_numpy."""
    jm = JaxMapper(jcfg.cow_lady_config(**SMALL))
    poses = yaw_then_translate(n_yaw=4, n_move=2)
    for i, pose in enumerate(poses[:3]):
        jp = jgeo.Projection.from_pose(*pose)
        jm.process_pointcloud(jp, WORLD.pointcloud(jp, n_rays=4096,
                                                   max_range=8.0, seed=i))
    tm = TorchMapper(tcfg.cow_lady_config(**SMALL), device="cpu")
    tm.state = state_from_numpy(_jax_state(jm), device="cpu")
    np.testing.assert_array_equal(state_to_numpy(tm.state)["a_packed"],
                                  _jax_state(jm)["a_packed"])
    tm._origin = jm._origin.copy()
    tm._last_pvt = jm._last_pvt.copy()
    for i, pose in enumerate(poses[3:], start=3):
        jo, to = _step(jm, tm, pose, seed=i)
        _assert_same(jm, tm, jo, to, i)


GOLDEN_PC = os.path.join(os.path.dirname(__file__), "golden_pointcloud.npz")


def test_golden_pointcloud():
    """tests/test_golden.py's point-cloud scenario (an ungated canvas): its
    frames 0 and 3 match the committed golden; frame 2 crosses the canvas
    hysteresis, so frame 3 follows a scroll."""
    cfg = tcfg.cow_lady_config(local_size_m=(6.0, 6.0, 1.6), voxel_width=0.2,
                               cutoff_dist=2.0, max_blocks=4096,
                               max_raycast_points=4096,
                               display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=17, n_pillars=4, extent=3.5)
    ref = np.load(GOLDEN_PC)
    tm = TorchMapper(cfg, device="cpu")
    origins = []
    for i, proj in enumerate(circular_trajectory(4, radius=1.0, height=0.8)):
        pts = world.pointcloud(proj, n_rays=4096, max_range=4.0, seed=i)
        out = tm.process_pointcloud(proj, pts)
        origins.append(tm._origin.copy())
        assert out.gate_level == -1  # below edt_gate_min_vox: ungated
        if i in (0, 3):
            for k in ("glb_type", "dist_sq", "coc"):
                np.testing.assert_array_equal(getattr(out, k), ref[f"{i}/{k}"],
                                              err_msg=f"frame {i} {k}")
    assert not np.array_equal(origins[1], origins[2])  # frame 2 scrolled


def test_state_roundtrip_and_packing():
    from gie_mapping_tpu import map_state as jms
    from gie_mapping_tpu_torch import map_state as tms

    cfg = tcfg.cow_lady_config(**SMALL)
    s = tms.MapState.create(cfg, device="cpu")
    js = jms.MapState.create(jcfg.cow_lady_config(**SMALL))
    for k in FIELDS:
        np.testing.assert_array_equal(state_to_numpy(s)[k],
                                      np.asarray(getattr(js, k)), err_msg=k)
    rng = np.random.default_rng(0)
    shape = (5, 6, 7)
    occ = rng.integers(0, 256, shape).astype(np.uint8)
    typ = rng.integers(0, 4, shape).astype(np.int8)
    dist = rng.integers(0, 999_999 + 1, shape).astype(np.int32)
    coc = rng.integers(-2000, 2000, shape + (3,)).astype(np.int16)
    coc[0] = 32767
    want = np.asarray(jms.pack_voxels(occ, typ, dist, coc))
    got = tms.pack_voxels(*(torch.from_numpy(a) for a in (occ, typ, dist, coc)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for a, b in zip(tms.unpack_voxels(got), (occ, typ, dist, coc)):
        np.testing.assert_array_equal(a.numpy(), b)
