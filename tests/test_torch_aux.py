"""The port's side channels and profiling hooks against the JAX package:
process_ext_cloud (DBSCAN fence boxes, also between two replay calls),
process_multiscan_cloud, the RMSE checks (profile_loc_rms,
profile_glb_rms) and the CSV log, online and replayed."""
import warnings

import jax
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.runtime import datasets as ds
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
from gie_mapping_tpu_torch.utils.constants import VOX_OCCUPIED

OUTPUTS = ("edt", "glb_type", "dist_sq", "coc", "fnt_count")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jp(p):
    return jgeo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())


def _assert_same(jm, tm, jo, to, msg):
    for k in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(to, k)),
                                      np.asarray(getattr(jo, k)),
                                      err_msg=f"{msg}: {k}")
    st = state_to_numpy(tm.state)
    for name in FIELDS:
        np.testing.assert_array_equal(st[name], np.asarray(getattr(jm.state, name)),
                                      err_msg=f"{msg}: state.{name}")


def _small(pkg, **kw):
    base = dict(local_size_m=(6.0, 6.0, 1.2), voxel_width=0.2,
                cutoff_dist=3.0, max_blocks=4096)
    base.update(kw)
    return pkg.scan2d_config(**base)


def _scans(n, radius=1.0, beams=180):
    world = ds.BoxWorld.corridor(seed=3, n_pillars=4, extent=4.0)
    poses = ds.circular_trajectory(n, radius=radius)
    return [(p, world.scan_2d(p, n_beams=beams)) for p in poses]


def test_ext_cloud_appends_boxes_as_jax():
    rng = np.random.default_rng(0)
    cloud = np.concatenate([
        rng.normal([1.0, 1.0, 1.0], 0.05, (40, 3)),
        rng.normal([-1.5, 0.5, 0.4], 0.08, (30, 3)),
        rng.uniform(-3, 3, (10, 3))]).astype(np.float32)
    jm = JaxMapper(_small(jcfg))
    tm = TorchMapper(_small(tcfg), device="cpu")
    assert tm.process_ext_cloud(cloud) == jm.process_ext_cloud(cloud) >= 3
    for a, b in ((tm.ext_obs.ll, jm.ext_obs.ll), (tm.ext_obs.ur, jm.ext_obs.ur)):
        np.testing.assert_array_equal(a, b)
    (p, (r, tmin, tinc)), = _scans(1, radius=0.3, beams=360)
    jo = jm.process_scan2d(_jp(p), r, tmin, tinc)
    to = tm.process_scan2d(p, r, tmin, tinc)
    _assert_same(jm, tm, jo, to, "after the ext cloud")
    # the box is an obstacle in the map
    v = np.floor(np.asarray([1.0, 1.0, 1.0]) / 0.2 + 0.5).astype(int) - to.pvt
    assert to.glb_type[tuple(v)] == VOX_OCCUPIED
    # a prior map and the capacity of the box set
    ll = [np.asarray([-3, -3, 0], np.float32)] * 3
    ur = [np.asarray([3, 3, 2], np.float32)] * 3
    big = np.concatenate([rng.normal([x, 0, 1], 0.05, (6, 3))
                          for x in np.arange(-8, 8, 0.7)]).astype(np.float32)
    assert tm.process_ext_cloud(big, ll, ur) == jm.process_ext_cloud(big, ll, ur) \
        == tm.cfg.max_ext_obs


def test_multiscan_cloud_matches_jax():
    kw = dict(local_size_m=(6.0, 6.0, 1.6), voxel_width=0.2, max_blocks=4096,
              ogm_min_h=-10, ogm_max_h=10)
    jm = JaxMapper(jcfg.uav_laser3d_config(**kw))
    tm = TorchMapper(tcfg.uav_laser3d_config(**kw), device="cpu")
    world = ds.BoxWorld.corridor(seed=9, n_pillars=5, extent=4.0)
    for i, p in enumerate(ds.circular_trajectory(2, radius=0.5, height=0.8)):
        pts, ring, pmin, pinc = ds.ring_cloud(world, p, scan_num=180)
        ring = ring.copy()
        ring[::97] = 16  # out of range: dropped by both
        jo = jm.process_multiscan_cloud(_jp(p), pts, ring, ring_num=16,
                                        scan_num=180, phi_min=pmin, phi_inc=pinc)
        to = tm.process_multiscan_cloud(p, pts, ring, ring_num=16,
                                        scan_num=180, phi_min=pmin, phi_inc=pinc)
        _assert_same(jm, tm, jo, to, f"frame {i}")
    assert (to.glb_type == VOX_OCCUPIED).sum() > 0


def _csv_without_times(text):
    return [ln.split(",")[2:] for ln in text.strip().splitlines()[1:]]


@pytest.mark.parametrize("flags", [dict(profile_loc_rms=True),
                                   dict(profile_glb_rms=True),
                                   dict(profile_loc_rms=True, profile_glb_rms=True,
                                        vis_interval=2)])
def test_profiling_hooks_match_jax(flags, tmp_path):
    kw = dict(display_glb_edt=True, display_glb_ogm=True, **flags)
    jm = JaxMapper(_small(jcfg, **kw))
    tm = TorchMapper(_small(tcfg, **kw), device="cpu",
                     log_path=str(tmp_path / "port.csv"))
    for i, (p, (r, tmin, tinc)) in enumerate(_scans(4)):
        jo = jm.process_scan2d(_jp(p), r, tmin, tinc)
        to = tm.process_scan2d(p, r, tmin, tinc)
        assert tm.gt_checker.last == jm.gt_checker.last, i
        assert tm.gt_checker.last_global == jm.gt_checker.last_global, i
    _assert_same(jm, tm, jo, to, "last frame")
    if flags.get("profile_loc_rms"):
        assert tm.gt_checker.last[0] >= 0
    if flags.get("profile_glb_rms"):
        assert tm.gt_checker.last_global[0] >= 0
    rows = _csv_without_times(tm.logger.getvalue())
    assert rows == _csv_without_times(jm.logger.getvalue())
    assert len(rows) == 4 and any(float(r[0]) >= 0 for r in rows)
    with open(tmp_path / "port.csv") as f:
        assert f.read() == tm.logger.getvalue()


def test_replay_logs_a_row_per_frame_as_jax():
    """The replay path logs one row per frame (ogm 0.0, no RMSE check); the
    fallback frames log as online frames do."""
    kw = dict(display_glb_edt=False, display_glb_ogm=False)
    jm = JaxMapper(_small(jcfg, **kw), log_path=None)
    tm = TorchMapper(_small(tcfg, **kw), device="cpu", log_path=None)
    assert tm.logger is None
    frames = _scans(7)
    projs = [p for p, _ in frames]
    ranges = np.stack([s[0] for _, s in frames])
    tmin, tinc = frames[0][1][1:]
    jm2 = JaxMapper(_small(jcfg, **kw), log_path="")
    tm2 = TorchMapper(_small(tcfg, **kw), device="cpu", log_path="")
    jm2.process_scan2d_batch([_jp(p) for p in projs], ranges, tmin, tinc, chunk=3)
    tm2.process_scan2d_batch(projs, ranges, tmin, tinc, chunk=3)
    assert tm2.replay_scanned_frames == jm2.replay_scanned_frames > 0
    text = tm2.logger.getvalue()
    assert _csv_without_times(text) == _csv_without_times(jm2.logger.getvalue())
    lines = text.strip().splitlines()[1:]
    assert len(lines) == 7
    assert sum(ln.startswith("0.0000,") for ln in lines) >= tm2.replay_scanned_frames


def _there_and_back(n, step, start):
    return ds.there_and_back(n, step, start, z=0.9)


def test_ext_cloud_between_replay_batches():
    """The fence-churn scenario: boxes whose activation toggles along a
    there-and-back path, and an external-observer cloud between two replay
    calls.  The port's replay and its frame loop are held against the JAX
    package's frame loop (with the frames before the ext cloud finished
    first: its cached fence arrays may alias the boxes that
    process_ext_cloud rewrites in place)."""
    kw = dict(voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
              max_blocks=2048, max_raycast_points=256, fuse_raycast=True,
              display_glb_edt=False, display_glb_ogm=False)
    world = ds.BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = _there_and_back(14, step=0.8, start=-2.0)
    clouds = [world.pointcloud(p, n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]
    boxes = [(np.asarray([2.4, -0.5, 0.0], np.float32),
              np.asarray([3.0, 0.8, 1.4], np.float32)),
             (np.asarray([-4.6, -0.4, 0.0], np.float32),
              np.asarray([-4.0, 0.6, 1.2], np.float32))]
    rng = np.random.default_rng(9)
    ext_cloud = (np.asarray([1.0, 0.6, 0.5], np.float32)
                 + rng.uniform(-0.05, 0.05, (8, 3)).astype(np.float32))

    jm = JaxMapper(jcfg.cow_lady_config(**kw))
    for ll, ur in boxes:
        jm.ext_obs.append(ll, ur)
    fence_on = []
    for i, p in enumerate(poses):
        if i == 7:
            jax.block_until_ready(jm.state)
            jm.process_ext_cloud(ext_cloud)
        pvt = jgeo.calculate_pivot(p.trans.numpy(), 0.2, jm.cfg.local_size)
        fence_on.append(jm._fence_args(pvt)[1])
        jo = jm.process_pointcloud(_jp(p), clouds[i]).fetch()
    assert sum(a != b for a, b in zip(fence_on, fence_on[1:])) >= 2, fence_on

    def port(batch):
        m = TorchMapper(tcfg.cow_lady_config(**kw), device="cpu")
        for ll, ur in boxes:
            m.ext_obs.append(ll, ur)
        pts, val = m.stage_pointcloud_batch(clouds)
        if batch:
            m.process_pointcloud_batch(poses[:7], pts[:7], val[:7], chunk=3)
            n = m.process_ext_cloud(ext_cloud)
            out = m.process_pointcloud_batch(poses[7:], pts[7:], val[7:], chunk=3)
        else:
            for i, p in enumerate(poses):
                if i == 7:
                    n = m.process_ext_cloud(ext_cloud)
                out = m.process_pointcloud(p, pts[i], val[i])
        return m, n, out

    for batch in (False, True):
        tm, n, to = port(batch)
        assert n == jm.ext_obs.n == 2
        _assert_same(jm, tm, jo, to, f"batch={batch}")
    assert tm.replay_scanned_frames > 0
