"""The PyTorch port's replay mapper (process_pointcloud_batch,
process_scan2d_batch, pipeline.replay_frames) against the JAX package's,
bit for bit, and against the port's own per-frame loop.

Each replay case runs the same frames three ways: the JAX package's batch
call, the port's batch call and the port's per-frame loop.  It compares
every MapState field, the last FrameOutput's window tensors, every run's
per_frame scalars (recorded at both packages' replay_frames), map_ct, the
canvas origin and the replay counters.  The sizes are those of
tests/test_replay_batch.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models import pipeline as jpipe
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models import mapper as tmapper
from gie_mapping_tpu_torch.models import pipeline as tpipe
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld
from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo

T = torch.from_numpy
EYE = np.eye(3, dtype=np.float32)
OUTPUTS = ("edt", "dist_sq", "coc", "glb_type")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small operations: one intra-op thread
    runs them as fast as eight alone, and does not fight the suite's other
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------

def _linear(n, step=0.5, start=-1.8):
    return [(EYE, np.asarray([start + step * i, 0.15 * i, 0.9], np.float32))
            for i in range(n)]


def _jproj(p):
    return jgeo.Projection(rot=p[0], trans=p[1])


def _tproj(p):
    return tgeo.Projection(T(p[0].copy()), T(p[1].copy()))


def _cfg(pkg, kw):
    return (jcfg if pkg == "jax" else tcfg).cow_lady_config(**kw)


def _assert_states(a, b, msg):
    sa = {f.name: np.asarray(getattr(a.state, f.name))
          for f in dataclasses.fields(a.state)} if isinstance(a, JaxMapper) \
        else state_to_numpy(a.state)
    sb = state_to_numpy(b.state)
    for k in FIELDS:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=f"{msg}: state {k}")


def _assert_pair(jm, jo, tm, to, msg):
    _assert_states(jm, tm, msg)
    for k in OUTPUTS:
        want = jo.device(k) if isinstance(jm, JaxMapper) else jo.raw[k]
        np.testing.assert_array_equal(np.asarray(to.raw[k]), np.asarray(want),
                                      err_msg=f"{msg}: output {k}")
    assert tm.map_ct == jm.map_ct, msg
    np.testing.assert_array_equal(tm._origin, jm._origin, err_msg=msg)


@pytest.fixture
def runs(monkeypatch):
    """Each package's replay_frames records its runs' per_frame scalars."""
    got = {"jax": [], "torch": []}

    def recording(orig, key):
        def f(*a, **kw):
            res = orig(*a, **kw)
            got[key].append({k: np.asarray(v) for k, v in res[3].items()})
            return res
        return f

    monkeypatch.setattr(jpipe, "replay_frames",
                        recording(jpipe.replay_frames, "jax"))
    monkeypatch.setattr(tmapper, "replay_frames",
                        recording(tmapper.replay_frames, "torch"))
    return got


def _drive(pkg, kw, poses, clouds, chunk, *, fences=(), batch=True, head=0):
    """One mapper over the frames: `head` frames per-frame, then the rest in
    one batch call (or all per-frame).  Returns (mapper, last output)."""
    m = (JaxMapper(_cfg(pkg, kw)) if pkg == "jax"
         else TorchMapper(_cfg(pkg, kw), device="cpu"))
    if fences:
        # the default fence box first, as both mappers start with it
        m.ext_obs.assign([m.ext_obs.ll[0].copy()] + [ll for ll, _ in fences],
                         [m.ext_obs.ur[0].copy()] + [ur for _, ur in fences])
    proj = _jproj if pkg == "jax" else _tproj
    pts, val = m.stage_pointcloud_batch(clouds)
    out = None
    for i in range(len(poses) if not batch else head):
        out = m.process_pointcloud(proj(poses[i]), pts[i], val[i])
    if batch:
        out = m.process_pointcloud_batch([proj(p) for p in poses[head:]],
                                         pts[head:], val[head:], chunk=chunk)
    return m, out


BIG = dict(voxel_width=0.2, local_size_m=(9.6, 9.6, 1.6), cutoff_dist=1.0,
           max_blocks=2048, max_raycast_points=256, fuse_raycast=True,
           display_glb_edt=False, display_glb_ogm=False)
TINY = dict(BIG, local_size_m=(4.0, 4.0, 1.6), max_blocks=1024)


def _teleport(n, at, to):
    poses = _linear(n)
    poses[at] = (EYE, np.asarray(to, np.float32))
    return poses


def _jitter(n):
    return [(EYE, np.asarray([0.03 * (i % 3), 0.02 * (i % 2), 0.9], np.float32))
            for i in range(n)]


# name: (config, poses, chunk, per-frame head, world seed, fences, checks)
CASES = {
    "small_canvas_full_scroll": (TINY, _linear(8), 3, 0, 3, (), None),
    # the change gate on (edt_gate_min_vox=0): the gated merge in runs
    "compacted_scroll_gated": (dict(BIG, edt_gate_min_vox=0), _linear(8), 3, 0,
                               3, (), lambda m: m.replay_scanned_frames >= 3
                               and m.replay_scanned_scrolls >= 1),
    "scroll_free": (TINY, _jitter(8), 7, 1, 3, (),
                    lambda m: m.replay_scanned_frames >= 7
                    and m.replay_scanned_scrolls == 0),
    "relax_engine": (dict(TINY, max_raycast_points=2048, merge_mode="relax"),
                     _linear(6), 3, 0, 3, (), None),
    # [fresh fallback, 2-run, fallback, teleport, teleport back, 5-run,
    # fallback] at chunk 8 (ladder [8, 5, 4, 2])
    "short_ladder_teleport": (BIG, _teleport(12, 4, (15.0, 8.0, 0.9)), 8, 0, 7,
                              (), lambda m: m.replay_scanned_frames == 7),
    "fence_flip": (TINY, _linear(8), 3, 0, 3,
                   ((np.asarray([3.0, -0.5, 0.0], np.float32),
                     np.asarray([3.6, 0.8, 1.4], np.float32)),), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pointcloud_batch_matches_jax_and_the_frame_loop(runs, case):
    kw, poses, chunk, head, seed, fences, check = CASES[case]
    world = BoxWorld.corridor(seed=seed, n_pillars=5, extent=3.0, height=2.0)
    clouds = [world.pointcloud(_tproj(p), n_rays=kw["max_raycast_points"],
                               max_range=6.0, seed=i) for i, p in enumerate(poses)]
    jm, jo = _drive("jax", kw, poses, clouds, chunk, fences=fences, head=head)
    jo.fetch()
    tm, to = _drive("torch", kw, poses, clouds, chunk, fences=fences, head=head)
    lm, lo = _drive("torch", kw, poses, clouds, chunk, fences=fences, batch=False)
    _assert_pair(jm, jo, tm, to, f"{case} vs JAX")
    _assert_pair(lm, lo, tm, to, f"{case} vs the frame loop")
    assert (tm.replay_scanned_frames, tm.replay_scanned_scrolls) == \
        (jm.replay_scanned_frames, jm.replay_scanned_scrolls)
    assert tm.replay_scanned_frames > 0
    assert len(runs["torch"]) == len(runs["jax"]) > 0
    for r, (a, b) in enumerate(zip(runs["torch"], runs["jax"])):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"run {r} {k}")
    if hasattr(jo, "per_frame"):
        for k, v in jo.per_frame.items():
            np.testing.assert_array_equal(to.per_frame[k].numpy(), np.asarray(v))
    else:
        assert not hasattr(to, "per_frame")
    if check is not None:
        assert check(tm), (tm.replay_scanned_frames, tm.replay_scanned_scrolls)
    if fences:
        # the box was active for some windows and not for others
        keys = {tm._fence_key(tgeo.calculate_pivot(p[1], 0.2, tm.cfg.local_size))
                for p in poses}
        assert len(keys) > 1


def test_streaming_mirror_matches_jax_and_the_frame_loop():
    """Streaming once per run over the union of its changed blocks: the host
    mirror equals the JAX package's and, in a static world, the per-frame
    loop's."""
    kw = dict(TINY, display_glb_ogm=True, display_glb_edt=True, vis_interval=1)
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    pose = (EYE, np.asarray([0.0, 0.0, 0.9], np.float32))
    cloud = world.pointcloud(_tproj(pose), n_rays=256, max_range=6.0, seed=1)
    poses, clouds = [pose] * 6, [cloud] * 6
    mirrors = {}
    for name, pkg, batch in (("jax", "jax", True), ("torch", "torch", True),
                             ("loop", "torch", False)):
        m, _ = _drive(pkg, kw, poses, clouds, 5, batch=batch)
        m.flush_stream()
        mirrors[name] = mirror_digest(m.mirror.blocks)
        assert len(m.mirror) > 0
    assert mirrors["torch"] == mirrors["jax"] == mirrors["loop"]


def test_streaming_scroll_replay_matches_jax():
    """A scrolling replay with streaming on: the stream carry is moved by
    each run's net origin change; state, counters and the host mirror equal
    the JAX package's."""
    kw = dict(BIG, display_glb_ogm=True, display_glb_edt=True, vis_interval=3,
              stream_k_cols=16)
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = _linear(9)
    clouds = [world.pointcloud(_tproj(p), n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]
    jm, jo = _drive("jax", kw, poses, clouds, 4)
    tm, to = _drive("torch", kw, poses, clouds, 4)
    _assert_pair(jm, jo.fetch(), tm, to, "streaming scroll")
    assert tm.replay_scanned_scrolls >= 1
    np.testing.assert_array_equal(tm._stream_carry.numpy(),
                                  np.asarray(jm._stream_carry))
    assert jm.flush_stream() == tm.flush_stream()
    assert mirror_digest(tm.mirror.blocks) == mirror_digest(jm.mirror.blocks)


def test_scan2d_batch_matches_jax_and_the_frame_loop(runs):
    kw = dict(local_size_m=(4.8, 4.8, 1.2), voxel_width=0.2, cutoff_dist=1.0,
              max_blocks=1024)
    world = BoxWorld.corridor(seed=5, n_pillars=4, extent=3.0)
    poses = _linear(7, step=0.45)
    scans = [world.scan_2d(_tproj(p), n_beams=120) for p in poses]
    ranges = np.stack([s[0] for s in scans])
    tmin, tinc = scans[0][1], scans[0][2]

    jm = JaxMapper(jcfg.scan2d_config(**kw))
    jo = jm.process_scan2d_batch([_jproj(p) for p in poses], ranges, tmin,
                                 tinc, chunk=3).fetch()
    tm = TorchMapper(tcfg.scan2d_config(**kw), device="cpu")
    to = tm.process_scan2d_batch([_tproj(p) for p in poses], ranges, tmin,
                                 tinc, chunk=3)
    lm = TorchMapper(tcfg.scan2d_config(**kw), device="cpu")
    for p, r in zip(poses, ranges):
        lo = lm.process_scan2d(_tproj(p), r, tmin, tinc)
    _assert_pair(jm, jo, tm, to, "scan2d vs JAX")
    _assert_pair(lm, lo, tm, to, "scan2d vs the frame loop")
    assert tm.replay_scanned_frames == jm.replay_scanned_frames > 0
    assert len(runs["torch"]) == len(runs["jax"]) > 0
    for a, b in zip(runs["torch"], runs["jax"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_scan_body_beam_geometry_matches_jax():
    """Projection.to_local's eight-row rule inside the JAX replay scan body:
    the 2-D LiDAR model run by a jitted copy of the scan body's
    _fused_sensor call (the pose from packed float32 rows) equals the
    port's scan_sensor on every voxel."""
    from gie_mapping_tpu.utils.config import scan2d_config as jscan

    cfg_j = jscan(local_size_m=(4.8, 4.8, 1.2), voxel_width=0.2)
    cfg_t = tcfg.scan2d_config(local_size_m=(4.8, 4.8, 1.2), voxel_width=0.2)
    world = BoxWorld.corridor(seed=5, n_pillars=4, extent=3.0)
    rng = np.random.default_rng(4)
    K = 4
    poses = np.zeros((K, 9, 3), np.float32)
    ranges = []
    for k in range(K):
        trans = np.asarray([rng.uniform(-1, 1), rng.uniform(-1, 1), 0.9],
                           np.float32)
        q = (1.0, rng.normal() * 0.05, rng.normal() * 0.05, rng.normal())
        p = tgeo.Projection.from_pose(trans, q)
        r, tmin, tinc = world.scan_2d(p, n_beams=120)
        pvt = tgeo.calculate_pivot(trans, 0.2, cfg_t.local_size)
        poses[k, 0], poses[k, 3:6], poses[k, 6] = pvt, p.rot.numpy(), trans
        poses[k, 7, :2] = tmin, tinc
        ranges.append(r)
    ranges = np.stack(ranges).astype(np.float32)

    @jax.jit
    def scan(poses, ranges):
        def body(c, xs):
            pvt, _, _, rot, origin, s1, s2 = jpipe._unpack_pose(xs[0])
            inst, _ = jpipe._fused_sensor("scan", xs[1], rot, origin, s1, s2,
                                          pvt, cfg_j)
            return c, inst
        return jax.lax.scan(body, 0, (poses, ranges))[1]

    want = np.asarray(scan(poses, ranges))
    for k in range(K):
        got, _ = tpipe.scan_sensor(T(ranges[k]), poses[k, 3:6], poses[k, 6],
                                   poses[k, 7], poses[k, 8],
                                   poses[k, 0].astype(np.int32), cfg=cfg_t)
        np.testing.assert_array_equal(got.numpy(), want[k], err_msg=f"frame {k}")


def test_replay_frames_guards_has_scrolls():
    cfg = tcfg.cow_lady_config(**TINY)
    m = TorchMapper(cfg, device="cpu")
    poses = np.zeros((2, 9, 3), np.float32)
    fence, _ = m._fence_args(np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="has_scrolls=False"):
        tpipe.replay_frames(m.state, poses, np.asarray([False, True]), fence,
                            cfg=cfg, origin_blk=np.zeros(3, np.int32),
                            input_pointcloud=True, has_scrolls=False)


def test_pointcloud_batch_takes_host_arrays():
    """Host arrays give the state that staged tensors give."""
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = _linear(4)
    clouds = [world.pointcloud(_tproj(p), n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]
    states = []
    for host in (False, True):
        m = TorchMapper(tcfg.cow_lady_config(**TINY), device="cpu")
        pts, val = m.stage_pointcloud_batch(clouds)
        if host:
            pts, val = pts.numpy(), val.numpy()
        m.process_pointcloud_batch([_tproj(p) for p in poses], pts, val, chunk=3)
        assert m.replay_scanned_frames == 3
        states.append(state_to_numpy(m.state))
    for k in FIELDS:
        np.testing.assert_array_equal(states[1][k], states[0][k], err_msg=k)


def test_pointcloud_batch_requires_fuse_raycast():
    m = TorchMapper(tcfg.cow_lady_config(**dict(TINY, fuse_raycast=False)),
                    device="cpu")
    pts, val = m.stage_pointcloud_batch([np.zeros((4, 3), np.float32)] * 2)
    with pytest.raises(ValueError, match="fuse_raycast"):
        m.process_pointcloud_batch([_tproj(p) for p in _linear(2)], pts, val)
