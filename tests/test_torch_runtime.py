"""The port's copies of the host runtime's numpy modules against the JAX
package's: lz4f, the bag reader and writer, sync, the CSV log, PLY export,
the npz frame files, and a bag written by the port's writer, converted and
replayed through both mappers."""
import os

import numpy as np
import pytest
import torch

from gie_mapping_tpu.runtime import datasets as jds
from gie_mapping_tpu.runtime import logger as jlogger
from gie_mapping_tpu.runtime import lz4f as jlz4f
from gie_mapping_tpu.runtime import rosbag as jrosbag
from gie_mapping_tpu.runtime import rosbag_writer as jwriter
from gie_mapping_tpu.runtime import sync as jsync
from gie_mapping_tpu.runtime import viz as jviz
from gie_mapping_tpu_torch.runtime import datasets as tds
from gie_mapping_tpu_torch.runtime import logger as tlogger
from gie_mapping_tpu_torch.runtime import lz4f as tlz4f
from gie_mapping_tpu_torch.runtime import rosbag as trosbag
from gie_mapping_tpu_torch.runtime import rosbag_writer as twriter
from gie_mapping_tpu_torch.runtime import sync as tsync
from gie_mapping_tpu_torch.runtime import viz as tviz

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small operations: one intra-op thread
    runs them as fast as eight alone, and does not fight the suite's other
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _frames_equal(fa, fb):
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert set(a) == set(b)
        for k in a:
            assert _same(a[k], b[k]), k


def _payloads():
    rng = np.random.default_rng(7)
    return [b"", b"x", b"hello world " * 400,
            rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            rng.integers(0, 4, 50000, dtype=np.uint8).tobytes(),
            b"\x00" * 70000]


@pytest.mark.parametrize("stored", [False, True])
def test_lz4f_both_directions_match_jax(stored):
    for data in _payloads():
        assert tlz4f.xxh32(data) == jlz4f.xxh32(data)
        assert tlz4f.xxh32(data, seed=3) == jlz4f.xxh32(data, seed=3)
        tf = tlz4f.compress(data, block_size=1 << 14, store_uncompressed=stored)
        jf = jlz4f.compress(data, block_size=1 << 14, store_uncompressed=stored)
        assert tf == jf
        assert jlz4f.decompress(tf) == data and tlz4f.decompress(jf) == data
    assert tlz4f.xxh32(b"abc") == 0x32D153FF


@pytest.mark.parametrize("name,sensor,odom", [
    ("handmade_v2.bag", "/scan", "/odom"),
    ("handmade_v2_pc2.bag", "/velodyne_points", "/odom")])
def test_committed_bags_read_to_equal_frames(name, sensor, odom):
    path = os.path.join(FIXTURES, name)
    tm, jm = list(trosbag.read_bag(path)), list(jrosbag.read_bag(path))
    assert [(m.topic, m.msg_type, m.t) for m in tm] == \
        [(m.topic, m.msg_type, m.t) for m in jm]
    for a, b in zip(tm, jm):
        pa, pb = a.parse(), b.parse()
        assert set(pa) == set(pb)
        for k in pa:
            if isinstance(pa[k], np.ndarray):
                assert _same(pa[k], pb[k]), k
            else:
                assert pa[k] == pb[k], k
    assert trosbag.topics(path) == jrosbag.topics(path)
    tf = trosbag.bag_to_frames(path, sensor, odom, slop=1.0)
    assert tf
    _frames_equal(tf, jrosbag.bag_to_frames(path, sensor, odom, slop=1.0))


def _messages(w, rng):
    """(topic, type, t, body) of one message of each kind, serialised by
    writer module `w`."""
    xyz = rng.uniform(-4, 4, (300, 3)).astype(np.float32)
    ring = rng.integers(0, 16, 300)
    depth = rng.uniform(0.2, 6, (8, 12)).astype(np.float32)
    q = (0.9238795, 0.0, 0.0, 0.3826834)
    return [
        ("/info", "sensor_msgs/CameraInfo", 4.9,
         w.camera_info(4.9, 100.0, 110.0, 6.0, 4.0, 8, 12)),
        ("/odom", "nav_msgs/Odometry", 5.0, w.odometry(5.0, (1.0, 2.0, 0.5), q)),
        ("/pose", "geometry_msgs/TransformStamped", 5.01,
         w.transform_stamped(5.01, (1.0, 2.0, 0.5), q, child_frame="kinect")),
        ("/tf", "tf2_msgs/TFMessage", 5.02, w.tf_message(
            [w.transform_stamped(5.02, (0.0, 1.0, 2.0), q, child_frame="a")])),
        ("/scan", "sensor_msgs/LaserScan", 5.03,
         w.laserscan(5.03, rng.uniform(0.1, 20, 360).astype(np.float32))),
        ("/cloud", "sensor_msgs/PointCloud2", 5.04, w.pointcloud2(5.04, xyz)),
        ("/vlp", "sensor_msgs/PointCloud2", 5.05, w.pointcloud2(5.05, xyz, ring)),
        ("/depth", "sensor_msgs/Image", 5.06, w.depth_image(5.06, depth)),
    ]


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_writer_bytes_equal_jax(tmp_path, compression):
    paths = []
    for w in (twriter, jwriter):
        bag = w.BagWriter(chunk_messages=3, compression=compression)
        for topic, mt, t, body in _messages(w, np.random.default_rng(1)):
            bag.add(topic, mt, t, body)
        p = tmp_path / f"{w.__name__.split('.')[0]}.bag"
        assert bag.write(str(p)) == 8
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    # and the port's reader converts every sensor of it as the JAX one does
    for sensor, kw in (("/scan", {}), ("/cloud", {}), ("/vlp", dict(ring_field="ring")),
                       ("/depth", dict(camera_info_topic="/info"))):
        for odom in ("/odom", "/pose"):
            tf = trosbag.bag_to_frames(str(paths[0]), sensor, odom, **kw)
            jf = jrosbag.bag_to_frames(str(paths[0]), sensor, odom, **kw)
            assert len(tf) == 1
            _frames_equal(tf, jf)
    tf = trosbag.bag_to_frames(str(paths[0]), "/cloud", "/tf", tf_child_frame="a")
    _frames_equal(tf, jrosbag.bag_to_frames(str(paths[0]), "/cloud", "/tf",
                                            tf_child_frame="a"))


def test_convert_ring_cloud_and_extrinsic_match_jax(tmp_path):
    """convert_bag's ring binning (the native cloud_to_rings) and the
    body->sensor extrinsic, against the JAX package's converter."""
    from gie_mapping_tpu.utils.config import T_V_C

    bag = twriter.BagWriter(chunk_messages=4, compression="bz2")
    rng = np.random.default_rng(2)
    for i in range(3):
        t = 10.0 + 0.1 * i
        bag.add("/odom", "nav_msgs/Odometry", t,
                twriter.odometry(t, (0.3 * i, 0.1, 1.0), (1.0, 0.0, 0.0, 0.0)))
        bag.add("/vlp", "sensor_msgs/PointCloud2", t + 0.01, twriter.pointcloud2(
            t + 0.01, rng.uniform(-8, 8, (2000, 3)).astype(np.float32),
            rng.integers(0, 16, 2000)))
    p = str(tmp_path / "vlp.bag")
    bag.write(p)
    outs = []
    for mod in (trosbag, jrosbag):
        out = str(tmp_path / f"{mod.__name__.split('.')[0]}.npz")
        assert mod.convert_bag(p, out, "/vlp", "/odom", ring_field="ring",
                               extrinsic=T_V_C) == 3
        outs.append(out)
    fa, fb = tds.load_frames_npz(outs[0]), jds.load_frames_npz(outs[1])
    _frames_equal(fa, fb)
    assert fa[0]["rings"].shape == (16, 360)


def test_sync_matches_jax():
    rng = np.random.default_rng(4)
    ts, js = tsync.ApproximateTimeSync(slop=0.05, queue_size=20), \
        jsync.ApproximateTimeSync(slop=0.05, queue_size=20)
    for t in rng.uniform(0, 5, 60):
        ts.push_odom(float(t), float(t) * 2)
        js.push_odom(float(t), float(t) * 2)
    for t in rng.uniform(-1, 6, 200):
        assert ts.match(float(t)) == js.match(float(t))
    gate = tsync.MsgMgr()
    assert not gate.is_ready
    gate.offer("frame")
    assert gate.is_ready and gate.take() == "frame" and not gate.is_ready


def test_csv_log_schema_matches_jax(tmp_path):
    rows = [(1.5, 2.5, 0.125, 0, 3), (1.0, 2.0, -1.0, 2, 0), (0.0, 7.25, 0.5, 2, 1)]
    text = []
    for mod in (tlogger, jlogger):
        log = mod.CsvLogger(str(tmp_path / f"{mod.__name__.split('.')[0]}.csv"))
        for ogm, edt, rmse, dropped, left in rows:
            log.log_rmse(rmse)
            log.log_frame(ogm, edt, log.take_pending_rmse(), dropped, left)
        assert log.take_pending_rmse() == -1.0
        text.append(log.getvalue())
        log.close()
    assert text[0] == text[1]
    assert text[0].splitlines()[0] == ("Occupancy time,EDT time,RMSE,"
                                       "arch dropped,stream leftover")
    mem = tlogger.CsvLogger()
    mem.log_frame(1.0, 2.0)
    assert mem.getvalue().splitlines()[1] == "1.0000,2.0000,-1.000000,0,0"


def test_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    pts = rng.normal(0, 3, (500, 3)).astype(np.float32)
    s = rng.uniform(0, 2, 500).astype(np.float32)
    for args in ((pts,), (pts, s, "distance")):
        a, b = tmp_path / "t.ply", tmp_path / "j.ply"
        assert tviz.write_ply(str(a), *args) == jviz.write_ply(str(b), *args) == 500
        assert a.read_bytes() == b.read_bytes()


def test_npz_frame_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(8)
    frames = [
        {"position": rng.normal(size=3).astype(np.float32),
         "quat_wxyz": np.asarray([1, 0, 0, 0], np.float32),
         "ranges": rng.random(90).astype(np.float32),
         "theta_min": np.float32(-np.pi), "theta_inc": np.float32(0.07),
         "t": np.float64(3.5)},
        {"position": np.zeros(3, np.float32),
         "quat_wxyz": np.asarray([1, 0, 0, 0], np.float32),
         "points": rng.normal(size=(100, 3)).astype(np.float32)},
    ]
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tds.save_frames_npz(tp, frames)
    jds.save_frames_npz(jp, frames)
    _frames_equal(tds.load_frames_npz(jp), frames)
    _frames_equal(jds.load_frames_npz(tp), frames)
    _frames_equal(tds.load_frames_npz(tp), jds.load_frames_npz(jp))


def _make_bag(w, ds, geo, path, n_frames=4, n_rays=1024):
    """The rehearsal's cow-lady-shaped bag (examples/make_synthetic_bag.py)
    at a small size, from writer `w`, datasets `ds` and geometry `geo` of
    one package."""
    world = ds.BoxWorld.corridor(seed=0, n_pillars=8, extent=4.0, height=2.5)
    poses = ds.circular_trajectory(n_frames=n_frames, radius=1.5, height=1.2)
    bag = w.BagWriter(chunk_messages=24, compression="bz2")
    t0 = 1600000000.0
    for i in range(n_frames * 10):
        t = t0 + i / 100.0
        fi = min(i // 10, n_frames - 1)
        fj = min(fi + 1, n_frames - 1)
        a = i / 10.0 - fi
        pos = (1 - a) * np.asarray(poses[fi].trans) + a * np.asarray(poses[fj].trans)
        quat = geo.rot_to_quat(np.asarray(poses[fi].rot))
        bag.add("/pose", "geometry_msgs/TransformStamped", t,
                w.transform_stamped(t, pos, quat, child_frame="kinect"))
    for i, proj in enumerate(poses):
        t = t0 + i / 10.0
        pts = world.pointcloud(proj, n_rays=n_rays, max_range=8.0, seed=i)
        bag.add("/points", "sensor_msgs/PointCloud2", t, w.pointcloud2(t, pts))
    return bag.write(path)


def test_port_written_bag_replays_equal_in_both_mappers(tmp_path):
    from gie_mapping_tpu.models.mapper import VolumetricMapper as JMapper
    from gie_mapping_tpu.utils import config as jcfg
    from gie_mapping_tpu.utils import geometry as jgeo
    from gie_mapping_tpu_torch.map_state import state_to_numpy
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TMapper
    from gie_mapping_tpu_torch.utils import config as tcfg
    from gie_mapping_tpu_torch.utils import geometry as tgeo

    tb, jb = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    assert _make_bag(twriter, tds, tgeo, tb) == \
        _make_bag(jwriter, jds, jgeo, jb) == 44
    with open(tb, "rb") as f, open(jb, "rb") as g:
        assert f.read() == g.read()
    npz = str(tmp_path / "frames.npz")
    assert trosbag.convert_bag(tb, npz, "/points", "/pose") == 4
    frames = tds.load_frames_npz(npz)
    jnpz = str(tmp_path / "jframes.npz")
    jrosbag.convert_bag(tb, jnpz, "/points", "/pose")
    _frames_equal(frames, jds.load_frames_npz(jnpz))

    kw = dict(local_size_m=(4.0, 4.0, 1.6), voxel_width=0.2, cutoff_dist=1.0,
              max_blocks=2048, max_raycast_points=1024)
    tm = TMapper(tcfg.cow_lady_config(**kw), device="cpu")
    jm = JMapper(jcfg.cow_lady_config(**kw))
    from gie_mapping_tpu_torch.cli import replay_frames as t_replay

    for proj, (kind, pts) in t_replay(npz):
        assert kind == "pointcloud"
        to = tm.process_pointcloud(proj, pts)
        jo = jm.process_pointcloud(
            jgeo.Projection(rot=proj.rot.numpy(), trans=proj.trans.numpy()), pts)
        for k in ("glb_type", "dist_sq", "coc", "edt"):
            assert _same(getattr(to, k), np.asarray(getattr(jo, k))), k
    tm.flush_stream()
    jm.flush_stream()
    tst = state_to_numpy(tm.state)
    for name, v in tst.items():
        assert _same(v, np.asarray(getattr(jm.state, name))), name
    assert tm.mirror.digest() == _jax_mirror_digest(jm.mirror)
    assert (to.glb_type == 2).sum() > 20


def _jax_mirror_digest(mirror):
    from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest

    return mirror_digest(mirror.blocks)


def test_stage_timer_and_trace(tmp_path, monkeypatch):
    """The span API (span / count / take, enable / disable, the cap and its
    `trace.dropped` counter) and the torch.profiler trace writer, which
    shows the spans, on the CPU."""
    import collections

    from gie_mapping_tpu_torch.runtime import profiler

    assert not profiler.enabled()
    x = torch.arange(1000, dtype=torch.float32)
    with profiler.span("idle"):
        profiler.count("n", 1)
    assert profiler.take() == ([], [])
    profiler.enable(ranges=False)
    with profiler.span("frame", frame=3):
        for _ in range(2):
            with profiler.span("sum"):
                x.sum()
        profiler.count("n", 5)
    with profiler.timed("wait") as w:
        pass
    profiler.disable()
    spans, counters = profiler.take()
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("sum", "frame", 3), ("sum", "frame", 3), ("frame", None, 3),
        ("wait", None, None)]
    assert w.ms == (spans[-1][2] - spans[-1][1]) / 1e6
    assert [c[:3] for c in counters] == [("n", 5, 3)]
    with profiler.timed("wait") as w:   # off: timed, not recorded
        pass
    assert w.ms >= 0 and profiler.take() == ([], [])

    monkeypatch.setattr(profiler, "CAP", 4)
    monkeypatch.setattr(profiler, "_records", collections.deque(maxlen=4))
    profiler.enable()
    for i in range(6):
        profiler.count("i", i)
    profiler.disable()
    _, counters = profiler.take()
    assert [c[:2] for c in counters] == [("i", 2), ("i", 3), ("i", 4),
                                         ("i", 5), ("trace.dropped", 2)]

    with profiler.torch_trace(str(tmp_path / "trace"), device="cpu") as prof:
        with profiler.span("double"):
            (x * 2).sum()
    assert prof is not None and not profiler.enabled()
    assert [s[0] for s in profiler.take()[0]] == ["double"]
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "gie/double" in text


def test_rosbag_main_lists_and_converts(tmp_path, capsys):
    """`python -m gie_mapping_tpu_torch.runtime.rosbag`: topics without an
    output, a frames file with one, as the JAX package's converter."""
    bag = os.path.join(FIXTURES, "handmade_v2_pc2.bag")
    trosbag._main([bag])
    assert "/velodyne_points" in capsys.readouterr().out
    out = str(tmp_path / "frames.npz")
    trosbag._main([bag, out, "--sensor", "/velodyne_points", "--odom", "/odom",
                   "--slop", "1.0"])
    assert "wrote 2 frames" in capsys.readouterr().out
    _frames_equal(tds.load_frames_npz(out), jrosbag.bag_to_frames(
        bag, "/velodyne_points", "/odom", slop=1.0))
