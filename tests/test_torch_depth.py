"""The PyTorch port's depth-camera map maker (ops/scan_sensors.py::
realsense_update, pipeline.depth_sensor, VolumetricMapper.process_depth
and process_depth_batch) against the JAX package, bit for bit.

The sensor model's pixel indices and forward distances are held against a
jitted copy of the JAX model's body, and its inst_type against a jitted
scan of the JAX frame program's `_fused_sensor("depth")`, at the goldens'
25 x 25 x 10 window (whose 6,250 voxels are not a multiple of 8, the frame
change's tail) and at the depthcam preset's 100 x 100 x 30 window, on
images with NaN, +Inf, 0 and 0.21 m pixels, under both NaN policies.  The
mapper runs online frames that scroll the depthcam-class canvas (one
slack block), a replay against JAX's batch call and the port's own frame
loop, and the JAX golden.  The helpers here also drive
tests/test_torch_multiscan.py."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models import pipeline as jpipe
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.ops import scan_sensors as jss
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models import mapper as tmapper
from gie_mapping_tpu_torch.models import pipeline as tpipe
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.ops import scan_sensors as tss
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld, circular_trajectory
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
import test_torch_sensor_cases as cases

T = torch.from_numpy
EYE = np.eye(3, dtype=np.float32)
OUTPUTS = ("edt", "dist_sq", "coc", "glb_type")
PRESETS = {"depth": "depthcam_config", "multiscan": "uav_laser3d_config"}


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
# helpers (also used by test_torch_multiscan.py)
# ---------------------------------------------------------------------------

def configs(kind, **kw):
    """(JAX config, port config) of the sensor's preset with `kw`."""
    return (getattr(jcfg, PRESETS[kind])(**kw),
            getattr(tcfg, PRESETS[kind])(**kw))


def jax_frame_body(kind, cfg_j, rows, data):
    """inst_type [K, X, Y, Z] of the JAX per-frame program's sensor:
    `_fused_sensor(kind)` jitted alone on each frame's packed pose rows (it
    rounds the sensor's height offset as frame_step does)."""
    @jax.jit
    def one(row, d):
        pvt, _, _, rot, origin, s1, s2 = jpipe._unpack_pose(row)
        return jpipe._fused_sensor(kind, d, rot, origin, s1, s2, pvt, cfg_j)[0]

    return np.stack([np.asarray(one(jnp.asarray(r), jnp.asarray(d)))
                     for r, d in zip(rows, data)])


def jax_scan_body(kind, cfg_j, rows, data):
    """inst_type [K, X, Y, Z] of the JAX replay's sensor: a jitted scan
    whose body runs `_fused_sensor(kind)` on the packed pose rows."""
    @jax.jit
    def scan(rows, data):
        def body(c, xs):
            pvt, _, _, rot, origin, s1, s2 = jpipe._unpack_pose(xs[0])
            inst, _ = jpipe._fused_sensor(kind, xs[1], rot, origin, s1, s2,
                                          pvt, cfg_j)
            return c, inst
        return jax.lax.scan(body, 0, (rows, data))[1]

    return np.asarray(scan(jnp.asarray(rows), jnp.asarray(data)))


def port_sensor(kind, cfg_t, rows, data, replay=False):
    """The port's sensor model on one frame's pose rows (CPU), rounded as
    the per-frame program or (`replay`) the replay's scan program."""
    inst, cnt = tpipe.SENSORS[kind](T(data), rows[3:6], rows[6], rows[7],
                                    rows[8], rows[0].astype(np.int32),
                                    cfg=cfg_t, replay=replay)
    assert not cnt.any()
    return inst.numpy()


def linear(n, step=0.45, start=-1.2, z=1.0, yaw=0.3):
    """n poses moving +x (and a little +y) at a fixed heading."""
    q = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
    return [(np.asarray([start + step * i, 0.2 * i, z], np.float32), q)
            for i in range(n)]


def frames(kind, poses, world):
    """(measurements [K, ...], scalars) of the sensor at each pose."""
    projs = [tgeo.Projection.from_pose(*p) for p in poses]
    if kind == "depth":
        got = [world.depth_image(p, rows=40, cols=52) for p in projs]
    else:
        got = [world.multiscan(p, ring_num=16, scan_num=180, max_range=8.0)
               for p in projs]
    return np.stack([g[0] for g in got]), tuple(got[0][1:])


def _proj(pkg, pose):
    if pkg == "jax":
        return jgeo.Projection.from_pose(*pose)
    return tgeo.Projection.from_pose(*pose)


def process(m, kind, pkg, pose, data, sc):
    call = m.process_depth if kind == "depth" else m.process_multiscan
    return call(_proj(pkg, pose), data, *sc)


def process_batch(m, kind, pkg, poses, data, sc, chunk):
    call = (m.process_depth_batch if kind == "depth"
            else m.process_multiscan_batch)
    return call([_proj(pkg, p) for p in poses], data, *sc, chunk=chunk)


def assert_pair(jm, jo, tm, to, msg):
    """State, window outputs, map_ct and canvas origin of a JAX mapper and
    a port mapper (or two port mappers) are equal."""
    sa = ({f.name: np.asarray(getattr(jm.state, f.name))
           for f in dataclasses.fields(jm.state)}
          if isinstance(jm, JaxMapper) else state_to_numpy(jm.state))
    sb = state_to_numpy(tm.state)
    for k in FIELDS:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=f"{msg}: state {k}")
    for k in OUTPUTS:
        want = jo.device(k) if isinstance(jm, JaxMapper) else jo.raw[k]
        np.testing.assert_array_equal(np.asarray(to.raw[k]), np.asarray(want),
                                      err_msg=f"{msg}: output {k}")
    assert tm.map_ct == jm.map_ct, msg
    np.testing.assert_array_equal(tm._origin, jm._origin, err_msg=msg)


def check_online(kind, kw, poses, world):
    """Both mappers over the frames one by one, equal after every frame;
    returns the port's mapper and the canvas origins."""
    data, sc = frames(kind, poses, world)
    cj, ct = configs(kind, **kw)
    jm, tm = JaxMapper(cj), TorchMapper(ct, device="cpu")
    origins = []
    for i, p in enumerate(poses):
        jo = process(jm, kind, "jax", p, data[i], sc)
        to = process(tm, kind, "torch", p, data[i], sc)
        assert_pair(jm, jo, tm, to, f"{kind} frame {i}")
        origins.append(tuple(tm._origin))
    return tm, origins


def check_batch(kind, kw, poses, world, chunk, runs, head=1):
    """JAX's batch call, the port's and the port's frame loop over the same
    frames (`head` per-frame first): equal state, last outputs, counters
    and every run's per_frame scalars.  Returns the port's batch mapper."""
    data, sc = frames(kind, poses, world)
    cj, ct = configs(kind, **kw)
    ms = {"jax": JaxMapper(cj), "torch": TorchMapper(ct, device="cpu"),
          "loop": TorchMapper(ct, device="cpu")}
    outs = {}
    for name, m in ms.items():
        pkg = "jax" if name == "jax" else "torch"
        out = None
        for i in range(head if name != "loop" else len(poses)):
            out = process(m, kind, pkg, poses[i], data[i], sc)
        if name != "loop":
            out = process_batch(m, kind, pkg, poses[head:], data[head:], sc,
                                chunk)
        outs[name] = out
    assert_pair(ms["jax"], outs["jax"], ms["torch"], outs["torch"],
                f"{kind} batch vs JAX")
    assert_pair(ms["loop"], outs["loop"], ms["torch"], outs["torch"],
                f"{kind} batch vs the frame loop")
    tm, jm = ms["torch"], ms["jax"]
    assert (tm.replay_scanned_frames, tm.replay_scanned_scrolls) == \
        (jm.replay_scanned_frames, jm.replay_scanned_scrolls)
    assert tm.replay_scanned_frames > 0
    assert len(runs["torch"]) == len(runs["jax"]) > 0
    for r, (a, b) in enumerate(zip(runs["torch"], runs["jax"])):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"run {r} {k}")
    return tm


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


def check_golden(outs, path):
    ref = np.load(path)
    for i in (0, len(outs) - 1):
        for k in ("glb_type", "dist_sq", "coc"):
            np.testing.assert_array_equal(getattr(outs[i], k), ref[f"{i}/{k}"],
                                          err_msg=f"frame {i} {k}")


# ---------------------------------------------------------------------------
# the sensor model
# ---------------------------------------------------------------------------

WINDOWS = {"golden": cases.SMALL, "preset": {}}


@pytest.mark.parametrize("window", list(WINDOWS))
def test_pixel_geometry_matches_jax(window):
    """Forward distance and pixel indices, bitwise against a jitted copy
    of realsense_update's body (in a scan over packed pose rows, as the
    replay's scan program runs it: the port's replay rounding), at random
    tilted poses and the voxel-face pose."""
    cj, ct = configs("depth", **WINDOWS[window])
    rows, data = cases.poses("depth", ct.local_size, ct.voxel_width, n=3)
    rows = np.concatenate([rows, cases.face_pose(ct.local_size,
                                                 ct.voxel_width)[None]])
    data = np.concatenate([data, data[:1]])

    @jax.jit
    def scan(rows, data):
        def body(c, xs):
            pvt, _, _, rot, origin, s1, s2 = jpipe._unpack_pose(xs[0])
            glb, _ = jss._window_positions(pvt, cj.local_size, cj.voxel_width)
            loc = jgeo.Projection(rot, origin).g2l(glb)
            d = loc[..., 0]
            safe = jnp.where(jnp.abs(d) > 1e-6, d, 1e-6)
            px = jnp.floor(-loc[..., 1] * s1[0] / safe + s1[2] + 0.5)
            py = jnp.floor(-loc[..., 2] * s1[1] / safe + s2[0] + 0.5)
            return c, (d, px.astype(jnp.int32), py.astype(jnp.int32))
        return jax.lax.scan(body, 0, (rows, data))[1]

    want = [np.asarray(a) for a in scan(rows, data)]
    for k in range(len(rows)):
        prm = tss.CamParam(*(float(v) for v in rows[k, 7]),
                           float(rows[k, 8, 0]), T(data[k]))
        proj = tgeo.Projection(T(rows[k, 3:6].copy()), T(rows[k, 6].copy()))
        _, d, px, py = tss.pixel_geometry(proj, prm, rows[k, 0].astype(np.int32),
                                          ct.local_size, ct.voxel_width,
                                          replay=True)
        np.testing.assert_array_equal(d.numpy().view(np.int32),
                                      want[0][k].view(np.int32), err_msg=f"x {k}")
        np.testing.assert_array_equal(px.numpy(), want[1][k], err_msg=f"px {k}")
        np.testing.assert_array_equal(py.numpy(), want[2][k], err_msg=f"py {k}")


@pytest.mark.parametrize("valid_nan", [False, True])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_depth_model_matches_the_frame_program(window, valid_nan):
    """inst_type of realsense_update equals the JAX per-frame program's
    on every voxel, and with `replay` the JAX replay scan's: clean images
    and images with NaN, +Inf, 0 and 0.21 m pixels, at tilted poses and
    the voxel-face pose."""
    cj, ct = configs("depth", valid_nan=valid_nan, **WINDOWS[window])
    rows, data = cases.poses("depth", ct.local_size, ct.voxel_width, n=3,
                             seed=1)
    face = cases.face_pose(ct.local_size, ct.voxel_width)
    face[7], face[8, 0] = rows[0, 7], rows[0, 8, 0]
    rows = np.concatenate([rows, rows, face[None], face[None]])
    edge = np.stack([cases.edge_depth(d, seed=i) for i, d in enumerate(data)])
    flat = np.full_like(data[0], 2.0)
    data = np.concatenate([data, edge, flat[None],
                           cases.edge_depth(flat, seed=9)[None]])
    for replay, body in ((False, jax_frame_body), (True, jax_scan_body)):
        want = body("depth", cj, rows, data)
        for k in range(len(rows)):
            got = port_sensor("depth", ct, rows[k], data[k], replay)
            np.testing.assert_array_equal(got, want[k],
                                          err_msg=f"pose {k} replay={replay}")
    # the special pixels were seen: +Inf measured as free, NaN per policy
    assert (want == 1).any() and (want == 2).any()


def test_inf_pixel_is_free_never_occupied():
    """An +Inf pixel is a measurement on the JAX CPU path: free up to the
    6 m frustum and never occupied; a NaN pixel is unknown, or far (free)
    with valid_nan."""
    for valid_nan, fill, want_free in ((False, np.inf, True),
                                       (True, np.inf, True),
                                       (False, np.nan, False),
                                       (True, np.nan, True)):
        _, ct = configs("depth", valid_nan=valid_nan, **cases.SMALL)
        rows = cases.face_pose(ct.local_size, ct.voxel_width)
        rows[7], rows[8, 0] = (40.0, 40.0, 26.0), 20.0
        img = np.full((40, 52), fill, np.float32)
        inst = port_sensor("depth", ct, rows, img)
        assert not (inst == 2).any()
        assert (inst == 1).any() == want_free, (valid_nan, fill)


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

SMALL_MAP = dict(local_size_m=(5.0, 5.0, 2.0), voxel_width=0.2,
                 cutoff_dist=2.0, max_blocks=4096)


def _world():
    return BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)


@pytest.mark.parametrize("gate", [False, True])
def test_process_depth_matches_jax_every_frame(gate):
    """Online frames that scroll the depthcam-class canvas (one slack
    block; the change gate on with edt_gate_min_vox=0): state and outputs
    equal the JAX package's after every frame."""
    kw = dict(SMALL_MAP, edt_gate_min_vox=0 if gate else 256000)
    tm, origins = check_online("depth", kw, linear(7, step=0.7), _world())
    assert tm.cfg.canvas_slack_blocks == 1
    assert len(set(origins)) >= 2, origins  # the canvas scrolled


def test_depth_batch_matches_jax_and_the_frame_loop(runs):
    """process_depth_batch against JAX's batch call and the port's own
    frame loop: runs with scrolls, the ladder's shorter rung, the per-frame
    fallbacks, every run's per_frame."""
    tm = check_batch("depth", dict(SMALL_MAP, edt_gate_min_vox=0), linear(9),
                     _world(), chunk=4, runs=runs)
    assert tm.replay_scanned_scrolls >= 1


def test_golden_depth():
    """tests/golden_depth.npz (the JAX package's golden) reproduced by the
    port from the scenario of tests/test_golden.py."""
    cfg = tcfg.depthcam_config(local_size_m=(5.0, 5.0, 2.0), voxel_width=0.2,
                               cutoff_dist=2.0, max_blocks=4096)
    world = BoxWorld.corridor(seed=23, n_pillars=4, extent=3.0, height=2.0)
    m = TorchMapper(cfg, device="cpu")
    outs = []
    for proj in circular_trajectory(4, radius=1.0, height=1.0):
        depth, fx, fy, cx, cy = world.depth_image(proj, rows=40, cols=52)
        outs.append(m.process_depth(proj, depth, fx, fy, cx, cy))
    check_golden(outs, os.path.join(os.path.dirname(__file__),
                                    "golden_depth.npz"))


def test_depthcam_preset_constructs_on_the_cpu():
    m = TorchMapper(tcfg.depthcam_config(), device="cpu")
    assert m.cfg.canvas_size == (240, 240, 168)
    assert not tcfg.unported_options(m.cfg)
