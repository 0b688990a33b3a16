"""The PyTorch port's multi-ring LiDAR map maker (ops/scan_sensors.py::
vlp16_update, pipeline.multiscan_sensor, VolumetricMapper.process_multiscan
and process_multiscan_batch) against the JAX package, bit for bit, and
glibc's sinf / cosf (utils/floats.py) against the C library itself.

The model's bins, horizontal range and distance to the beam axis are held
against a jitted copy of the JAX model's body, and its inst_type against a
jitted scan of the JAX frame program's `_fused_sensor("multiscan")`, at the
goldens' 25 x 25 x 10 window and at the laser3D preset's 80 x 80 x 10
window.  The mapper runs online frames that scroll, a replay against JAX's
batch call and the port's own frame loop, and the JAX golden."""
import ctypes
import ctypes.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models import pipeline as jpipe
from gie_mapping_tpu.ops import scan_sensors as jss
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.ops import scan_sensors as tss
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld, circular_trajectory
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
from gie_mapping_tpu_torch.utils.floats import cosf_exact, sinf_exact
from test_torch_depth import (SMALL_MAP, WINDOWS, check_batch, check_golden,
                              check_online, configs, jax_frame_body,
                              jax_scan_body, linear, port_sensor,
                              runs)  # noqa: F401 (fixture)
import test_torch_sensor_cases as cases

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for the port's many small operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# sinf / cosf
# ---------------------------------------------------------------------------

def _libm(name):
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return np.vectorize(lambda v: fn(float(v)), otypes=[np.float32])


def _neighbours(values, n):
    """Each float32 value and its n float32 neighbours on each side."""
    v = np.asarray(values, np.float32)
    out = [v]
    up, dn = v.copy(), v.copy()
    for _ in range(n):
        up = np.nextafter(up, np.float32(np.inf))
        dn = np.nextafter(dn, np.float32(-np.inf))
        out += [up, dn]
    return np.concatenate(out)


def sincos_inputs():
    """2^20 float32 values spread over [-pi, pi], and the edges: +-0, tiny
    normal values, the quadrant edges (multiples of pi/4: reduce_fast's
    rounding boundaries), |x| = 0.75 (where the reduction starts) and
    2^-12 (below it the C library returns x or 1), with their neighbours;
    no subnormal."""
    rng = np.random.default_rng(0)
    spread = rng.uniform(-math.pi, math.pi, 1 << 20).astype(np.float32)
    edges = np.float32([0.0, -0.0, 1.2e-38, -1.2e-38, 1e-30, 3e-20, -7e-10])
    marks = np.float32(np.arange(-4, 5) * math.pi / 4)
    marks = np.concatenate([marks, np.float32([0.75, -0.75, 2.0 ** -12,
                                               -2.0 ** -12])])
    v = np.concatenate([spread, edges, _neighbours(marks, 64)])
    return v[np.abs(v) <= np.float32(math.pi)]


@pytest.mark.parametrize("name", ["sinf", "cosf"])
def test_sinf_cosf_match_the_c_library(name):
    """sinf_exact / cosf_exact equal the C library's (glibc's) sinf / cosf
    bit for bit on every input; torch.sin does not."""
    v = sincos_inputs()
    assert len(v) > 1 << 20
    want = _libm(name)(v)
    got = (sinf_exact if name == "sinf" else cosf_exact)(T(v)).numpy()
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), (v[bad][:5], got[bad][:5], want[bad][:5])
    torch_fn = torch.sin if name == "sinf" else torch.cos
    assert (torch_fn(T(v)).numpy().view(np.int32) != want.view(np.int32)).any()


def test_sinf_cosf_match_xla():
    """The JAX package's sin and cos inside a jitted program are the same
    values (XLA's CPU sin and cos call the C library)."""
    v = sincos_inputs()[:1 << 16]
    js, jc = jax.jit(lambda a: (jnp.sin(a), jnp.cos(a)))(v)
    np.testing.assert_array_equal(sinf_exact(T(v)).numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(cosf_exact(T(v)).numpy().view(np.int32),
                                  np.asarray(jc).view(np.int32))


# ---------------------------------------------------------------------------
# the sensor model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", list(WINDOWS))
def test_ring_geometry_matches_jax(window):
    """Azimuth and elevation bins, horizontal range and distance to the
    beam axis, bitwise against a jitted copy of vlp16_update's body (in a
    scan over packed pose rows, as the replay's scan program runs it: the
    port's replay rounding), at random tilted poses and the voxel-face
    pose."""
    cj, ct = configs("multiscan", **WINDOWS[window])
    rows, data = cases.poses("multiscan", ct.local_size, ct.voxel_width, n=3)
    face = cases.face_pose(ct.local_size, ct.voxel_width)
    face[7], face[8, 0] = rows[0, 7], rows[0, 8, 0]
    rows = np.concatenate([rows, face[None]])
    data = np.concatenate([data, data[:1]])
    n_ring, n_scan = data.shape[1:]

    @jax.jit
    def scan(rows, data):
        def body(c, xs):
            pvt, _, _, rot, origin, s1, s2 = jpipe._unpack_pose(xs[0])
            glb, _ = jss._window_positions(pvt, cj.local_size, cj.voxel_width)
            loc = jgeo.Projection(rot, origin).g2l(glb)
            lx, ly, lz = loc[..., 0], loc[..., 1], loc[..., 2]
            theta = jnp.arctan2(ly, lx)
            ti = jnp.floor((theta - s1[0]) / s1[1] + 0.5).astype(jnp.int32)
            ti = jss._positive_mod(ti, n_scan)
            rh = jnp.sqrt(lx * lx + ly * ly)
            phi = jnp.arctan2(lz, rh)
            pi_ = jnp.floor((phi - s1[2]) / s2[0] + 0.5).astype(jnp.int32)
            uz, uxy = jnp.sin(phi), jnp.cos(phi)
            ux, uy = uxy * jnp.cos(theta), uxy * jnp.sin(theta)
            cxv = uz * ly - uy * lz
            cyv = ux * lz - uz * lx
            czv = uy * lx - ux * ly
            d2r = jnp.sqrt(cxv * cxv + cyv * cyv + czv * czv)
            return c, (ti, pi_, rh, d2r)
        return jax.lax.scan(body, 0, (rows, data))[1]

    want = [np.asarray(a) for a in scan(rows, data)]
    for k in range(len(rows)):
        prm = tss.MulScanParam(*(float(v) for v in rows[k, 7]),
                               float(rows[k, 8, 0]), T(data[k]))
        proj = tgeo.Projection(T(rows[k, 3:6].copy()), T(rows[k, 6].copy()))
        _, ti, pi_, rh, d2r = tss.ring_geometry(
            proj, prm, rows[k, 0].astype(np.int32), ct.local_size,
            ct.voxel_width, replay=True)
        np.testing.assert_array_equal(ti.numpy(), want[0][k], err_msg=f"theta {k}")
        np.testing.assert_array_equal(pi_.numpy(), want[1][k], err_msg=f"phi {k}")
        np.testing.assert_array_equal(rh.numpy().view(np.int32),
                                      want[2][k].view(np.int32),
                                      err_msg=f"range {k}")
        np.testing.assert_array_equal(d2r.numpy().view(np.int32),
                                      want[3][k].view(np.int32),
                                      err_msg=f"dist2ray {k}")


@pytest.mark.parametrize("window", list(WINDOWS))
def test_multiscan_model_matches_the_frame_program(window):
    """inst_type of vlp16_update equals the JAX per-frame program's on
    every voxel, and with `replay` the JAX replay scan's, at tilted poses,
    the voxel-face pose, and with NaN ranges."""
    cj, ct = configs("multiscan", **WINDOWS[window])
    rows, data = cases.poses("multiscan", ct.local_size, ct.voxel_width, n=4,
                             seed=2)
    face = cases.face_pose(ct.local_size, ct.voxel_width)
    face[7], face[8, 0] = rows[0, 7], rows[0, 8, 0]
    rows = np.concatenate([rows, face[None]])
    holes = data[1].copy()
    holes[:, ::3] = np.nan
    data = np.concatenate([data, holes[None]])
    for replay, body in ((False, jax_frame_body), (True, jax_scan_body)):
        want = body("multiscan", cj, rows, data)
        for k in range(len(rows)):
            got = port_sensor("multiscan", ct, rows[k], data[k], replay)
            np.testing.assert_array_equal(got, want[k],
                                          err_msg=f"pose {k} replay={replay}")
    assert (want == 1).any() and (want == 2).any()


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

def _world():
    return BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)


def test_process_multiscan_matches_jax_every_frame():
    """Online frames that scroll the canvas (the laser3D preset's
    fast_mode and for_motion_planner): state and outputs equal the JAX
    package's after every frame."""
    kw = dict(SMALL_MAP, display_glb_ogm=False, display_glb_edt=False)
    tm, origins = check_online("multiscan", kw, linear(7, step=0.7), _world())
    assert tm.cfg.fast_mode and tm.cfg.for_motion_planner
    assert len(set(origins)) >= 2, origins


def test_multiscan_batch_matches_jax_and_the_frame_loop(runs):
    """process_multiscan_batch against JAX's batch call and the port's own
    frame loop, with streaming on (the preset's default): state, outputs,
    counters, every run's per_frame and the host mirror."""
    tm = check_batch("multiscan", dict(SMALL_MAP, edt_gate_min_vox=0),
                     linear(9), _world(), chunk=4, runs=runs)
    assert tm.replay_scanned_scrolls >= 1
    assert tm.mirror is not None and len(tm.mirror) > 0


def test_golden_multiscan():
    """tests/golden_multiscan.npz (the JAX package's golden) reproduced by
    the port from the scenario of tests/test_golden.py."""
    cfg = tcfg.uav_laser3d_config(local_size_m=(5.0, 5.0, 2.0),
                                  voxel_width=0.2, cutoff_dist=2.0,
                                  max_blocks=4096)
    world = BoxWorld.corridor(seed=29, n_pillars=4, extent=3.0, height=2.0)
    m = TorchMapper(cfg, device="cpu")
    outs = []
    for proj in circular_trajectory(4, radius=1.0, height=1.0):
        rings, tmin, tinc, pmin, pinc = world.multiscan(
            proj, ring_num=16, scan_num=180, max_range=8.0)
        outs.append(m.process_multiscan(proj, rings, tmin, tinc, pmin, pinc))
    check_golden(outs, os.path.join(os.path.dirname(__file__),
                                    "golden_multiscan.npz"))


def test_laser3d_preset_constructs_on_the_cpu():
    m = TorchMapper(tcfg.uav_laser3d_config(), device="cpu")
    assert m.cfg.canvas_size == (112, 112, 40)
    assert not tcfg.unported_options(m.cfg)
