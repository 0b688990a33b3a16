"""The PyTorch port's 2-D LiDAR map maker against the JAX package, bit for
bit: the generic envelope (kernel 5's plain version) against the JAX Pallas
kernel in interpret mode and the dense envelope; the Z == 1 EDT; the 2-D
LiDAR model and its intermediates (against a jitted copy of the JAX body);
the relax engine's three functions; and VolumetricMapper.process_scan2d
frame by frame, capacity warnings included, on the canvas engine, a true
2-D map on the relax engine and a 3-D relax map with fast_mode off, down to
the committed scan2D goldens."""
import dataclasses
import os
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import gie_mapping_tpu.ops.edt_batch as jeb
from gie_mapping_tpu.models.mapper import CapacityWarning as JaxCapacityWarning
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.ops import scan_sensors as jss
from gie_mapping_tpu.ops import wave as jwave
from gie_mapping_tpu.ops.pallas import envelope as jenv
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models.mapper import CapacityWarning
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.models.pipeline import _slab_menu
from gie_mapping_tpu_torch.ops import edt_batch as teb
from gie_mapping_tpu_torch.ops import scan_sensors as tss
from gie_mapping_tpu_torch.ops import wave as twave
from gie_mapping_tpu_torch.ops.kernels import envelope as tenv
from gie_mapping_tpu_torch.runtime.datasets import (BoxWorld,
                                                    circular_trajectory,
                                                    hokuyo_scan, scan2d_path,
                                                    scan2d_world,
                                                    yaw_then_translate)
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo

T = torch.from_numpy
BIG = 1 << 28
INV16 = 32767


@pytest.fixture
def interp(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode (on the CPU), as
    tests/test_envelope_pallas.py runs them."""
    orig = jenv.pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(jenv.pl, "pallas_call", patched)
    jenv._envelope_2d._clear_cache()
    yield
    jenv._envelope_2d._clear_cache()


def _costs(N, L, seed):
    """Site costs [N, L] with ties, cap-valued and site-free (BIG) entries,
    lanes without a site and lanes whose every site sits at the cap, and
    one payload per site."""
    rng = np.random.default_rng(seed)
    cap = (1 << (31 - tenv.env_idx_bits(N))) - 1
    f = rng.integers(0, 300, (N, L)).astype(np.int32)
    f[rng.random((N, L)) < 0.4] = BIG
    f[rng.random((N, L)) < 0.1] = cap
    f[:, 1::4] = np.where(rng.random((N, L // 4)) < 0.5, 5, BIG)  # ties
    f[:, ::9] = BIG
    f[:, 4::9] = cap
    pay = rng.integers(0, 1 << 30, (N, L)).astype(np.int32)
    return f, pay


@pytest.mark.parametrize("N", [1, 2, 100, 128, 152])
def test_envelope_matches_pallas_and_dense(interp, N):
    f, pay = _costs(N, 45, seed=N)
    key_t, pay_t = (a.numpy() for a in tenv.envelope(T(f), T(pay)))
    key_d, pay_d = (np.asarray(a) for a in jeb.lower_envelope(
        jnp.asarray(f), payloads=(jnp.asarray(pay),), packed_out=True))
    np.testing.assert_array_equal(key_t, key_d)
    np.testing.assert_array_equal(pay_t, pay_d)
    # the Pallas kernel on the lanes that meet its precondition (a sited
    # lane's best stays below the cap)
    key_k, pay_k = (np.asarray(a) for a in jenv.envelope_pallas(
        jnp.asarray(f), (jnp.asarray(pay),), packed_out=True))
    sited = (f < 300).any(0, keepdims=True) & np.ones_like(f, bool)
    assert sited.any() and not sited.all()
    np.testing.assert_array_equal(key_t[sited], key_k[sited])
    np.testing.assert_array_equal(pay_t[sited], pay_k[sited])
    # a [N, 3, 15] view of the same lanes gives the same result
    k3, p3 = tenv.envelope(T(f.reshape(N, 3, 15)), T(pay.reshape(N, 3, 15)))
    np.testing.assert_array_equal(k3.numpy().reshape(N, 45), key_t)
    np.testing.assert_array_equal(p3.numpy().reshape(N, 45), pay_t)


def _types(shape, frac, seed):
    rng = np.random.default_rng(seed)
    t = np.where(rng.random(shape) < frac, 2,
                 rng.integers(0, 2, shape)).astype(np.int8)
    return t


@pytest.mark.parametrize("shape,frac,seed", [((30, 40, 1), 0.05, 1),
                                             ((100, 100, 1), 0.01, 2),
                                             ((9, 1, 1), 0.3, 3),
                                             ((12, 17, 1), 0.0, 4)])
def test_batch_edt_2d_matches_jax_and_scipy(interp, shape, frac, seed):
    t = _types(shape, frac, seed)
    mw = sum(shape)
    got = teb.batch_edt(T(t), mw)
    for pallas in (False, True):
        want = jeb.batch_edt(jnp.asarray(t), max_width=mw, pallas=pallas)
        for k in ("dist_sq", "coc", "valid"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k} pallas={pallas}")
    occ = t == 2
    valid = got["valid"].numpy()
    if occ.any():
        ref = np.rint(ndimage.distance_transform_edt(~occ) ** 2)
        assert valid.all()
        np.testing.assert_array_equal(got["dist_sq"].numpy(),
                                      ref.astype(np.int32))
        c = got["coc"].numpy()
        assert occ[c[..., 0], c[..., 1], c[..., 2]].all()
    else:
        assert not valid.any()


@pytest.mark.parametrize("local", [(24, 24, 8), (40, 40, 1), (20, 20, 10),
                                   (100, 100, 1)])
def test_hokuyo_matches_jax(local):
    """inst_type bitwise over many poses, with NaN, <= 0.3 m and 30 m
    ranges, with for_motion_planner on and off."""
    world = scan2d_world()
    rng = np.random.default_rng(sum(local))
    seen = np.zeros(4, np.int64)
    for i in range(6):
        pos = np.float32([rng.uniform(-3, 3), rng.uniform(0.5, 1.5),
                          rng.uniform(0.8, 1.2)])
        yaw = rng.uniform(-np.pi, np.pi)
        pose = (pos, (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)))
        r, tmin, tinc = hokuyo_scan(world, pose)
        r = r.copy()
        r[rng.random(r.shape) < 0.05] = np.nan
        r[rng.random(r.shape) < 0.05] = 0.25
        r[rng.random(r.shape) < 0.05] = 0.3
        r[rng.random(r.shape) < 0.05] = 30.0
        pvt = jgeo.calculate_pivot(pos, 0.1, local)
        jp = jss.ScanParam(jnp.float32(tmin), jnp.float32(tinc), jnp.asarray(r))
        tp = tss.ScanParam(tmin, tinc, T(r))
        for fmp in (True, False):
            kw = dict(local_size=local, voxel_width=0.1, ogm_min_h=0.2,
                      ogm_max_h=10.0, for_motion_planner=fmp, robot_r2_grids=9)
            want = np.asarray(jss.hokuyo_update(
                jgeo.Projection.from_pose(*pose), jp, jnp.asarray(pvt), **kw))
            got = tss.hokuyo_update(tgeo.Projection.from_pose(*pose), tp, pvt,
                                    **kw).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"pose {i} {fmp}")
            seen += np.bincount(want.ravel(), minlength=4)
    assert seen[1] > 0 and seen[2] > 0  # FREE and OCCUPIED both occur


@partial(jax.jit, static_argnames=("local_size", "voxel_width"))
def _jax_beam_geometry(proj, param, pvt, *, local_size, voxel_width):
    """The JAX package's hokuyo_update body up to the beam lookup, returning
    its intermediates: the sensor-frame position, the beam index and the
    planar range; and its height test, which shares the voxel height
    c_z * w with the frame change as in hokuyo_update (XLA then rounds
    that product before subtracting the sensor's z)."""
    glb_pos, _ = jss._window_positions(pvt, local_size, voxel_width)
    hgt_ok = (glb_pos[..., 2] >= -10.0) & (glb_pos[..., 2] <= 10.0)
    local_pos = proj.g2l(glb_pos)
    theta = jnp.arctan2(local_pos[..., 1], local_pos[..., 0])
    theta_idx = jnp.floor((theta - param.theta_min) / param.theta_inc
                          + 0.5).astype(jnp.int32)
    theta_idx = jss._positive_mod(theta_idx, param.scan_num)
    planar = jnp.abs(local_pos[..., 2]) < voxel_width
    idea_depth = jnp.where(
        planar, jnp.sqrt(local_pos[..., 0] ** 2 + local_pos[..., 1] ** 2), -1.0)
    return local_pos, theta_idx, idea_depth, hgt_ok


def _tilted_pose(rng):
    """A pose with a random heading and a few degrees of roll and pitch (so
    every entry of the rotation is inexact)."""
    yaw = rng.uniform(-np.pi, np.pi)
    roll, pitch = rng.normal(0.0, 0.05, 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    quat = (cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy)
    pos = np.float32([rng.uniform(-3, 3), rng.uniform(0.5, 1.5),
                      rng.uniform(0.8, 1.2)])
    return pos, quat


# the two chip paths' windows, the test mappers' and two whose voxel count
# is not a multiple of 8 (XLA's dot rounds those last rows differently)
@pytest.mark.parametrize("local", [(100, 100, 30), (100, 100, 1), (20, 20, 10),
                                   (9, 7, 5), (21, 19, 1)])
def test_beam_geometry_matches_jax(local):
    """The sensor-frame position and the beam index bitwise against a jitted
    copy of the JAX body, over the scan2d path's first poses and tilted
    ones; the planar range to one ulp (the port takes XLA's fused form
    everywhere) and on the same voxels."""
    world = scan2d_world()
    rng = np.random.default_rng(sum(local))
    poses = scan2d_path()[3:5] + [_tilted_pose(rng) for _ in range(4)]
    # the sensor on a voxel centre whose height c_z * w rounds
    poses.append((np.float32([0.6, 0.0, 1.2]), (0.92388, 0.0, 0.0, 0.38268)))
    for i, pose in enumerate(poses):
        r, tmin, tinc = hokuyo_scan(world, pose)
        pvt = jgeo.calculate_pivot(pose[0], 0.1, local)
        want = [np.asarray(a) for a in _jax_beam_geometry(
            jgeo.Projection.from_pose(*pose),
            jss.ScanParam(jnp.float32(tmin), jnp.float32(tinc), jnp.asarray(r)),
            jnp.asarray(pvt), local_size=local, voxel_width=0.1)]
        _, pos, idx, rng_ = (a.numpy() for a in tss.beam_geometry(
            tgeo.Projection.from_pose(*pose), tss.ScanParam(tmin, tinc, T(r)),
            pvt, local, 0.1))
        np.testing.assert_array_equal(pos.view(np.int32),
                                      want[0].view(np.int32),
                                      err_msg=f"pose {i} position")
        np.testing.assert_array_equal(idx, want[1], err_msg=f"pose {i} beam")
        planar = want[2] >= 0
        np.testing.assert_array_equal(rng_ >= 0, planar)
        ulps = np.abs(rng_.view(np.int32).astype(np.int64)
                      - want[2].view(np.int32))
        assert planar.any() and ulps.max() <= 1, f"pose {i} range"


def _field(cs, frac, seed):
    """A consistent (dist, int16 coc) canvas field: the exact EDT of random
    sites, with a fifth of the voxels unseen."""
    rng = np.random.default_rng(seed + 1000)
    t = _types(cs, frac, seed)
    e = teb.batch_edt(T(t), sum(cs))
    dist = np.where(e["valid"].numpy(), e["dist_sq"].numpy(), 999_999)
    coc = np.where(e["valid"].numpy()[..., None], e["coc"].numpy(), INV16)
    unseen = rng.random(cs) < 0.2
    dist[unseen] = 999_999
    coc[unseen] = INV16
    return t, dist.astype(np.int32), coc.astype(np.int16)


CS, LS, OFF = (24, 24, 16), (16, 16, 8), (4, 3, 5)


def _win(a):
    return a[OFF[0]:OFF[0] + LS[0], OFF[1]:OFF[1] + LS[1], OFF[2]:OFF[2] + LS[2]]


def _masks(seed):
    rng = np.random.default_rng(seed)
    window = np.zeros(CS, bool)
    window[OFF[0]:OFF[0] + LS[0], OFF[1]:OFF[1] + LS[1], OFF[2]:OFF[2] + LS[2]] = True
    outside = (rng.random(CS) < 0.8) & ~window
    return window, outside


@pytest.mark.parametrize("seed", [0, 1])
def test_reconcile_window_matches_jax(seed):
    t, dist, coc = _field(CS, 0.01, seed)
    wt = _types(LS, 0.03, seed + 10)
    batch = teb.batch_edt(T(wt), sum(LS))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = jwave.reconcile_window(jb, jnp.asarray(_win(dist)),
                                  jnp.asarray(_win(coc)), jnp.asarray(wt),
                                  jnp.asarray(OFF, jnp.int32), LS)
    got = twave.reconcile_window(batch, T(_win(dist).copy()),
                                 T(_win(coc).copy()), T(wt), OFF, LS)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,max_sweeps", [(0, 40), (1, 40), (2, 4), (3, 0)])
def test_invalidate_disappeared_matches_jax(seed, max_sweeps):
    t, dist, coc = _field(CS, 0.01, seed)
    _, outside = _masks(seed)
    rng = np.random.default_rng(seed)
    dead = _win(t == 2) & (rng.random(LS) < 0.7)
    assert dead.any()
    want = jwave.invalidate_disappeared(
        jnp.asarray(dist), jnp.asarray(coc), jnp.asarray(outside),
        jnp.asarray(coc), jnp.asarray(dead), jnp.asarray(OFF, jnp.int32),
        max_sweeps=max_sweeps)
    got = twave.invalidate_disappeared(T(dist), T(coc), T(outside), T(coc),
                                       T(dead), OFF, max_sweeps=max_sweeps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if max_sweeps >= 40:
        assert got[2].sum() > dead.sum()  # the flood spread


@pytest.mark.parametrize("seed,fast,max_iters", [(0, True, 40), (1, False, 40),
                                                 (2, False, 8), (3, True, 8)])
def test_relax_fixed_point_matches_jax(seed, fast, max_iters):
    """From a canvas whose window was re-seeded by another site set: dist,
    coc and the sweep count equal the JAX package's."""
    _, dist, coc = _field(CS, 0.01, seed)
    wt = _types(LS, 0.02, seed + 20)
    batch = teb.batch_edt(T(wt), sum(LS))
    sd, sc = twave.reconcile_window(batch, T(_win(dist).copy()),
                                    T(_win(coc).copy()), T(wt), OFF, LS)
    _win(dist)[...] = sd.numpy()
    _win(coc)[...] = sc.numpy()
    window, outside = _masks(seed)
    can = window if fast else window | outside
    want = jwave.relax_fixed_point(
        jnp.asarray(dist), jnp.asarray(coc), jnp.asarray(can),
        jnp.asarray(outside), jnp.asarray(window), canvas_size=CS,
        cutoff_sq=25, max_iters=max_iters)
    got = twave.relax_fixed_point(T(dist), T(coc), T(can), T(outside),
                                  T(window), cutoff_sq=25, max_iters=max_iters)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < got[2] == int(want[2])


# small configs of the three engine paths of process_scan2d
SCAN_CONFIGS = {
    # the canvas engine, gated (edt_gate_min_vox=0 lets the gate engage);
    # it never sweeps, so even a sweep cap of 0 must not warn
    "canvas": dict(local_size_m=(3.2, 3.2, 1.6), max_blocks=4096,
                   edt_gate_min_vox=0, max_relax_iters=0),
    # a true 2-D map on the relax engine, with a sweep cap that some frames
    # reach (the capacity monitor's sweep-cap warning)
    "flat_relax": dict(local_size_m=(4.0, 4.0, 0.1), max_blocks=4096,
                       merge_mode="relax", max_relax_iters=16),
    # a 3-D relax map with fast_mode off: the raise wave runs
    "relax_3d": dict(local_size_m=(3.2, 3.2, 0.8), voxel_width=0.2,
                     cutoff_dist=1.0, max_blocks=4096, merge_mode="relax",
                     fast_mode=False),
}
OUTPUTS = ("edt", "glb_type", "dist_sq", "coc", "relax_iters", "gate_level",
           "gate_slab_vox", "fnt_count", "arch_dropped")


def _with_cap_warnings(category, fn):
    """fn()'s result and the capacity warnings it raised."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in seen if issubclass(w.category, category)]


def _jax_state(m):
    return {f.name: np.asarray(getattr(m.state, f.name))
            for f in dataclasses.fields(m.state)}


@pytest.mark.parametrize("name", sorted(SCAN_CONFIGS))
def test_process_scan2d_bitwise_every_frame(name):
    kw = SCAN_CONFIGS[name]
    jm = JaxMapper(jcfg.scan2d_config(**kw))
    tm = TorchMapper(tcfg.scan2d_config(**kw), device="cpu")
    world = scan2d_world()
    # the 3-D relax canvas has more scroll slack: one more step to scroll
    n_move = 4 if name == "relax_3d" else 3
    poses = yaw_then_translate(n_yaw=3, n_move=n_move, start=(-3.0, 1.0, 1.0),
                               yaw_step=np.pi, step_x=0.6)
    iters, levels, warned, shifts = [], [], [], 0
    for i, pose in enumerate(poses):
        r, tmin, tinc = hokuyo_scan(world, pose)
        if name == "relax_3d" and i == 4:
            r = np.full_like(r, np.nan)  # obstacles vanish: raise wave
            r[::3] = 8.0
        before = tm._origin
        jo, jw = _with_cap_warnings(JaxCapacityWarning, lambda: jm.process_scan2d(
            jgeo.Projection.from_pose(*pose), r, tmin, tinc).fetch())
        to, tw = _with_cap_warnings(CapacityWarning, lambda: tm.process_scan2d(
            tgeo.Projection.from_pose(*pose), r, tmin, tinc))
        # each package reports a frame's capacity check at the next frame
        assert tw == jw, f"frame {i} warnings"
        warned.append(bool(tw))
        js, ts = _jax_state(jm), state_to_numpy(tm.state)
        for k in FIELDS:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=f"frame {i} state {k}")
        for k in OUTPUTS:
            np.testing.assert_array_equal(np.asarray(getattr(to, k)),
                                          np.asarray(getattr(jo, k)),
                                          err_msg=f"frame {i} output {k}")
        for k in ("changed_blk", "ogm_changed"):
            np.testing.assert_array_equal(getattr(to, k), np.asarray(jo.device(k)),
                                          err_msg=f"frame {i} {k}")
        np.testing.assert_array_equal(tm._origin, jm._origin)
        shifts += before is not None and not np.array_equal(before, tm._origin)
        iters.append(to.relax_iters)
        levels.append(to.gate_level)
        assert (to.glb_type == 2).any()
    _, jw = _with_cap_warnings(JaxCapacityWarning, jm.check_capacity)
    _, tw = _with_cap_warnings(CapacityWarning, tm.check_capacity)
    assert tw == jw
    warned = warned[1:] + [bool(tw)]
    assert shifts >= 1
    if name == "canvas":
        assert set(iters) == {0} and not any(warned)
        n_menu = len(_slab_menu(tm.cfg.canvas_size))
        assert min(levels) < n_menu <= max(levels), levels
    else:
        assert min(iters) > 0 and set(levels) == {-1}
        assert warned == [i >= tm.cfg.relax_iters for i in iters]
    if name == "flat_relax":
        assert min(iters) < tm.cfg.relax_iters <= max(iters), iters


GOLDENS = {
    "golden_scan2d.npz": {},
    "golden_scan2d_relax.npz": dict(merge_mode="relax", fast_mode=False),
}


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_golden_scan2d(golden):
    """tests/test_golden.py's scan2D scenarios (canvas engine, and the
    relax engine with fast_mode off): frames 0 and 4 match the goldens."""
    cfg = tcfg.scan2d_config(local_size_m=(6.0, 6.0, 1.2), voxel_width=0.2,
                             cutoff_dist=3.0, max_blocks=4096,
                             **GOLDENS[golden])
    world = BoxWorld.corridor(seed=42, n_pillars=5, extent=4.0)
    ref = np.load(os.path.join(os.path.dirname(__file__), golden))
    tm = TorchMapper(cfg, device="cpu")
    for i, proj in enumerate(circular_trajectory(5, radius=1.2, height=0.7)):
        r, tmin, tinc = world.scan_2d(proj, n_beams=240)
        out = tm.process_scan2d(proj, r, tmin, tinc)
        if i in (0, 4):
            for k in ("glb_type", "dist_sq", "coc"):
                np.testing.assert_array_equal(getattr(out, k), ref[f"{i}/{k}"],
                                              err_msg=f"frame {i} {k}")
