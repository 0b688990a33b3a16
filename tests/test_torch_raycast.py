"""The PyTorch port's projective point-cloud sensor model against the JAX
package, bit for bit: the float helpers that decide panorama bins, the
whole `pointcloud_project` (JAX on its CPU gather branch), and the carve's
plain version against the Pallas `panorama_select` in interpret mode."""
import warnings
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu.ops import raycast as jrc
from gie_mapping_tpu.ops.pallas import carve as jcarve
from gie_mapping_tpu.runtime.datasets import BoxWorld
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.ops import raycast as trc
from gie_mapping_tpu_torch.ops.kernels import carve as tcarve
from gie_mapping_tpu_torch.utils import geometry as tgeo

T = torch.from_numpy


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_atan2f_exact_matches_jax():
    rng = np.random.default_rng(0)
    n = 1 << 18
    y = (rng.normal(size=n) * 4).astype(np.float32)
    x = (rng.normal(size=n) * 4).astype(np.float32)
    y[: n // 4] = rng.uniform(-2, 2, n // 4)      # the phi domain
    x[: n // 4] = rng.uniform(0.05, 10, n // 4)
    # special values with normal operands and results: the XLA CPU flushes
    # subnormals to zero, IEEE (and the port) does not; the carve's operands
    # and results are never subnormal
    special = np.asarray([0.0, -0.0, 1.0, -1.0, 1e-10, -1e-10, 1e10, 3e-37,
                          0.4375, 0.6875, 1.1875, 2.4375], np.float32)
    yy, xx = np.meshgrid(special, special)
    y = np.concatenate([y, yy.ravel()])
    x = np.concatenate([x, xx.ravel()])
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = tcarve.atan2f_exact(T(y), T(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(1)
    a = rng.normal(size=3000).astype(np.float32)
    b = rng.normal(size=3000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)  # heavy cancellation
    c[::2] = rng.normal(size=1500).astype(np.float32)
    # a*b exactly halfway between two floats of c's binade, plus a sliver
    a[:4] = np.float32(1 + 2 ** -12)
    b[:4] = np.float32(1 + 2 ** -12)
    c[:4] = np.float32([1.0, -1.0, 2.0, 3.0])
    got = tcarve.fma_f32(T(a), T(b), T(c)).numpy()
    want = np.asarray([np.float32(float(Fraction(float(p)) * Fraction(float(q))
                                        + Fraction(float(r))))
                       for p, q, r in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sqrt_f32_is_correctly_rounded(monkeypatch):
    """sqrt_f32 rounds correctly where it is hardest, roots a hair from a
    float32 midpoint, and stays right when the float64 root it starts from
    is off (as PyTorch's CPU float64 sqrt has been seen to be)."""
    rng = np.random.default_rng(4)
    r = rng.uniform(0.01, 100, 1 << 17).astype(np.float32)
    mid = (r.astype(np.float64) + np.nextafter(r, np.float32(np.inf))) / 2
    a = np.concatenate([(mid * mid).astype(np.float32),
                        rng.uniform(0, 1e4, 1 << 15).astype(np.float32),
                        np.asarray([0.0, -0.0, 1e-45, 1e-40, 1.0, np.inf,
                                    3.4e38], np.float32)])
    want = np.sqrt(a)  # IEEE: correctly rounded
    np.testing.assert_array_equal(_bits(tcarve.sqrt_f32(T(a)).numpy()), _bits(want))
    exact = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda t: exact(t) * (1 + 3e-11))
    np.testing.assert_array_equal(_bits(tcarve.sqrt_f32(T(a)).numpy()), _bits(want))


def _fma_model(a, b, c):
    """float32 a*b + c with one rounding, in numpy: the product is exact in
    float64; the float64 sum's exact error (TwoSum) settles the one case
    where rounding that sum to float32 could differ, a sum exactly halfway
    between two floats."""
    p = a.astype(np.float64) * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.astype(np.float32)
    up = np.nextafter(f, np.float32(np.inf))
    dn = np.nextafter(f, np.float32(-np.inf))
    half_up = s == (f.astype(np.float64) + up) / 2
    half_dn = s == (f.astype(np.float64) + dn) / 2
    return np.where(half_up & (err > 0), up, np.where(half_dn & (err < 0), dn, f))


def _xla_fuses_multiply_add():
    """Whether XLA's CPU code, in this process, contracts a jitted a*b + c
    into a fused multiply-add: on operands where the two roundings differ
    (1 + 2^-12 squared, minus 1), the count of elements of each."""
    a = np.full(1024, 1 + 2 ** -12, np.float32)
    got = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, a, -np.ones_like(a)))
    fused = int((got == np.float32(2 ** -11 + 2 ** -24)).sum())
    return fused == got.size, fused, int((got == np.float32(2 ** -11)).sum())


def test_norms_match_jax_fusion():
    """norm3_f32 and hypot2_f32 round as XLA's CPU fusion does, with fused
    multiply-adds: bitwise against a numpy model of that rounding, and
    against XLA's own jitted norm where XLA fuses in this process (it does
    not when its CPU target lacks FMA, e.g. under
    XLA_FLAGS=--xla_cpu_max_isa=AVX; the committed fixtures and
    pointcloud_project's bins were made with the fused rounding)."""
    rng = np.random.default_rng(2)
    v = (rng.normal(size=(1 << 16, 3)) * 3).astype(np.float32)
    x, y, z = v[:, 0].copy(), v[:, 1].copy(), v[:, 2].copy()
    norm = np.sqrt(_fma_model(z, z, _fma_model(y, y, x * x)))
    hyp = np.sqrt(_fma_model(x, x, y * y))
    got_n = tcarve.norm3_f32(T(v)).numpy()
    got_h = tcarve.hypot2_f32(T(x), T(y)).numpy()
    np.testing.assert_array_equal(_bits(got_n), _bits(norm))
    np.testing.assert_array_equal(_bits(got_h), _bits(hyp))
    # the model is the fused form: the unfused one differs from it
    assert (_bits(np.sqrt(x * x + y * y)) != _bits(hyp)).sum() > 1000
    fuses, n_fused, n_unfused = _xla_fuses_multiply_add()
    if not fuses:
        warnings.warn(f"XLA's CPU code does not fuse a*b + c in this process "
                      f"({n_fused} of 1024 probe elements fused, {n_unfused} "
                      f"unfused): its jitted norm is not compared")
        return
    jn = np.asarray(jax.jit(lambda a: jnp.linalg.norm(a, axis=-1))(v))
    jh = np.asarray(jax.jit(lambda a: jnp.sqrt(a[:, 0] ** 2 + a[:, 1] ** 2))(v))
    np.testing.assert_array_equal(_bits(got_n), _bits(jn))
    np.testing.assert_array_equal(_bits(got_h), _bits(jh))


def test_l2g_matches_jax_eager():
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(1 << 16, 3)) * 4).astype(np.float32)
    pose = (np.asarray([0.31, -1.7, 1.2], np.float32), (0.9, 0.1, 0.2, 0.3))
    want = np.asarray(jgeo.Projection.from_pose(*pose).l2g(jnp.asarray(pts)))
    got = tgeo.Projection.from_pose(*pose).l2g(T(pts)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _scene(local_size, pos, yaw, n_rays, seed):
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    quat = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
    jp = jgeo.Projection.from_pose(np.asarray(pos, np.float32), quat)
    pts = world.pointcloud(jp, n_rays=n_rays, max_range=8.0, seed=seed)
    world_pts = np.array(jp.l2g(jnp.asarray(pts)))
    valid = np.ones(len(world_pts), bool)
    valid[::37] = False
    origin = np.asarray(pos, np.float32)
    pvt = jgeo.calculate_pivot(origin, 0.1, local_size)
    return world_pts, valid, origin, pvt


CASES = [((40, 40, 16), (0.0, 0.0, 1.2), 0.0, 4096, False),
         ((40, 40, 16), (0.37, -0.81, 1.13), 0.7, 4096, True),
         ((100, 100, 30), (-1.05, 0.55, 0.9), 2.1, 16384, False)]


def _kw(local_size, fmp):
    nt, np_ = jrc.panorama_bins(local_size)
    return dict(local_size=local_size, voxel_width=0.1, ogm_min_h=0.0,
                ogm_max_h=2.5, for_motion_planner=fmp, robot_r2_grids=16,
                n_theta=nt, n_phi=np_)


@pytest.mark.parametrize("local_size,pos,yaw,n_rays,fmp", CASES)
def test_pointcloud_project_matches_jax(local_size, pos, yaw, n_rays, fmp):
    pts, valid, origin, pvt = _scene(local_size, pos, yaw, n_rays, seed=5)
    kw = _kw(local_size, fmp)
    ji, jc = jrc.pointcloud_project(jnp.asarray(pts), jnp.asarray(valid),
                                    jnp.asarray(origin), jnp.asarray(pvt),
                                    pallas=False, **kw)
    ti, tc = trc.pointcloud_project(T(pts), T(valid), origin, pvt, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() > 0).any() and (tc.numpy() < 0).any()


def test_carve_lookup_matches_panorama_select():
    """The Pallas lookup of the JAX sensor model (interpret mode) reads the
    same panorama entries as the port's carve, for the port's bins; the bins
    themselves are held by test_pointcloud_project_matches_jax."""
    local_size, pos, yaw, n_rays, fmp = CASES[1]
    pts, valid, origin, pvt = _scene(local_size, pos, yaw, n_rays, seed=6)
    kw = _kw(local_size, fmp)
    nt, np_ = kw["n_theta"], kw["n_phi"]
    depth, cnt, ep = tcarve.panorama(T(pts), T(valid), origin, pvt,
                                     local_size=local_size, voxel_width=0.1,
                                     ogm_min_h=0.0, ogm_max_h=2.5, n_theta=nt,
                                     n_phi=np_)
    vr, vbt, vbp = tcarve.voxel_bins(pvt, origin, local_size=local_size,
                                     voxel_width=0.1, n_theta=nt, n_phi=np_)
    assert (vbt == vbt[:, :, :1]).all()  # theta depends on the column only
    vd, vc = jcarve.panorama_select(
        jnp.asarray(depth.numpy()), jnp.asarray(cnt.numpy()),
        jnp.asarray(vbt[:, :, 0].numpy()), jnp.asarray(vbp.numpy()),
        interpret=True)
    idx = (vbt * np_ + vbp).long()
    np.testing.assert_array_equal(np.asarray(vd), depth.reshape(-1)[idx].numpy())
    np.testing.assert_array_equal(np.asarray(vc), cnt.reshape(-1)[idx].numpy())
    # and the carve's own result equals the JAX sensor model's
    ti, tc = tcarve.carve(depth, cnt, ep, pvt, origin, local_size=local_size,
                          voxel_width=0.1, n_theta=nt, n_phi=np_,
                          for_motion_planner=fmp, robot_r2_grids=16)
    ji, jc = jrc.pointcloud_project(jnp.asarray(pts), jnp.asarray(valid),
                                    jnp.asarray(origin), jnp.asarray(pvt),
                                    pallas=False, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("name", ["edges_40", "cloud_40", "ugv_200"])
def test_panorama_endpoints_match_jax_jit(name):
    """The endpoint voxel rounds as the JAX package's jitted sensor model
    rounds it: XLA folds p / voxel_width (a compile-time constant there)
    into a multiply by the float32 reciprocal and contracts it with the
    + 0.5, floor(fma(p, 1/w, 0.5)); an IEEE division differs on voxel
    faces (the edges case holds 1,000 of them)."""
    from test_torch_carve_cases import points

    c = points(name)
    kw = dict(local_size=c["local_size"], voxel_width=c["voxel_width"],
              ogm_min_h=c["ogm_min_h"], ogm_max_h=c["ogm_max_h"],
              n_theta=c["n_theta"], n_phi=c["n_phi"])
    ji, jc = jrc.pointcloud_project(
        jnp.asarray(c["points"]), jnp.asarray(c["valid"]),
        jnp.asarray(c["origin"]), jnp.asarray(c["pvt"]), pallas=False,
        for_motion_planner=False, robot_r2_grids=16, **kw)
    ti, tc = trc.pointcloud_project(T(c["points"]), T(c["valid"]), c["origin"],
                                    c["pvt"], for_motion_planner=False,
                                    robot_r2_grids=16, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the rule matters here: an IEEE division moves some faces' points
    w = np.float32(c["voxel_width"])
    p = c["points"]
    ieee = np.floor(p / w + np.float32(0.5))
    folded = np.asarray(jax.jit(lambda q: jgeo.pos2coord(q, c["voxel_width"]))(p))
    np.testing.assert_array_equal(tgeo.pos2coord(T(p), c["voxel_width"]).numpy(),
                                  folded)
    if name == "edges_40":
        assert (ieee != folded).any()


def test_division_by_a_constant_matches_xla_folding():
    """pipeline.merge_frame's free-ray probability, min(1, -count / 10):
    inside the JAX frame program XLA multiplies by float32(0.1) instead of
    dividing (9 rays give 0.90000004, not 0.9), and the port does the
    same."""
    from gie_mapping_tpu_torch.utils.floats import div_const

    counts = np.arange(-40, 1, dtype=np.int32)
    want = np.asarray(jax.jit(lambda rc: jnp.minimum(
        1.0, (-rc).astype(jnp.float32) / 10.0))(counts))
    got = torch.clamp(div_const((-T(counts)).float(), 10.0), max=1.0).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert want[counts == -9][0] == np.float32(0.9) + np.spacing(np.float32(0.9))
