"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA card and skip without one.  This file imports no
JAX, so on a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch import map_state as ms
from gie_mapping_tpu_torch.ops import edt_batch as eb
from gie_mapping_tpu_torch.ops import raycast as rc
from gie_mapping_tpu_torch.ops.kernels import blockrows as kbr
from gie_mapping_tpu_torch.ops.kernels import carve as kc
from gie_mapping_tpu_torch.ops.kernels import envelope as ke
from gie_mapping_tpu_torch.ops.kernels import phase1 as kp
from gie_mapping_tpu_torch.ops.kernels import shift as ksh
from gie_mapping_tpu_torch.utils.config import cow_lady_config
from test_torch_carve_cases import POINTS as CARVE_POINTS
from test_torch_carve_cases import WINDOWS as CARVE_WINDOWS
from test_torch_carve_cases import points as carve_points
from test_torch_carve_cases import tables as carve_tables
from test_torch_carve_cases import window as carve_window
from test_torch_envelope_cases import CASES as ENVELOPE_CASES
from test_torch_envelope_cases import MID_CASES, mid_case
from test_torch_envelope_cases import case as envelope_case
from test_torch_phase1_cases import CASES as PHASE1_CASES
from test_torch_phase1_cases import case as phase1_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _types(shape, frac, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.where(rng.random(shape) < frac, 2,
                                     rng.integers(0, 2, shape)).astype(np.int8))


@pytest.mark.parametrize("shape", [(152, 152, 80), (9, 33, 7)])
def test_phase1_kernel_matches_plain(dev, shape):
    t = _types(shape, 0.03, 1).to(dev)
    got = kp.phase1_packed(t, sum(shape))
    assert torch.equal(got, kp.phase1_packed_plain(t, sum(shape)))


@pytest.mark.parametrize("name", PHASE1_CASES)
def test_phase1_kernel_every_voxel(dev, name):
    """The kernel on the edge cases its CPU model is held on (Y across the
    word boundaries up to 1024, empty and full columns, ties, max_width
    below Y, Z from 1 to 80)."""
    t, mw = phase1_case(name)
    t = torch.from_numpy(t).to(dev)
    assert torch.equal(kp.phase1_packed(t, mw), kp.phase1_packed_plain(t, mw))


@pytest.mark.parametrize("shape,tile_z", [
    ((3, 33, 1), 1), ((3, 33, 2), 2), ((5, 40, 3), 4), ((5, 40, 5), 8),
    ((96, 152, 80), 8), ((152, 152, 80), 16)])
def test_phase1_kernel_at_every_tile_width(dev, shape, tile_z):
    """Shapes at which the wrapper picks each width the kernel takes (the
    last two on a card of at most 1,520 resident 8-column CTAs, such as the
    H100: the driver's occupancy times the SMs)."""
    wave = kp.phase1_wave(dev.index or 0)
    assert 0 < wave // torch.cuda.get_device_properties(dev).multi_processor_count <= 8
    if shape[0] == 152:
        assert wave < 1520
    assert kp.phase1_tile(shape[0], shape[2], wave) == tile_z
    t = _types(shape, 0.03, 11).to(dev)
    mw = sum(shape)
    assert torch.equal(kp.phase1_packed(t, mw), kp.phase1_packed_plain(t, mw))


def test_phase1_kernel_slab_write(dev):
    """The p1-cache patch: x-slabs written in place into a larger buffer
    equal the whole canvas's result there, and no other word changes."""
    t = _types((152, 152, 80), 0.03, 8).to(dev)
    mw = 384
    full = kp.phase1_packed_plain(t, mw)
    for o, fx in ((0, 32), (40, 48), (88, 64), (56, 96), (151, 1)):
        buf = torch.full_like(full, -5)
        kp.phase1_packed(t[o:o + fx], mw, out=buf[o:o + fx])
        assert torch.equal(buf[o:o + fx], full[o:o + fx])
        assert (buf[:o] == -5).all() and (buf[o + fx:] == -5).all()


def test_envelope_kernels_match_plain(dev):
    t = _types((40, 33, 12), 0.05, 2).to(dev)
    w = kp.phase1_packed_plain(t, 85).permute(0, 2, 1).contiguous()
    yb = kp.phase1_pack_bits(33)
    for a, b in zip(ke.envelope_packed(w, yb), ke.envelope_packed_plain(w, yb)):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(3)
    f = torch.randint(0, 300, (6, 21, 37), generator=g, dtype=torch.int32)
    f[:, :, ::4] = 1 << 28
    pay = torch.randint(0, 1 << 20, f.shape, generator=g, dtype=torch.int32)
    f, pay = f.to(dev), pay.to(dev)
    for a, b in zip(ke.envelope_mid(f, pay), ke.envelope_mid_plain(f, pay)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ENVELOPE_CASES)
def test_envelope_packed_kernel_every_lane(dev, name):
    """The O(N) kernel on the edge cases its CPU model is held on (ties,
    site-free lanes, N at the idx_bits boundaries, costs just below the
    cap; lane counts that are not multiples of 32), on every lane."""
    w, yb = envelope_case(name)
    w = torch.from_numpy(w).to(dev)
    for a, b in zip(ke.envelope_packed(w, yb), ke.envelope_packed_plain(w, yb)):
        assert torch.equal(a, b)


def test_envelope_packed_kernel_refuses_large_n(dev):
    w = torch.zeros((ke.ENVELOPE_PACKED_MAX_N + 1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ke.envelope_packed(w, 3)


@pytest.mark.parametrize("name", MID_CASES)
def test_envelope_mid_kernel_every_lane(dev, name):
    """The O(N) phase-3 kernel on the edge cases its CPU model is held on
    (ties, site-free lanes, sites at 1 << 28, N at the idx_bits
    boundaries, near-cap and falling costs, lane counts off multiples of
    32, several batch rows), on every lane."""
    f, pay = (torch.from_numpy(a).to(dev) for a in mid_case(name))
    for a, b in zip(ke.envelope_mid(f, pay), ke.envelope_mid_plain(f, pay)):
        assert torch.equal(a, b)


def test_envelope_mid_kernel_limits(dev):
    """At the largest N it takes the kernel still agrees; above it the
    wrapper raises."""
    g = torch.Generator().manual_seed(9)
    N = ke.ENVELOPE_MID_MAX_N
    f = torch.randint(0, 1 << 12, (2, N, 40), generator=g, dtype=torch.int32)
    f[torch.rand(f.shape, generator=g) < 0.9] = 1 << 28
    pay = torch.randint(0, 1 << 30, f.shape, generator=g, dtype=torch.int32)
    f, pay = f.to(dev), pay.to(dev)
    for a, b in zip(ke.envelope_mid(f, pay), ke.envelope_mid_plain(f, pay)):
        assert torch.equal(a, b)
    big = torch.zeros((1, N + 1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ke.envelope_mid(big, big)


@pytest.mark.parametrize("K", [1, 320, 3610])
def test_gather_archive_rows_kernel(dev, K):
    """Repeated ids and ids 0 and B - 1, at the scroll's row counts."""
    B = 11997
    arch = _words((B, 1536), 8).to(dev)
    ids = torch.from_numpy(np.random.default_rng(K).integers(0, B, K).astype(np.int32))
    ids[0] = B - 1
    if K > 3:
        ids[1], ids[2] = 0, ids[3]
    ids = ids.to(dev)
    assert torch.equal(kbr.gather_archive_rows(arch, ids),
                       kbr.gather_archive_rows_plain(arch, ids))


@pytest.mark.parametrize("N,L", [(1, 45), (2, 45), (100, 100), (152, 333),
                                 (56, 128 * 128), (128, 56 * 128)])
def test_generic_envelope_kernel_matches_plain(dev, N, L):
    g = torch.Generator().manual_seed(N)
    cap = (1 << (31 - ke.env_idx_bits(N))) - 1
    f = torch.randint(0, 300, (N, L), generator=g, dtype=torch.int32)
    f[torch.rand(N, L, generator=g) < 0.4] = 1 << 28
    f[torch.rand(N, L, generator=g) < 0.1] = cap
    f[:, ::9] = 1 << 28
    pay = torch.randint(0, 1 << 30, f.shape, generator=g, dtype=torch.int32)
    f, pay = f.to(dev), pay.to(dev)
    for a, b in zip(ke.envelope(f, pay), ke.envelope_plain(f, pay)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", MID_CASES)
def test_generic_envelope_kernel_every_lane(dev, name):
    """The generic envelope (the FH body with B = 1) on phase 3's edge
    cases, each as [N, B * L] lanes."""
    f, pay = mid_case(name)
    B, N, L = f.shape
    cols = lambda a: torch.from_numpy(a).permute(1, 0, 2).reshape(N, B * L).contiguous().to(dev)
    f, pay = cols(f), cols(pay)
    for a, b in zip(ke.envelope(f, pay), ke.envelope_plain(f, pay)):
        assert torch.equal(a, b)


def test_generic_envelope_kernel_limits(dev):
    """At the largest N it takes the kernel still agrees; above it the
    wrapper raises."""
    g = torch.Generator().manual_seed(10)
    N = ke.ENVELOPE_MID_MAX_N
    f = torch.randint(0, 1 << 12, (N, 70), generator=g, dtype=torch.int32)
    f[torch.rand(f.shape, generator=g) < 0.9] = 1 << 28
    pay = torch.randint(0, 1 << 30, f.shape, generator=g, dtype=torch.int32)
    f, pay = f.to(dev), pay.to(dev)
    for a, b in zip(ke.envelope(f, pay), ke.envelope_plain(f, pay)):
        assert torch.equal(a, b)
    big = torch.zeros((N + 1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ke.envelope(big, big)


def test_batch_edt_2d_on_gpu_matches_cpu(dev):
    t = _types((100, 100, 1), 0.01, 7)
    ref = eb.batch_edt(t, 201)
    got = eb.batch_edt(t.to(dev), 201)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k])


@pytest.mark.parametrize("local", [(100, 100, 30), (100, 100, 1)])
def test_hokuyo_on_gpu_matches_cpu(dev, local):
    """The 2-D LiDAR model's float path (atan2f, fused multiply-adds,
    correctly rounded roots, IEEE divides) rounds the same on the card."""
    from gie_mapping_tpu_torch.ops import scan_sensors as ss
    from gie_mapping_tpu_torch.runtime import datasets as ds
    from gie_mapping_tpu_torch.utils import geometry as geo

    world = ds.scan2d_world()
    for pose in ds.scan2d_path()[::3]:
        r, tmin, tinc = ds.hokuyo_scan(world, pose)
        pvt = geo.calculate_pivot(pose[0], 0.1, local)
        kw = dict(local_size=local, voxel_width=0.1, ogm_min_h=-10.0,
                  ogm_max_h=10.0, for_motion_planner=True, robot_r2_grids=4)
        proj = geo.Projection.from_pose(*pose)
        want = ss.hokuyo_update(proj, ss.ScanParam(tmin, tinc, torch.from_numpy(r)),
                                pvt, **kw)
        got = ss.hokuyo_update(proj, ss.ScanParam(tmin, tinc,
                                                  torch.from_numpy(r).to(dev)),
                               pvt, **kw)
        assert torch.equal(got.cpu(), want)


def test_batch_edt_on_gpu_matches_cpu(dev):
    t = _types((32, 40, 16), 0.01, 4)
    ref = eb.batch_edt(t, 88)
    got = eb.batch_edt(t.to(dev), 88)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k])
    ref = eb.batch_edt_slab(t, 8, 16, sx=16, sy=24, max_width=88)
    got = eb.batch_edt_slab(t.to(dev), 8, 16, sx=16, sy=24, max_width=88)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k])


def test_carve_kernel_matches_plain(dev):
    rng = np.random.default_rng(5)
    pts = torch.from_numpy((rng.normal(size=(8192, 3)) * 2
                            + [0.3, -0.2, 1.2]).astype(np.float32)).to(dev)
    valid = torch.ones(8192, dtype=torch.bool, device=dev)
    local = (40, 40, 16)
    origin = np.asarray([0.31, -0.17, 1.13], np.float32)
    pvt = np.asarray([-17, -22, 0], np.int32)
    nt, np_ = rc.panorama_bins(local)
    tables = kc.panorama(pts, valid, origin, pvt, local_size=local,
                         voxel_width=0.1, ogm_min_h=0.0, ogm_max_h=2.5,
                         n_theta=nt, n_phi=np_)
    kw = dict(local_size=local, voxel_width=0.1, n_theta=nt, n_phi=np_,
              for_motion_planner=True, robot_r2_grids=16)
    for a, b in zip(kc.carve(*tables, pvt, origin, **kw),
                    kc.carve_plain(*tables, pvt, origin, **kw)):
        assert torch.equal(a, b)


def _panorama_kw(c):
    return dict(local_size=c["local_size"], voxel_width=c["voxel_width"],
                ogm_min_h=c["ogm_min_h"], ogm_max_h=c["ogm_max_h"],
                n_theta=c["n_theta"], n_phi=c["n_phi"])


@pytest.mark.parametrize("name", CARVE_POINTS)
def test_panorama_kernel_every_bin(dev, name):
    """gie_panorama on the cases its CPU model is held on (invalid points,
    points outside the height band or the window, several points in one
    bin, points at the origin and on the window's faces): every depth bit,
    count and endpoint count equals the plain version's."""
    c = carve_points(name)
    pts = torch.from_numpy(c["points"]).to(dev)
    valid = torch.from_numpy(c["valid"]).to(dev)
    before = kc.panorama.launches
    got = kc.panorama(pts, valid, c["origin"], c["pvt"], **_panorama_kw(c))
    assert kc.panorama.launches == before + 1
    want = kc.panorama_plain(pts, valid, c["origin"], c["pvt"], **_panorama_kw(c))
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("name", CARVE_WINDOWS)
def test_carve_kernel_every_voxel(dev, name):
    """gie_carve on the windows its CPU model is held on (the cow-lady and
    test windows, the ugv_corridor preset's 200x200x24), with tables that
    hold empty, near and far bins."""
    w = carve_window(name)
    tables = [torch.from_numpy(a).to(dev) for a in carve_tables(name)]
    kw = dict(local_size=w["local_size"], voxel_width=w["voxel_width"],
              n_theta=w["n_theta"], n_phi=w["n_phi"],
              for_motion_planner=name.endswith("_off"), robot_r2_grids=16)
    for a, b in zip(kc.carve(*tables, w["pvt"], w["origin"], **kw),
                    kc.carve_plain(*tables, w["pvt"], w["origin"], **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CARVE_POINTS)
def test_pointcloud_project_on_gpu_matches_cpu(dev, name):
    """The whole sensor model on the card (two kernel calls) equals it on
    the CPU (the plain versions)."""
    c = carve_points(name)
    kw = dict(_panorama_kw(c), for_motion_planner=True, robot_r2_grids=16)
    args = (c["origin"], c["pvt"])
    want = rc.pointcloud_project(torch.from_numpy(c["points"]),
                                 torch.from_numpy(c["valid"]), *args, **kw)
    got = rc.pointcloud_project(torch.from_numpy(c["points"]).to(dev),
                                torch.from_numpy(c["valid"]).to(dev), *args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_pointcloud_project_dispatches_only_allocations(dev):
    """On the card the sensor model issues no PyTorch operation but the
    allocation of its tables and outputs: the panorama, the endpoint
    counts and the carve are the two kernel calls."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    c = carve_points("cloud_100")
    pts = torch.from_numpy(c["points"]).to(dev)
    valid = torch.from_numpy(c["valid"]).to(dev)
    kw = dict(_panorama_kw(c), for_motion_planner=True, robot_r2_grids=16)
    with Count() as count:
        rc.pointcloud_project(pts, valid, c["origin"], c["pvt"], **kw)
    assert count.ops and all(op.startswith("aten.empty") for op in count.ops), count.ops


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    w[rng.random(shape) < 0.1] |= 0x7FFF
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("shift", [(1, 0, 0), (1, -1, 0), (0, 0, -3),
                                   (0, 0, 12), (-20, 0, 0)])
def test_shift_kernel_matches_plain(dev, shift):
    cv = _words((152, 152, 240), 1).to(dev)
    dflt = torch.from_numpy(np.tile(ms._PACKED_DEFAULT, 80).view(np.int32)).to(dev)
    assert torch.equal(ksh.shift_canvas(cv, dflt, shift),
                       ksh.shift_canvas_plain(cv, dflt, shift))


def test_blockrows_kernels_match_plain(dev):
    cb = (19, 19, 10)
    packed = _words((152, 152, 80, 3), 2).to(dev)
    ids = torch.tensor([0, 360, 5, 5, 17], dtype=torch.int32, device=dev)
    assert torch.equal(kbr.gather_block_rows(packed, ids, cb),
                       kbr.gather_block_rows_plain(packed, ids, cb))
    rows = _words((50, 512, 3), 3).to(dev)
    tgt = torch.tensor([4, 1, 3, 3, 3], dtype=torch.int32, device=dev)
    valid = (torch.arange(50, device=dev) % 3 == 0).to(torch.int32)
    valid[20:] = 0
    a = kbr.scatter_block_rows(packed.clone(), rows, tgt, valid, cb)
    b = kbr.scatter_block_rows_plain(packed.clone(), rows, tgt, valid, cb)
    assert torch.equal(a, b)
    arch = _words((64, 1536), 4).to(dev)
    aid = torch.tensor([7, 0, 7, 63], dtype=torch.int32, device=dev)
    assert torch.equal(kbr.gather_archive_rows(arch, aid),
                       kbr.gather_archive_rows_plain(arch, aid))
    r4 = _words((4, 512, 3), 5).to(dev)
    sid = torch.tensor([5, 0, 5, 9], dtype=torch.int32, device=dev)
    v4 = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    assert torch.equal(kbr.scatter_archive_rows(arch.clone(), r4, sid, v4),
                       kbr.scatter_archive_rows_plain(arch.clone(), r4, sid, v4))


def test_do_scroll_on_gpu_matches_cpu(dev):
    cfg = cow_lady_config(local_size_m=(4.0, 4.0, 1.6), max_blocks=512)
    rng = np.random.default_rng(6)
    st = ms.state_to_numpy(ms.MapState.create(cfg, device="cpu"))
    cs = cfg.canvas_size
    st["occ_val"] = rng.integers(0, 255, cs, dtype=np.uint8)
    st["vox_type"] = rng.integers(0, 4, cs).astype(np.int8)
    st["dist_sq"] = rng.integers(0, 900, cs).astype(np.int32)
    st["coc"] = rng.integers(-100, 100, cs + (3,)).astype(np.int16)
    st["present"] = rng.random(cfg.canvas_blocks) < 0.7
    old = np.zeros(3, np.int32)
    a, b = ms.state_from_numpy(st, device="cpu"), ms.state_from_numpy(st, dev)
    for new in ((2, 0, 0), (0, -1, 1), (30, 0, 0), (0, 0, 0)):
        new = np.asarray(new, np.int32)
        a = ms._do_scroll(a, new, cfg, old_origin_blk=old)
        b = ms._do_scroll(b, new, cfg, old_origin_blk=old)
        old = new
        ta, tb = ms.state_to_numpy(a), ms.state_to_numpy(b)
        for k in ms.FIELDS:
            np.testing.assert_array_equal(tb[k], ta[k], err_msg=k)


def test_l2g_fused_on_gpu_matches_cpu(dev):
    """The fuse_raycast transform on the card equals its CPU form bit for
    bit at 131,072 points (fma_f32 runs in float64 on either device)."""
    from gie_mapping_tpu_torch.utils import geometry as geo

    rng = np.random.default_rng(9)
    pts = torch.from_numpy((rng.normal(size=(131072, 3)) * 4).astype(np.float32))
    proj = geo.Projection.from_pose(np.asarray([0.3, -1.2, 1.1], np.float32),
                                    (0.9, 0.1, -0.2, 0.35))
    want = proj.l2g_fused(pts)
    got = proj.to(dev).l2g_fused(pts.to(dev))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _replay_frames(n, teleport):
    """Poses and clouds of a small replay: a line of steps (scrolls), or a
    jitter about one spot (no scroll)."""
    from gie_mapping_tpu_torch.runtime.datasets import BoxWorld
    from gie_mapping_tpu_torch.utils import geometry as geo

    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    eye = torch.eye(3)
    if teleport:
        xyz = [(-1.8 + 0.5 * i, 0.15 * i, 0.9) for i in range(n)]
    else:
        xyz = [(0.03 * (i % 3), 0.02 * (i % 2), 0.9) for i in range(n)]
    poses = [geo.Projection(eye, torch.tensor(p, dtype=torch.float32))
             for p in xyz]
    clouds = [world.pointcloud(p, n_rays=4096, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]
    return poses, clouds


@pytest.mark.parametrize("scrolls", [True, False])
def test_replay_on_gpu_matches_cpu(dev, scrolls):
    """process_pointcloud_batch on the card against the port on the CPU:
    every MapState field, the last outputs, per_frame and the counters,
    with and without scrolls in the runs."""
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    cfg = cow_lady_config(voxel_width=0.2, local_size_m=(9.6, 9.6, 1.6),
                          cutoff_dist=1.0, max_blocks=2048,
                          max_raycast_points=4096, fuse_raycast=True,
                          edt_gate_min_vox=0, display_glb_edt=False,
                          display_glb_ogm=False)
    poses, clouds = _replay_frames(9, scrolls)  # a 2-run comes last
    res = []
    for d in ("cpu", dev):
        m = VolumetricMapper(cfg, device=d)
        pts, val = m.stage_pointcloud_batch(clouds)
        out = m.process_pointcloud_batch(poses, pts, val, chunk=3).fetch()
        res.append((m, out))
    (a, oa), (b, ob) = res
    sa, sb = ms.state_to_numpy(a.state), ms.state_to_numpy(b.state)
    for k in ms.FIELDS:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    for k in ("edt", "dist_sq", "coc", "glb_type", "changed_blk"):
        np.testing.assert_array_equal(getattr(ob, k), getattr(oa, k), err_msg=k)
    for k, v in oa.per_frame.items():
        assert torch.equal(ob.per_frame[k].cpu(), v), k
    assert (b.map_ct, b.replay_scanned_frames, b.replay_scanned_scrolls) == \
        (a.map_ct, a.replay_scanned_frames, a.replay_scanned_scrolls)
    assert (b.replay_scanned_scrolls > 0) == scrolls
    np.testing.assert_array_equal(b._origin, a._origin)


# ---------------------------------------------------------------------------
# the projection sensors and the DDA walk (plain PyTorch on both devices)
# ---------------------------------------------------------------------------

def test_sinf_cosf_on_gpu_match_cpu(dev):
    """glibc's sinf / cosf carried in float64 operations give the same bits
    on the card as on the CPU (where tests/test_torch_multiscan.py holds
    them to the C library)."""
    from gie_mapping_tpu_torch.utils.floats import cosf_exact, sinf_exact

    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.uniform(-np.pi, np.pi, 1 << 20).astype(np.float32))
    for fn in (sinf_exact, cosf_exact):
        assert torch.equal(fn(v.to(dev)).cpu().view(torch.int32),
                           fn(v).view(torch.int32))


def _sensor_kw(ct):
    return dict(local_size=ct.local_size, voxel_width=ct.voxel_width,
                ogm_min_h=ct.ogm_min_h, ogm_max_h=ct.ogm_max_h,
                for_motion_planner=ct.for_motion_planner,
                robot_r2_grids=ct.robot_r2_grids)


@pytest.mark.parametrize("kind", ["depth", "multiscan"])
@pytest.mark.parametrize("window", ["golden", "preset"])
def test_projection_sensors_on_gpu_match_cpu(dev, kind, window):
    """realsense_update and vlp16_update (with their pixel and ring
    geometry) on the card against the CPU, every voxel, at random tilted
    poses, the voxel-face pose and images with NaN / +Inf / 0 pixels."""
    from gie_mapping_tpu_torch.models import pipeline as tp
    from gie_mapping_tpu_torch.utils import config as tcfg
    import test_torch_sensor_cases as sc

    kw = sc.SMALL if window == "golden" else {}
    ct = (tcfg.depthcam_config(**kw) if kind == "depth"
          else tcfg.uav_laser3d_config(**kw))
    rows, data = sc.poses(kind, ct.local_size, ct.voxel_width, n=3)
    face = sc.face_pose(ct.local_size, ct.voxel_width)
    face[7], face[8, 0] = rows[0, 7], rows[0, 8, 0]
    rows = np.concatenate([rows, face[None]])
    extra = sc.edge_depth(data[0]) if kind == "depth" else data[0].copy()
    if kind == "multiscan":
        extra[:, ::3] = np.nan
    data = np.concatenate([data, extra[None]])
    for k in range(len(rows)):
        args = (rows[k, 3:6], rows[k, 6], rows[k, 7], rows[k, 8],
                rows[k, 0].astype(np.int32))
        want, _ = tp.SENSORS[kind](torch.from_numpy(data[k]), *args, cfg=ct)
        got, _ = tp.SENSORS[kind](torch.from_numpy(data[k]).to(dev), *args,
                                  cfg=ct)
        assert torch.equal(got.cpu(), want), k


@pytest.mark.parametrize("origin", [(0.0, 0.0, 1.0), (0.3, 0.5, 0.7)])
def test_dda_raycast_on_gpu_matches_cpu(dev, origin):
    """pointcloud_raycast on the card against the CPU: ray_count and
    inst_type on the edge rays and a random cloud of 16384 rays, at the
    uav_raycast_fine window."""
    from gie_mapping_tpu_torch.utils import geometry as geo
    import test_torch_sensor_cases as sc

    ls = (50, 50, 15)
    o = np.asarray(origin, np.float32)
    pvt = geo.calculate_pivot(o, 0.2, ls)
    rnd, valid = sc.random_rays(o, 16384, 3, near=1.0)
    edge = sc.dda_rays(o)
    kw = dict(local_size=ls, voxel_width=0.2, ogm_min_h=0.2, ogm_max_h=3.0,
              for_motion_planner=True, robot_r2_grids=9)
    for pts, val in ((edge, np.ones(len(edge), bool)), (rnd, valid)):
        wi, wc = rc.pointcloud_raycast(torch.from_numpy(pts),
                                       torch.from_numpy(val), o, pvt, **kw)
        gi, gc = rc.pointcloud_raycast(torch.from_numpy(pts).to(dev),
                                       torch.from_numpy(val).to(dev), o, pvt,
                                       **kw)
        assert torch.equal(gc.cpu(), wc) and torch.equal(gi.cpu(), wi)


@pytest.mark.parametrize("kind", ["depth", "multiscan"])
def test_sensor_replay_on_gpu_matches_cpu(dev, kind):
    """process_depth_batch / process_multiscan_batch on the card against
    the port on the CPU: state, last outputs, per_frame and counters."""
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.runtime.datasets import BoxWorld
    from gie_mapping_tpu_torch.utils import config as tcfg
    from gie_mapping_tpu_torch.utils import geometry as geo

    kw = dict(local_size_m=(5.0, 5.0, 2.0), voxel_width=0.2, cutoff_dist=2.0,
              max_blocks=4096, edt_gate_min_vox=0)
    cfg = (tcfg.depthcam_config(**kw) if kind == "depth"
           else tcfg.uav_laser3d_config(**kw))
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    q = (np.cos(0.15), 0.0, 0.0, np.sin(0.15))
    poses = [geo.Projection.from_pose(
        np.asarray([-1.2 + 0.45 * i, 0.2 * i, 1.0], np.float32), q)
        for i in range(9)]
    if kind == "depth":
        got = [world.depth_image(p, rows=40, cols=52) for p in poses]
    else:
        got = [world.multiscan(p, ring_num=16, scan_num=180, max_range=8.0)
               for p in poses]
    data, sc = np.stack([g[0] for g in got]), got[0][1:]
    res = []
    for d in ("cpu", dev):
        m = VolumetricMapper(cfg, device=d)
        one = m.process_depth if kind == "depth" else m.process_multiscan
        batch = (m.process_depth_batch if kind == "depth"
                 else m.process_multiscan_batch)
        one(poses[0], data[0], *sc)
        out = batch(poses[1:], data[1:], *sc, chunk=4).fetch()
        res.append((m, out))
    (a, oa), (b, ob) = res
    sa, sb = ms.state_to_numpy(a.state), ms.state_to_numpy(b.state)
    for k in ms.FIELDS:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    for k in ("edt", "dist_sq", "coc", "glb_type", "changed_blk"):
        np.testing.assert_array_equal(getattr(ob, k), getattr(oa, k), err_msg=k)
    for k, v in oa.per_frame.items():
        assert torch.equal(ob.per_frame[k].cpu(), v), k
    assert (b.map_ct, b.replay_scanned_frames, b.replay_scanned_scrolls) == \
        (a.map_ct, a.replay_scanned_frames, a.replay_scanned_scrolls)
    assert b.replay_scanned_scrolls > 0


# ---------------------------------------------------------------------------
# the device mesh: the sharded EDT and the mapper over [card] * n
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_edt_on_gpu_matches_plain(dev, n):
    """batch_edt_sharded and a y-slab of it over n shards of one card (the
    kernels at the shard shapes) against the plain single-device chain."""
    from gie_mapping_tpu_torch.parallel.mesh import (canvas_sharding, gather,
                                                     make_mesh, put)

    shape = (152, 152, 80)
    t = _types(shape, 0.03, 5)
    mesh = make_mesh(devices=[dev] * n)
    ref = eb.batch_edt(t, sum(shape))
    xs = put(t.to(dev), canvas_sharding(mesh))
    got = eb.batch_edt_sharded(xs, sum(shape), mesh)
    for k in ref:
        assert all(p.shape[0] == 152 // n for p in got[k].parts), k
        assert torch.equal(gather(got[k]).cpu(), ref[k]), k
    got = eb.batch_edt_sharded_slab(xs, 40, sy=48, max_width=sum(shape),
                                    mesh=mesh)
    for k in ref:
        assert torch.equal(gather(got[k]).cpu(), ref[k][:, 40:88]), k


def test_sharded_edt_on_distinct_cards(dev):
    """The sharded EDT over the first two cards (each shard launched on its
    own card, reshards peer to peer)."""
    from gie_mapping_tpu_torch.parallel.mesh import (canvas_sharding, gather,
                                                     make_mesh, put)

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    t = _types((64, 48, 16), 0.03, 6)
    ref = eb.batch_edt(t, 128)
    mesh = make_mesh(2)
    got = eb.batch_edt_sharded(put(t, canvas_sharding(mesh)), 128, mesh)
    for k in ref:
        assert [p.device for p in got[k].parts] == list(mesh.devices), k
        assert torch.equal(gather(got[k]).cpu(), ref[k]), k


def test_replay_mesh_on_gpu_matches_cpu(dev):
    """process_pointcloud_batch over a 4-shard mesh of the card against the
    port's single-device run on the CPU: window outputs, per_frame and the
    checkpoint fields."""
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.parallel.mesh import make_mesh

    cfg = cow_lady_config(voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6),
                          cutoff_dist=1.0, max_blocks=2048,
                          max_raycast_points=4096, fuse_raycast=True,
                          edt_gate_min_vox=0, display_glb_edt=False,
                          display_glb_ogm=False)
    poses, clouds = _replay_frames(7, True)
    res = []
    for kw in (dict(device="cpu"), dict(mesh=make_mesh(devices=[dev] * 4))):
        m = VolumetricMapper(cfg, **kw)
        pts, val = m.stage_pointcloud_batch(clouds)
        out = m.process_pointcloud_batch(poses, pts, val, chunk=3).fetch()
        res.append((m, out))
    (a, oa), (b, ob) = res
    sa, sb = ms.state_to_numpy(a.state), ms.state_to_numpy(b.state)
    for k in VolumetricMapper.CHECKPOINT_FIELDS:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    for k in ("edt", "dist_sq", "coc", "glb_type"):
        np.testing.assert_array_equal(getattr(ob, k), getattr(oa, k), err_msg=k)
    assert b.replay_scanned_scrolls > 0


PARTS_SMALL = dict(voxel_width=0.2, local_size_m=(3.2, 3.2, 1.6),
                   cutoff_dist=0.8, max_blocks=512, edt_gate_min_vox=0)


@pytest.mark.parametrize("case", ["cow_lady", "scan2D", "depthcam", "laser3D"])
def test_parts_frame_composition_on_gpu(dev, case):
    """bench/parts.py on the card at a reduced window: the sensor stage's
    call, then merge_full's, from the frozen state equals one process_*
    frame of the mapper on a copy of that state, every field bit for bit,
    and each frame stage's single call equals the CPU's."""
    from gie_mapping_tpu_torch.bench import parts

    ov = dict(PARTS_SMALL, max_raycast_points=1024) if case == "cow_lady" \
        else PARTS_SMALL
    fz = parts.freeze(case, dev, ov)
    inst, cnt = fz.sensor()
    got, _ = fz.merge(fz.state, inst, cnt)
    assert parts.state_mismatch(got, fz.mapper_frame(fz.state)) == []
    cpu = parts.freeze(case, "cpu", ov)
    assert parts.state_mismatch(ms.state_from_numpy(
        ms.state_to_numpy(fz.state), device="cpu"), cpu.state) == []
    for name in ("merge_full", "edt_only", "scroll_step", "scroll_teleport"):
        a, b = parts.frame_stages(fz)[name], parts.frame_stages(cpu)[name]
        ga, gb = a.step(a.init()), b.step(b.init())
        ga, gb = (ga[0], gb[0]) if isinstance(ga, tuple) else (ga, gb)
        assert parts.state_mismatch(ms.state_from_numpy(
            ms.state_to_numpy(ga), device="cpu"), gb) == [], name


def test_parts_scroll_group_on_gpu(dev):
    """The scroll group at a reduced window on the card: the recorded steps
    compose to _do_scroll (compact and full columns), each timed chain
    runs, and the steps launch the shift and the four row kernels."""
    from gie_mapping_tpu_torch.bench import parts

    cfg, st = parts.scroll_state("cow_lady", dev, PARTS_SMALL)
    origin = st.origin_blk.cpu().numpy()
    for cols in (32, None):
        assert parts.scroll_composition(st, cfg, origin, cols) == []
    stages = parts.scroll_stages(st, cfg)
    recs = {n: parts.time_stage(dev, s, 2, reps=1) for n, s in stages.items()}
    assert all(r["ms"] > 0 for r in recs.values())
    moved = set().union(*(r["launches"] for r in recs.values()))
    assert {"shift_canvas", "gather_block_rows", "scatter_block_rows",
            "gather_archive_rows", "scatter_archive_rows"} <= moved
    assert "shift_canvas" in recs["shift"]["launches"]
    assert "shift_canvas" in recs["compact"]["launches"]
