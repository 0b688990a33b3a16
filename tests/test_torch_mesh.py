"""The PyTorch port's device mesh (gie_mapping_tpu_torch/parallel/mesh.py,
the sharded EDT, `mesh=` through merge_frame, the mapper, the replay,
checkpoints and the CLI) against the JAX package's mesh path, bit for bit,
and the last public helpers (load_config_yaml, the geometry helpers,
BoxWorld.ray_march_dense) against their JAX counterparts.

The JAX side runs on tests/conftest.py's eight virtual CPU devices
(gie_mapping_tpu.parallel.mesh.make_mesh(n)) as tests/test_multichip.py
runs it; the port's mesh is make_mesh(devices=["cpu"] * n).  Inputs come
from numpy seeds; integer state is compared exactly."""
import dataclasses
import json
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gie_mapping_tpu.map_state import MapState as JaxState
from gie_mapping_tpu.map_state import canvas_geometry as jax_canvas_geometry
from gie_mapping_tpu.models import pipeline as jpipe
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.ops import edt_batch as jeb
from gie_mapping_tpu.parallel import mesh as jmesh
from gie_mapping_tpu.runtime import datasets as jds
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
import gie_mapping_tpu_torch as tpkg
from gie_mapping_tpu_torch import cli as tcli
from gie_mapping_tpu_torch.map_state import (FIELDS, MapState, canvas_geometry,
                                             state_to_numpy)
from gie_mapping_tpu_torch.models import pipeline as tpipe
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.ops import edt_batch as teb
from gie_mapping_tpu_torch.ops.kernels import _build
from gie_mapping_tpu_torch.parallel import mesh as tmesh
from gie_mapping_tpu_torch.runtime import datasets as tds
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
from gie_mapping_tpu_torch.utils.constants import VOX_FREE, VOX_OCCUPIED

T = torch.from_numpy
OUTPUTS = ("edt", "glb_type", "dist_sq", "coc", "ogm_changed", "changed_blk")
SCALARS = ("gate_level", "gate_slab_vox", "relax_iters", "fnt_count")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _xs(a, mesh):
    """A whole canvas array as the mesh's x-shards."""
    return tmesh.put(T(a), tmesh.canvas_sharding(mesh))


def _whole(edt):
    """The sharded EDT's x-shards gathered, checking each shard's shape."""
    out = {}
    for k, v in edt.items():
        assert isinstance(v, tmesh.Sharded), k
        assert all(p.shape[0] == v.extent // v.mesh.size for p in v.parts), k
        out[k] = tmesh.gather(v)
    return out


def _np(v):
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)


# ---------------------------------------------------------------------------
# all_to_all and the sharded EDT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1), (2, 1)])
def test_all_to_all_matches_jax(n, split, concat):
    """Element for element against jax.lax.all_to_all(tiled=True) inside
    shard_map, on arrays of distinct values sharded along axis 0."""
    local = (2 * n, n, 3 * n)  # every axis splits into n
    shape = (n * local[0],) + local[1:]
    a = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    jm = jmesh.make_mesh(n)
    want = jax.shard_map(
        lambda x: jax.lax.all_to_all(x, jmesh.MESH_AXIS, split, concat,
                                     tiled=True),
        mesh=jm, in_specs=P(jmesh.MESH_AXIS), out_specs=P(jmesh.MESH_AXIS),
        check_vma=False)(jnp.asarray(a))
    got = tmesh.all_to_all(list(T(a).split(local[0])), split, concat)
    assert len(got) == n
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))


def _types(shape, seed):
    rng = np.random.default_rng(seed)
    occ = rng.random(shape) < 0.02
    return np.where(occ, VOX_OCCUPIED, VOX_FREE).astype(np.int8)


SLABS = [(0, 16), (8, 24), (32, 16), (0, 48)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_edt_matches_jax_and_one_device(n):
    """batch_edt_sharded and batch_edt_sharded_slab at
    tests/test_multichip.py's [64, 48, 16] against the JAX package's sharded
    functions and the port's own single-device batch_edt."""
    X, Y, Z = 64, 48, 16
    mw = X + Y + Z
    types = _types((X, Y, Z), 2)
    jm, tm = jmesh.make_mesh(n), _mesh(n)
    one = teb.batch_edt(T(types), mw)
    got = _whole(teb.batch_edt_sharded(_xs(types, tm), mw, tm))
    want = jeb.batch_edt_sharded(jnp.asarray(types), max_width=mw, mesh=jm)
    for k in ("dist_sq", "coc", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
        assert torch.equal(got[k], one[k]), k
    for y0, sy in SLABS:
        got = _whole(teb.batch_edt_sharded_slab(_xs(types, tm), y0, sy=sy,
                                                max_width=mw, mesh=tm))
        want = jeb.batch_edt_sharded_slab(jnp.asarray(types), jnp.int32(y0),
                                          sy=sy, max_width=mw, mesh=jm)
        for k in ("dist_sq", "coc", "valid"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          f"slab ({y0}, {sy}) {k}")
            assert torch.equal(got[k], one[k][:, y0:y0 + sy]), (y0, sy, k)


def test_sharded_edt_ok_matches_jax():
    shapes = [(64, 48, 16), (48, 48, 40), (152, 152, 80), (60, 8, 16),
              (64, 8, 12), (64, 8, 1), (36, 36, 36)]
    for n in (1, 2, 4, 8):
        for shape in shapes:
            assert teb.sharded_edt_ok(shape, _mesh(n)) == \
                jeb.sharded_edt_ok(shape, jmesh.make_mesh(n)), (n, shape)
    assert not teb.sharded_edt_ok((64, 48, 16), None)
    with pytest.raises(ValueError, match="divisible"):
        teb.batch_edt_sharded(_xs(_types((64, 8, 12), 0), _mesh(8)), 84)
    with pytest.raises(TypeError, match="x-shards"):
        teb.batch_edt_sharded(T(_types((64, 8, 16), 0)), 88, _mesh(8))


@contextmanager
def _recorded_launches(monkeypatch):
    """Each kernel wrapper that the sharded EDT calls, recording the device
    of its input."""
    calls = []
    for name in ("phase1_packed", "envelope_packed", "envelope"):
        def rec(*a, _name=name, _f=getattr(teb, name), **kw):
            calls.append((_name, a[0].device))
            return _f(*a, **kw)
        monkeypatch.setattr(teb, name, rec)
    yield calls


def test_sharded_edt_launches_on_each_shard(monkeypatch):
    """Each phase launches its kernel once per shard, on that shard's
    device, and never the single-device phase 3 (envelope_mid)."""
    n = 4
    mesh = tmesh.Mesh(tuple(torch.device("cpu") for _ in range(n)))
    with _recorded_launches(monkeypatch) as calls:
        teb.batch_edt_sharded(_xs(_types((32, 16, 8), 1), mesh), 56, mesh)
    assert [c[0] for c in calls] == ["phase1_packed"] * n + \
        ["envelope_packed"] * n + ["envelope"] * n
    assert [c[1] for c in calls] == list(mesh.devices) * 3


class _FakeCudaTensor:
    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


def test_launches_run_on_the_tensor_device(monkeypatch):
    """A raw launch goes to the current CUDA device, so every kernel
    wrapper launches inside _build.on_device_of(t): t's device is made
    current when it is not (a shard on cuda:1 while cuda:0 is current),
    and left alone when it is."""
    current = [0]
    entered = []

    class Device:
        def __init__(self, idx):
            self.idx = idx

        def __enter__(self):
            entered.append(self.idx)
            self.prev, current[0] = current[0], self.idx

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", Device)
    for idx in (1, 0, 3):
        with _build.on_device_of(_FakeCudaTensor(idx)):
            assert current[0] == idx
        assert current[0] == 0
    assert entered == [1, 3]
    # every launch site of the wrappers is guarded
    import inspect
    from gie_mapping_tpu_torch.ops.kernels import (blockrows, carve, envelope,
                                                   phase1, shift)
    for mod in (blockrows, carve, envelope, phase1, shift):
        src = inspect.getsource(mod)
        assert src.count("rc = _build.fn(") == \
            src.count("with _build.on_device_of(") > 0, mod.__name__


# ---------------------------------------------------------------------------
# merge_frame under a mesh (tests/test_multichip.py's config and frames)
# ---------------------------------------------------------------------------

def _cfg(pkg, **kw):
    return (jcfg if pkg == "jax" else tcfg).scan2d_config(
        local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, fast_mode=False,
        cutoff_dist=2.0, max_blocks=2048, for_motion_planner=False, **kw)


def _inst(local_size, seed):
    rng = np.random.default_rng(seed)
    inst = np.full(local_size, VOX_FREE, np.int8)
    inst[rng.random(local_size) < 0.02] = VOX_OCCUPIED
    return inst


def _frame_geometry(i, cfg, geometry):
    pvt = np.asarray([4 * i, 0, 0], np.int32)
    origin_blk, _, off = geometry(cfg, pvt)
    return pvt, origin_blk, off


def _jax_merge_run(cfg, n, n_frames):
    mesh = jmesh.make_mesh(n)
    st = jmesh.shard_state(JaxState.create(cfg), mesh)
    M = cfg.max_ext_obs
    fence = (jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
             jnp.zeros((M,), jnp.bool_), jnp.int32(0))
    frames = []
    for i in range(n_frames):
        pvt, origin_blk, off = _frame_geometry(i, cfg, jax_canvas_geometry)
        st, out = jpipe.merge_frame(
            st, jnp.asarray(_inst(cfg.local_size, i)),
            jnp.zeros(cfg.local_size, jnp.int32), jnp.asarray(pvt),
            jnp.asarray(origin_blk), jnp.asarray(off), *fence, cfg=cfg,
            input_pointcloud=False, mesh=mesh)
        rec = {f.name: np.asarray(getattr(st, f.name))
               for f in dataclasses.fields(st)}
        rec.update({k: np.asarray(out[k]) for k in OUTPUTS + SCALARS})
        frames.append(rec)
    return frames


def _port_merge_run(cfg, mesh, n_frames):
    st = MapState.create(cfg, "cpu")
    if mesh is not None:
        st = tmesh.shard_state(st, mesh)
    M = cfg.max_ext_obs
    fence = (torch.zeros(M, 3), torch.zeros(M, 3),
             torch.zeros(M, dtype=torch.bool), 0)
    frames = []
    for i in range(n_frames):
        pvt, origin_blk, off = _frame_geometry(i, cfg, canvas_geometry)
        shift = None
        if not np.array_equal(origin_blk, st.origin_blk.numpy()):
            st, shift = tpipe.scroll_step(st, origin_blk, cfg=cfg)
        st, out = tpipe.merge_frame(
            st, T(_inst(cfg.local_size, i)),
            torch.zeros(cfg.local_size, dtype=torch.int32), pvt, origin_blk,
            off, fence, cfg=cfg, input_pointcloud=False, enter_shift=shift,
            mesh=mesh)
        rec = state_to_numpy(st)
        rec.update({k: _np(out[k]) for k in OUTPUTS + SCALARS})
        frames.append(rec)
    return frames


MERGE_CASES = {"ungated": ({}, 3), "gated": ({"edt_gate_min_vox": 0}, 3),
               "relax": ({"merge_mode": "relax"}, 2)}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_frame_mesh_matches_jax(case):
    """Every MapState field, the window outputs, gate_level and slab_vox of
    each frame equal the JAX package's mesh run (8 devices); the window
    outputs equal the port's single-device run."""
    kw, n_frames = MERGE_CASES[case]
    want = _jax_merge_run(_cfg("jax", **kw), 8, n_frames)
    cfg = _cfg("torch", **kw)
    got = _port_merge_run(cfg, _mesh(8), n_frames)
    one = _port_merge_run(cfg, None, n_frames)
    for i, (g, w, o) in enumerate(zip(got, want, one)):
        for k in FIELDS + OUTPUTS + SCALARS:
            np.testing.assert_array_equal(g[k], w[k], f"frame {i} {k}")
        for k in ("edt", "glb_type", "dist_sq", "coc"):
            np.testing.assert_array_equal(g[k], o[k], f"frame {i} {k}")
    levels = [int(g["gate_level"]) for g in got]
    if case == "gated":
        n_menu = len(tpipe._slab_menu(cfg.canvas_size))
        assert min(levels) < n_menu, levels  # a y-slab frame
        assert not got[-1]["p1c_ok"] and not got[-1]["p1c"].any()
    else:
        assert set(levels) == {-1}


# ---------------------------------------------------------------------------
# the mapper: online frames, checkpoints, the replay
# ---------------------------------------------------------------------------

def test_mapper_mesh_matches_single_and_checkpoint(tmp_path):
    """process_scan2d over 3 poses with a mesh and without gives equal
    per-frame outputs; a checkpoint written under a mesh reloads into a mesh
    mapper of either package with equal state."""
    cfg = _cfg("torch")
    world = tds.BoxWorld.corridor(seed=3, n_pillars=3, extent=2.0, height=1.4)

    def run(mesh):
        m = TorchMapper(cfg, device=None if mesh else "cpu", mesh=mesh)
        outs = []
        for proj in tds.circular_trajectory(3, radius=0.8, height=0.6):
            r, tmin, tinc = world.scan_2d(proj, n_beams=90)
            o = m.process_scan2d(proj, r, tmin, tinc)
            outs.append({k: _np(getattr(o, k)) for k in
                         ("dist_sq", "glb_type", "coc", "edt", "gate_level")})
        return m, outs

    _, ref = run(None)
    m1, shd = run(_mesh(8))
    assert m1.device == torch.device("cpu")
    for i, (a, b) in enumerate(zip(ref, shd)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], f"frame {i} {k}")
    p = str(tmp_path / "mesh_ckpt.npz")
    m1.save(p)
    m2 = TorchMapper(cfg, mesh=_mesh(4)).load(p)
    jm = JaxMapper(_cfg("jax"), mesh=jmesh.make_mesh(8)).load(p)
    s1, s2 = state_to_numpy(m1.state), state_to_numpy(m2.state)
    for k in TorchMapper.CHECKPOINT_FIELDS:
        np.testing.assert_array_equal(s2[k], s1[k], k)
        np.testing.assert_array_equal(np.asarray(getattr(jm.state, k)), s1[k], k)


REPLAY = dict(voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
              max_blocks=1024, max_raycast_points=256, fuse_raycast=True,
              display_glb_edt=False, display_glb_ogm=False)


def test_replay_mesh_matches_jax_and_one_device(monkeypatch):
    """process_pointcloud_batch (pipeline.replay_frames) over a 4-device
    mesh, scrolls inside the run: state, last outputs and every frame's
    scalars equal the JAX package's mesh replay and the port's
    single-device replay."""
    world = tds.BoxWorld.corridor(seed=5, n_pillars=4, extent=3.0, height=1.4)
    poses = [(np.eye(3, dtype=np.float32),
              np.asarray([-1.2 + 0.45 * i, 0.1 * i, 0.9], np.float32))
             for i in range(5)]
    clouds = [world.pointcloud(tgeo.Projection(T(r.copy()), T(t.copy())),
                               n_rays=200, max_range=3.0, seed=i)
              for i, (r, t) in enumerate(poses)]
    runs = {"jax": [], "torch": []}

    def recording(orig, key):
        def f(*a, **kw):
            res = orig(*a, **kw)
            runs[key].append({k: np.asarray(v) for k, v in res[3].items()})
            return res
        return f

    from gie_mapping_tpu_torch.models import mapper as tmapper
    monkeypatch.setattr(jpipe, "replay_frames",
                        recording(jpipe.replay_frames, "jax"))
    monkeypatch.setattr(tmapper, "replay_frames",
                        recording(tmapper.replay_frames, "torch"))

    def drive(m, proj):
        pts, val = m.stage_pointcloud_batch(clouds)
        return m.process_pointcloud_batch([proj(*p) for p in poses], pts, val,
                                          chunk=len(poses))

    jm = JaxMapper(jcfg.cow_lady_config(**REPLAY), mesh=jmesh.make_mesh(4))
    jo = drive(jm, lambda r, t: jgeo.Projection(rot=r, trans=t))
    outs = {}
    for name, mesh in (("mesh", _mesh(4)), ("one", None)):
        m = TorchMapper(tcfg.cow_lady_config(**REPLAY),
                        device=None if mesh else "cpu", mesh=mesh)
        outs[name] = (m, drive(m, lambda r, t: tgeo.Projection(T(r.copy()),
                                                               T(t.copy()))))
    (m, o), (m1, o1) = outs["mesh"], outs["one"]
    # frame 0 places the canvas online; the other four run as one replay
    # run with scrolls inside it, in all three mappers
    assert jm.replay_scanned_scrolls > 0
    for tm in (m, m1):
        assert (tm.replay_scanned_frames, tm.replay_scanned_scrolls, tm.map_ct) \
            == (jm.replay_scanned_frames, jm.replay_scanned_scrolls, jm.map_ct)
    js = {f.name: np.asarray(getattr(jm.state, f.name))
          for f in dataclasses.fields(jm.state)}
    ts, ts1 = state_to_numpy(m.state), state_to_numpy(m1.state)
    for k in FIELDS:
        np.testing.assert_array_equal(ts[k], js[k], f"state {k}")
    # the gate's own bookkeeping (the per-cell bound, the phase-1 cache)
    # follows its slabs and the cache, which differ under a mesh
    for k in TorchMapper.CHECKPOINT_FIELDS:
        np.testing.assert_array_equal(ts1[k], ts[k], f"state {k}")
    for k in ("edt", "dist_sq", "coc", "glb_type"):
        np.testing.assert_array_equal(_np(o.raw[k]), np.asarray(jo.device(k)), k)
        np.testing.assert_array_equal(_np(o1.raw[k]), _np(o.raw[k]), k)
    assert len(runs["torch"]) == 2 * len(runs["jax"]) > 0
    for jr, tr in zip(runs["jax"], runs["torch"]):
        for k, v in jr.items():
            np.testing.assert_array_equal(tr[k], v, k)
    np.testing.assert_array_equal(m._origin, jm._origin)


# ---------------------------------------------------------------------------
# construction and the CLI
# ---------------------------------------------------------------------------

def test_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="4 CUDA devices"):
        tmesh.make_mesh(4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TorchMapper(_cfg("torch"), device="cpu", mesh=_mesh(2))
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.make_mesh(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="n_devices"):
        tmesh.make_mesh(3, devices=["cpu"] * 2)
    mesh = _mesh(2)
    assert mesh.size == 2 and hash(mesh) == hash(_mesh(2))
    m = tpkg.create_mapper("scan2D", mesh=mesh, local_size_m=(3.2, 3.2, 1.6),
                           voxel_width=0.2, max_blocks=512)
    assert m.mesh is mesh and m.device == torch.device("cpu")
    assert all(p.device == torch.device("cpu") for f in FIELDS
               for p in tmesh.parts_of(getattr(m.state, f)))


def test_cli_mesh_counts_match_one_device(monkeypatch, capsys):
    """cli.main(["--cpu", "--mesh", "4", ...]) prints the same counts as
    --cpu alone (the gate's level may differ: the mesh's slabs span x)."""
    real = tcfg.load_config
    monkeypatch.setattr(tcli, "load_config", lambda case: real(
        case, local_size_m=(4.0, 4.0, 1.6), voxel_width=0.2, cutoff_dist=1.0,
        max_blocks=2048))
    got = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "4"])):
        got[name] = tcli.main(["cow_lady", "--frames", "3", "--cpu", *extra])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
            == got[name]
    keys = ("frames", "occupied_voxels", "frontier_voxels", "mirror_blocks",
            "arch_dropped")
    assert {k: got["mesh"][k] for k in keys} == {k: got["one"][k] for k in keys}
    assert got["one"]["occupied_voxels"] > 0


# ---------------------------------------------------------------------------
# the last public helpers
# ---------------------------------------------------------------------------

def test_load_config_yaml_matches_jax(tmp_path):
    p = tmp_path / "custom.yaml"
    p.write_text("\n".join([
        "data_case: custom_case", "for_motion_planner: true", "robot_r: 0.3",
        "occupancy_threshold: 170", "voxel_width: 0.1", "local_size_x: 6.0",
        "local_size_y: 5.0", "local_size_z: 2.0", "ogm:", "  min_height: 0.1",
        "  max_height: 3.0", "wave:", "  fast_mode: false",
        "  cutoff_dist: 1.5", "hash:", "  block_max: 4096",
        "display_glb_edt: false", "vis_interval: 2", "ugv_height: 0.5", ""]))
    got = tpkg.load_config_yaml(str(p))
    want = jcfg.load_config_yaml(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.local_size == want.local_size and got.fast_mode is False
    (tmp_path / "empty.yaml").write_text("{}\n")
    assert dataclasses.asdict(tpkg.load_config_yaml(
        str(tmp_path / "empty.yaml"))) == dataclasses.asdict(
        jcfg.load_config_yaml(str(tmp_path / "empty.yaml")))


def _rot(rng):
    q = rng.normal(size=4)
    return jgeo.quat_to_rot(*(q / np.linalg.norm(q)))


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(7)
    ident_t, ident_j = tgeo.Projection.identity(), jgeo.Projection.identity()
    np.testing.assert_array_equal(ident_t.rot.numpy(), np.asarray(ident_j.rot))
    np.testing.assert_array_equal(ident_t.trans.numpy(), np.asarray(ident_j.trans))
    for i in range(40):
        R, t = _rot(rng), (rng.normal(size=3) * 3).astype(np.float32)
        Tm = np.eye(4, dtype=np.float32)
        Tm[:3, :3], Tm[:3, 3] = _rot(rng), rng.normal(size=3)
        tp, jp = tgeo.Projection(T(R), T(t)), jgeo.Projection(jnp.asarray(R),
                                                             jnp.asarray(t))
        tc, jc = tp.compose_matrix(Tm), jp.compose_matrix(Tm)
        np.testing.assert_array_equal(tc.rot.numpy(), np.asarray(jc.rot))
        np.testing.assert_array_equal(tc.trans.numpy(), np.asarray(jc.trans))
        np.testing.assert_array_equal(tp.origin.numpy(), np.asarray(jp.origin))
        # g2l's rounding depends on the row count (geometry.Projection.g2l)
        for n in (1, 8, 15, 16, 20, 24, 31, 32, 100, 4097):
            pts = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
            np.testing.assert_array_equal(tp.g2l(T(pts)).numpy(),
                                          np.asarray(jp.g2l(jnp.asarray(pts))),
                                          f"g2l {n} rows")
    # compose_matrix of the cow-lady extrinsic, the case it exists for
    tc = ident_t.compose_matrix(tcfg.T_V_C)
    jc = ident_j.compose_matrix(jcfg.T_V_C)
    np.testing.assert_array_equal(tc.rot.numpy(), np.asarray(jc.rot))
    c = rng.integers(-70000, 70000, size=(500, 3)).astype(np.int32)
    pvt = rng.integers(-500, 500, size=3).astype(np.int32)
    c2 = rng.integers(-300, 300, size=(500, 3)).astype(np.int32)
    for name, args in (("glb2loc", (c, pvt)), ("loc2glb", (c, pvt)),
                       ("squared_dist", (c2, c2[::-1].copy())),
                       ("block_key_of", (c,)), ("sub_block_index", (c,))):
        got = getattr(tgeo, name)(*[T(a) for a in args])
        want = getattr(jgeo, name)(*[jnp.asarray(a) for a in args])
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)


def test_ray_march_dense_matches_jax():
    rng = np.random.default_rng(3)
    tw = tds.BoxWorld.corridor(seed=4, n_pillars=5, extent=3.0, height=1.5)
    jw = jds.BoxWorld.corridor(seed=4, n_pillars=5, extent=3.0, height=1.5)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for origin in ((0.0, 0.0, 0.7), (0.4, -0.3, 1.1)):
        got = tw.ray_march_dense(origin, dirs, max_range=6.0)
        np.testing.assert_array_equal(
            got, jw.ray_march_dense(origin, dirs, max_range=6.0))
        assert np.isfinite(got).any()
