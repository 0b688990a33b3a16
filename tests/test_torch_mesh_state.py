"""The PyTorch port's map state sharded between frames (parallel/mesh.py:
the canvas along x, the archive along blocks where max_blocks divides)
against the JAX package's mesh, bit for bit.

The JAX side runs on tests/conftest.py's eight virtual CPU devices; its
results do not depend on the mesh size (the gate's slabs span x at every
size), so one JAX run serves the port's meshes of 2, 4 and 8 CPU devices
(make_mesh(devices=["cpu"] * n)).  Every frame compares all 13 MapState
fields (gathered) and every output; the scroll trajectory moves the canvas
in x both ways, in z and by teleport, on a canvas whose x-shards do not hold
whole blocks (56 voxels: 28, 14, 7 a shard)."""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu.map_state import MapState as JaxState
from gie_mapping_tpu.map_state import canvas_geometry as jax_canvas_geometry
from gie_mapping_tpu.models import pipeline as jpipe
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.parallel import mesh as jmesh
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch import map_state as tms
from gie_mapping_tpu_torch.map_state import (FIELDS, MapState, canvas_geometry,
                                             state_to_numpy)
from gie_mapping_tpu_torch.models import pipeline as tpipe
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.parallel import mesh as tmesh
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld, scroll_trajectory
from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
from gie_mapping_tpu_torch.utils.constants import VOX_FREE, VOX_OCCUPIED

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _np(v):
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)


def _jax_state(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _assert_fields(got: dict, want: dict, msg, names=FIELDS):
    for k in names:
        np.testing.assert_array_equal(got[k], want[k], f"{msg}: {k}")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

PLACEMENTS = [  # (config overrides, mesh sizes)
    (dict(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, max_blocks=1024), (2, 3, 4, 8)),
    (dict(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, max_blocks=1023), (3, 8)),
    (dict(local_size_m=(4.0, 4.0, 1.6), voxel_width=0.2, max_blocks=1026), (3, 6)),
]


@pytest.mark.parametrize("case", range(len(PLACEMENTS)))
def test_placement_matches_jax(case):
    """Which fields shard (and which replicate) for the canvas x extent,
    max_blocks and mesh size: the JAX package's shard_state against
    MapState.create(mesh=) and shard_state here; a sharded field's parts
    are its dim-0 ranges, each on its own mesh device."""
    kw, sizes = PLACEMENTS[case]
    for n in sizes:
        jst = jmesh.shard_state(JaxState.create(jcfg.scan2d_config(**kw)),
                                jmesh.make_mesh(n))
        cfg = tcfg.scan2d_config(**kw)
        mesh = _mesh(n)
        whole = state_to_numpy(MapState.create(cfg, "cpu"))
        for st in (MapState.create(cfg, mesh=mesh),
                   tmesh.shard_state(MapState.create(cfg, "cpu"), mesh)):
            for f in FIELDS:
                jsharded = not getattr(jst, f).sharding.is_fully_replicated
                v = getattr(st, f)
                assert isinstance(v, tmesh.Sharded) == jsharded, (n, f)
                if jsharded:
                    step = whole[f].shape[0] // n
                    assert len(v.parts) == n
                    for i, p in enumerate(v.parts):
                        assert p.device == mesh.devices[i]
                        assert tuple(p.shape) == (step,) + whole[f].shape[1:]
            _assert_fields(state_to_numpy(st), whole, f"n={n}")
        sharded = {f for f in FIELDS
                   if isinstance(getattr(MapState.create(cfg, mesh=mesh), f),
                                 tmesh.Sharded)}
        X, B = cfg.canvas_size[0], cfg.max_blocks
        canvas = {"occ_val", "vox_type", "dist_sq", "coc"}
        assert (canvas <= sharded) == (X % n == 0), (n, sharded)
        assert ({"arch_keys", "a_packed"} <= sharded) == (B % n == 0), (n, sharded)


# ---------------------------------------------------------------------------
# merge_frame and the scroll over x-shards (6-voxel shards at n = 8)
# ---------------------------------------------------------------------------

# pivots: +x across shard boundaries, back in -x, a teleport and back
PIVOTS = [(0, 0, 0), (9, 2, 0), (17, 4, 0), (8, 4, 0), (-3, 1, 0), (400, 1, 0),
          (-2, 0, 0)]
MERGE_CASES = {"gated": {"edt_gate_min_vox": 0}, "ungated": {},
               "relax": {"merge_mode": "relax"}}


def _merge_cfg(pkg, **kw):
    return (jcfg if pkg == "jax" else tcfg).scan2d_config(
        local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, fast_mode=False,
        cutoff_dist=2.0, max_blocks=1024, for_motion_planner=False, **kw)


def _inst(local_size, seed):
    rng = np.random.default_rng(seed)
    inst = np.full(local_size, VOX_FREE, np.int8)
    inst[rng.random(local_size) < 0.03] = VOX_OCCUPIED
    inst[rng.random(local_size) < 0.2] = 0  # some unknown voxels
    return inst


OUTS = ("edt", "glb_type", "dist_sq", "coc", "ogm_changed", "changed_blk",
        "gate_level", "gate_slab_vox", "relax_iters", "fnt_count")
_JAX_MERGE = {}


def _jax_merge_run(case):
    if case not in _JAX_MERGE:
        cfg = _merge_cfg("jax", **MERGE_CASES[case])
        mesh = jmesh.make_mesh(4)
        st = jmesh.shard_state(JaxState.create(cfg), mesh)
        M = cfg.max_ext_obs
        fence = (jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
                 jnp.zeros((M,), jnp.bool_), jnp.int32(0))
        recs = []
        for i, pvt in enumerate(PIVOTS):
            pvt = np.asarray(pvt, np.int32)
            origin_blk, _, off = jax_canvas_geometry(cfg, pvt)
            st, out = jpipe.merge_frame(
                st, jnp.asarray(_inst(cfg.local_size, i)),
                jnp.zeros(cfg.local_size, jnp.int32), jnp.asarray(pvt),
                jnp.asarray(origin_blk), jnp.asarray(off), *fence, cfg=cfg,
                input_pointcloud=False, mesh=mesh)
            rec = _jax_state(st)
            rec.update({k: np.asarray(out[k]) for k in OUTS})
            recs.append(rec)
        _JAX_MERGE[case] = recs
    return _JAX_MERGE[case]


@pytest.mark.parametrize("case,n", [(c, n) for c in sorted(MERGE_CASES)
                                    for n in (2, 4, 8)]
                         + [("ungated", 3), ("relax", 3)])
def test_sharded_merge_and_scroll_match_jax(case, n):
    """scroll_step + merge_frame on a state sharded over n CPU devices:
    every field (gathered) and output of every frame equals the JAX mesh
    run, through scrolls across shard boundaries both ways and a teleport;
    the canvas stays x-sharded between frames.  At n = 3 the canvas (x 48)
    shards but its z (40) does not divide, so the ungated EDT takes the
    plain chain on the gathered canvas, as JAX's GSPMD does."""
    want = _jax_merge_run(case)
    cfg = _merge_cfg("torch", **MERGE_CASES[case])
    mesh = _mesh(n)
    st = MapState.create(cfg, mesh=mesh)
    M = cfg.max_ext_obs
    fence = (torch.zeros(M, 3), torch.zeros(M, 3),
             torch.zeros(M, dtype=torch.bool), 0)
    shifts = []
    for i, pvt in enumerate(PIVOTS):
        pvt = np.asarray(pvt, np.int32)
        origin_blk, _, off = canvas_geometry(cfg, pvt)
        shift = None
        old = st.origin_blk.numpy()
        if not np.array_equal(origin_blk, old):
            st, shift = tpipe.scroll_step(st, origin_blk, cfg=cfg)
            shifts.append(origin_blk.astype(np.int64) - old)
        st, out = tpipe.merge_frame(
            st, T(_inst(cfg.local_size, i)),
            torch.zeros(cfg.local_size, dtype=torch.int32), pvt, origin_blk,
            off, fence, cfg=cfg, input_pointcloud=False, enter_shift=shift,
            mesh=mesh)
        for f in ("occ_val", "vox_type", "dist_sq", "coc"):
            v = getattr(st, f)
            assert isinstance(v, tmesh.Sharded) and len(v.parts) == n, f
            assert v.parts[0].shape[0] == cfg.canvas_size[0] // n, f
        got = state_to_numpy(st)
        got.update({k: _np(out[k]) for k in OUTS})
        _assert_fields(got, want[i], f"{case} n={n} frame {i}", FIELDS + OUTS)
    sh = np.asarray(shifts)
    assert (sh[:, 0] > 0).any() and (sh[:, 0] < 0).any()
    assert (np.abs(sh[:, 0]) >= cfg.canvas_blocks[0]).any()  # the teleport
    assert int(got["n_arch"]) > 0
    assert isinstance(st.a_packed, tmesh.Sharded) == (cfg.max_blocks % n == 0)


# ---------------------------------------------------------------------------
# the mapper: streaming, the archive, checkpoints
# ---------------------------------------------------------------------------

STREAM = dict(local_size_m=(4.0, 3.2, 1.6), voxel_width=0.15, cutoff_dist=1.0,
              max_raycast_points=4096, edt_gate_min_vox=0,
              display_glb_edt=True, display_glb_ogm=True, stream_k_cols=8)
WORLD = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
POSES = scroll_trajectory(n_yaw=2, step_x=0.5, n_out=3, dz=1.0, n_back=2,
                          teleport_x=12.0, n_after=0)
MAPPER_OUTS = ("edt", "glb_type", "dist_sq", "coc", "gate_level",
               "gate_slab_vox", "fnt_count", "arch_dropped")
_JAX_MAPPER = {}


def _stream_tick(m, jax_side):
    if jax_side:
        ids, valid, rows, mask, _, lo = m._stream_pending
        return [np.asarray(v) for v in (ids, valid, rows, mask, lo)]
    (ids, valid, rows, mask, lo), _, _ = m._stream_pending
    return [ids.numpy(), valid.numpy(), rows.numpy().view(np.uint32),
            mask.numpy(), lo.numpy()]


JAX_BLOCKS = 4096


def _jax_mapper_run(tmp_path_factory):
    """The JAX mapper's mesh run at max_blocks JAX_BLOCKS (one run serves
    every case: a smaller archive that never fills holds the same rows)."""
    if not _JAX_MAPPER:
        jm = JaxMapper(jcfg.cow_lady_config(**STREAM, max_blocks=JAX_BLOCKS),
                       mesh=jmesh.make_mesh(4))
        recs = []
        for i, pose in enumerate(POSES):
            jp = jgeo.Projection.from_pose(*pose)
            pts = WORLD.pointcloud(jp, n_rays=4096, max_range=8.0, seed=i)
            jo = jm.process_pointcloud(jp, pts).fetch()
            rec = _jax_state(jm.state)
            rec.update({k: np.asarray(getattr(jo, k)) for k in MAPPER_OUTS})
            rec.update({k: np.asarray(jo.device(k))
                        for k in ("changed_blk", "ogm_changed")})
            rec["stream"] = _stream_tick(jm, True)
            rec["origin"] = np.asarray(jm._origin)
            recs.append(rec)
        jm.flush_stream()
        path = str(tmp_path_factory.mktemp("jaxckpt") / "jax.npz")
        jm.save(path)
        _JAX_MAPPER["run"] = (recs, mirror_digest(jm.mirror.blocks),
                              len(jm.mirror), path)
    return _JAX_MAPPER["run"]


@pytest.fixture
def frame_gathers(monkeypatch):
    """Records the largest dim-0 range any shard fetches, relative to the
    field's extent (a whole-canvas gather fetches all of it)."""
    seen = []
    real = tmesh.fetch_rows

    def rec(mesh, parts, extent, requests):
        spans = [min(r[1], extent) - max(r[0], 0) for r in requests if r]
        seen.append((extent, max(spans, default=0)))
        return real(mesh, parts, extent, requests)

    monkeypatch.setattr(tmesh, "fetch_rows", rec)
    monkeypatch.setattr(tms, "fetch_rows", rec)
    return seen


@pytest.mark.parametrize("n,max_blocks", [(2, 4095), (4, 4096), (8, 4096)])
def test_mapper_streaming_archive_checkpoint_match_jax(n, max_blocks,
                                                       frame_gathers, tmp_path,
                                                       tmp_path_factory):
    """process_pointcloud over the scroll trajectory (streaming on, 8 of
    42 columns a tick) on a mesh of n CPU devices against the JAX mapper's
    mesh run: every frame's state, outputs and stream tick, then the host
    mirror's digest; max_blocks 4096 block-shards the archive, 4095
    replicates it.  No frame gathers a whole canvas field.  Then a
    checkpoint saved sharded loads into one device and into JAX, and JAX's
    loads back onto the mesh, re-sharded."""
    want, mirror_sha, mirror_n, jax_ckpt = _jax_mapper_run(tmp_path_factory)
    rows = ("arch_keys", "a_packed")
    if max_blocks != JAX_BLOCKS:  # the same rows, the tail never written
        assert all(int(w["n_arch"]) < max_blocks for w in want)
        want = [dict(w, **{k: w[k][:max_blocks] for k in rows}) for w in want]
    cfg = tcfg.cow_lady_config(**STREAM, max_blocks=max_blocks)
    mesh = _mesh(n)
    tm = TorchMapper(cfg, mesh=mesh)
    X = cfg.canvas_size[0]
    for i, pose in enumerate(POSES):
        del frame_gathers[:]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            to = tm.process_pointcloud(tgeo.Projection.from_pose(*pose),
                                       WORLD.pointcloud(
                                           jgeo.Projection.from_pose(*pose),
                                           n_rays=4096, max_range=8.0, seed=i))
        assert frame_gathers and all(span < extent for extent, span
                                     in frame_gathers if extent == X), \
            f"frame {i} gathered a canvas field: {frame_gathers}"
        got = state_to_numpy(tm.state)
        got.update({k: np.asarray(getattr(to, k)) for k in MAPPER_OUTS})
        got.update({k: to.raw[k].numpy() for k in ("changed_blk", "ogm_changed")})
        _assert_fields(got, want[i], f"n={n} frame {i}",
                       FIELDS + MAPPER_OUTS + ("changed_blk", "ogm_changed"))
        for a, b, name in zip(_stream_tick(tm, False), want[i]["stream"],
                              ("ids", "valid", "rows", "blk_mask", "leftover")):
            np.testing.assert_array_equal(a, b, f"n={n} frame {i} stream {name}")
        np.testing.assert_array_equal(tm._origin, want[i]["origin"])
    for f in ("occ_val", "vox_type", "dist_sq", "coc"):
        v = getattr(tm.state, f)
        assert [tuple(p.shape[:3]) for p in v.parts] == \
            [(X // n,) + cfg.canvas_size[1:]] * n, f
        assert [p.device for p in v.parts] == list(mesh.devices), f
    assert isinstance(tm.state.a_packed, tmesh.Sharded) == (max_blocks % n == 0)
    tm.flush_stream()
    assert len(tm.mirror) == mirror_n > 0
    assert mirror_digest(tm.mirror.blocks) == mirror_sha
    assert tm.capacity_report()["n_arch"] > 0

    # checkpoints: sharded -> one device and JAX; JAX -> the mesh
    path = str(tmp_path / "mesh.npz")
    tm.save(path)
    mine = state_to_numpy(tm.state)
    one = TorchMapper(cfg, device="cpu").load(path)
    jm = JaxMapper(jcfg.cow_lady_config(**STREAM, max_blocks=max_blocks)).load(path)
    for k in TorchMapper.CHECKPOINT_FIELDS:
        np.testing.assert_array_equal(state_to_numpy(one.state)[k], mine[k], k)
        np.testing.assert_array_equal(np.asarray(getattr(jm.state, k)), mine[k], k)
    if max_blocks != JAX_BLOCKS:
        return
    back = TorchMapper(cfg, mesh=_mesh(n)).load(jax_ckpt)
    assert isinstance(back.state.vox_type, tmesh.Sharded)
    theirs = dict(np.load(jax_ckpt))
    for k in TorchMapper.CHECKPOINT_FIELDS:
        np.testing.assert_array_equal(state_to_numpy(back.state)[k],
                                      theirs[f"state/{k}"], k)
