"""The port's driver entry points (gie_mapping_tpu_torch/graft_entry.py)
against the root __graft_entry__.py's results, and replay_frames' form
with precomputed observations against the JAX package's replay_frames.

entry() and frame_inputs are held to tests/fixtures/torch_port_entry_ref.npz
(make_torch_port_ref.py --only entry; this file does not import
__graft_entry__, which turns on JAX's persistent compile cache at import).
The replay form runs live against JAX on a small canvas, with no mesh and
over two shards."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu.map_state import MapState as JaxState
from gie_mapping_tpu.map_state import canvas_geometry as jax_canvas_geometry
from gie_mapping_tpu.models import pipeline as jpipe
from gie_mapping_tpu.parallel import mesh as jmesh
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu_torch import graft_entry as ge
from gie_mapping_tpu_torch.map_state import (FIELDS, MapState, canvas_geometry,
                                             output_digest, state_digest,
                                             state_to_numpy)
from gie_mapping_tpu_torch.models import pipeline as tpipe
from gie_mapping_tpu_torch.parallel import mesh as tmesh
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils.constants import (VOX_FREE, VOX_OCCUPIED,
                                                   VOX_UNKNOWN)

REF = os.path.join(os.path.dirname(__file__), "fixtures",
                   "torch_port_entry_ref.npz")
T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small operations: one intra-op thread
    runs them as fast as eight alone, and does not fight the suite's other
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


def _sub(ref, prefix):
    return {k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# frame_inputs and entry() at the cow_lady preset's width
# ---------------------------------------------------------------------------

def test_frame_inputs_match_jax(ref):
    """The same seeded observation, geometry and empty fence as the JAX
    file's _frame_inputs (dtypes, shapes and bytes)."""
    inst, cnt, pvt, origin_blk, off, (ll, ur, act, n) = ge.frame_inputs(
        tcfg.cow_lady_config(), device="cpu")
    want = _sub(ref, "entry/in/")
    got = {"inst_sha": ge.array_sha(inst.numpy()),
           "ray_count_sha": ge.array_sha(cnt.numpy()),
           "ll_sha": ge.array_sha(ll.numpy()), "ur_sha": ge.array_sha(ur.numpy()),
           "active_sha": ge.array_sha(act.numpy())}
    for k, v in got.items():
        assert v == str(want[k]), k
    for k, v in (("pvt", pvt), ("origin_blk", origin_blk), ("off", off)):
        np.testing.assert_array_equal(v, want[k], k)
        assert v.dtype == want[k].dtype, k
    assert n == int(want["n"])
    # pivot 0 puts the canvas origin away from MapState.create's (0, 0, 0):
    # the entry's one call scrolls
    assert origin_blk.tolist() == [-3, -3, -3]


def test_entry_matches_jax(ref):
    """fn(*args) at full width (152x152x80 canvas): the scroll to the
    pivot-0 origin, then the merge; the state and every output equal the
    JAX entry's, and the arguments are left as they were."""
    fn, args = ge.entry(device="cpu")
    assert args[0].vox_type.shape == (152, 152, 80)
    before = state_digest(state_to_numpy(args[0]))
    st, out = fn(*args)
    assert state_digest(state_to_numpy(args[0])) == before
    assert st.origin_blk.tolist() == [-3, -3, -3]
    assert state_digest(state_to_numpy(st)) == str(ref["entry/state_sha"])
    assert output_digest(out["glb_type"].numpy(), out["dist_sq"].numpy(),
                         out["coc"].numpy()) == str(ref["entry/out_sha"])
    shapes = {k: tuple(v.tolist()) for k, v in _sub(ref, "entry/shape/").items()}
    assert ge.output_shapes(out) == shapes
    for k, v in _sub(ref, "entry/value/").items():
        assert np.asarray(out[k]).item() == v.item(), k
    for k, v in _sub(ref, "entry/sha/").items():
        assert ge.array_sha(out[k].numpy()) == str(v), k


# ---------------------------------------------------------------------------
# replay_frames(inst_type=, ray_count=)
# ---------------------------------------------------------------------------

SMALL = dict(voxel_width=0.2, local_size_m=(3.2, 3.2, 1.6), cutoff_dist=1.0,
             max_blocks=1024, display_glb_edt=False, display_glb_ogm=False,
             edt_gate_min_vox=0)
PIVOTS_X = (0, 4, 4, 12)  # frame 0 places the canvas; frame 3 scrolls in x


def _plan(cfg, geometry):
    """Poses [K, 9, 3], scrolled [K] and the observations of PIVOTS_X from
    a fresh state (origin 0): 2 % occupied over free, a quarter unknown."""
    K = len(PIVOTS_X)
    poses = np.zeros((K, 9, 3), np.float32)
    scrolled = np.zeros(K, bool)
    prev = np.zeros(3, np.int32)
    rng = np.random.default_rng(7)
    inst = np.where(rng.random((K,) + cfg.local_size) < 0.02, VOX_OCCUPIED,
                    VOX_FREE).astype(np.int8)
    inst[rng.random(inst.shape) < 0.25] = VOX_UNKNOWN
    for i, x in enumerate(PIVOTS_X):
        pvt = np.asarray([x, 0, 0], np.int32)
        origin_blk, _, off = geometry(cfg, pvt)
        poses[i, 0], poses[i, 1], poses[i, 2] = pvt, origin_blk, off
        scrolled[i] = not np.array_equal(prev, origin_blk)
        prev = origin_blk
    assert scrolled[0] and scrolled[1:].any()
    return poses, scrolled, inst


def _jax_replay(n):
    cfg = jcfg.cow_lady_config(**SMALL)
    poses, scrolled, inst = _plan(cfg, jax_canvas_geometry)
    mesh = jmesh.make_mesh(n) if n else None
    st = JaxState.create(cfg)
    if mesh is not None:
        st = jmesh.shard_state(st, mesh)
    M = cfg.max_ext_obs
    st, out, union, pf = jpipe.replay_frames(
        st, jnp.asarray(poses), jnp.asarray(scrolled),
        jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
        jnp.zeros((M,), jnp.bool_), jnp.int32(0), inst_type=jnp.asarray(inst),
        ray_count=jnp.zeros(inst.shape, jnp.int32), cfg=cfg,
        input_pointcloud=False, mesh=mesh)
    state = {f.name: np.asarray(getattr(st, f.name))
             for f in dataclasses.fields(st)}
    return state, {k: np.asarray(v) for k, v in out.items()}, \
        np.asarray(union), {k: np.asarray(v) for k, v in pf.items()}


def _port_replay(n):
    cfg = tcfg.cow_lady_config(**SMALL)
    poses, scrolled, inst = _plan(cfg, canvas_geometry)
    mesh = tmesh.make_mesh(devices=["cpu"] * n) if n else None
    st = MapState.create(cfg, "cpu")
    if mesh is not None:
        st = tmesh.shard_state(st, mesh)
    _, _, _, _, _, fence = ge.frame_inputs(cfg, device="cpu")
    st, out, union, pf = tpipe.replay_frames(
        st, poses, scrolled, fence, cfg=cfg, origin_blk=np.zeros(3, np.int32),
        input_pointcloud=False, inst_type=T(inst),
        ray_count=torch.zeros(inst.shape, dtype=torch.int32), mesh=mesh)
    return state_to_numpy(st), {k: tmesh.to_numpy(v) if isinstance(
        v, torch.Tensor) else np.asarray(v) for k, v in out.items()}, \
        tmesh.to_numpy(union), {k: v.numpy() for k, v in pf.items()}


@pytest.mark.parametrize("n", [0, 2], ids=["one_device", "mesh2"])
def test_replay_inst_type_matches_jax(n):
    """Precomputed observations through replay_frames (a scroll from the
    fresh state's origin, a merge without a move, a scroll in x), with no
    mesh and over 2 shards: every MapState field, the last frame's window
    outputs, changed_union and per_frame equal JAX's replay_frames."""
    js, jo, ju, jpf = _jax_replay(n)
    ts, to, tu, tpf = _port_replay(n)
    for k in FIELDS:
        np.testing.assert_array_equal(ts[k], js[k], f"state {k}")
    for k in ("edt", "glb_type", "dist_sq", "coc", "ogm_changed",
              "changed_blk"):
        np.testing.assert_array_equal(to[k], jo[k], f"output {k}")
    np.testing.assert_array_equal(tu, ju, "changed_union")
    assert set(tpf) == set(jpf)
    for k, v in jpf.items():
        np.testing.assert_array_equal(tpf[k], v, f"per_frame {k}")
    assert ts["present"].any() and (ts["origin_blk"] != 0).any()


def _mixed(inst, cnt, pts, val):
    return {"points_and_obs": dict(points=pts, pts_valid=val, inst_type=inst,
                                   ray_count=cnt),
            "sensor_and_obs": dict(sensor_data=pts, sensor_kind="scan",
                                   inst_type=inst, ray_count=cnt),
            "half_obs": dict(inst_type=inst),
            "none": {}}


@pytest.mark.parametrize("mix", ["points_and_obs", "sensor_and_obs",
                                 "half_obs", "none"])
def test_replay_rejects_mixed_inputs(mix):
    cfg = tcfg.cow_lady_config(**SMALL)
    poses, scrolled, inst = _plan(cfg, canvas_geometry)
    K = len(poses)
    kw = _mixed(T(inst), torch.zeros(inst.shape, dtype=torch.int32),
                torch.zeros(K, 8, 3), torch.ones(K, 8, dtype=torch.bool))[mix]
    _, _, _, _, _, fence = ge.frame_inputs(cfg, device="cpu")
    with pytest.raises(ValueError, match="exactly one whole pair"):
        tpipe.replay_frames(MapState.create(cfg, "cpu"), poses, scrolled,
                            fence, cfg=cfg, origin_blk=np.zeros(3, np.int32),
                            input_pointcloud=False, **kw)


# ---------------------------------------------------------------------------
# no card: the entry points raise, they do not run on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["entry", "dryrun", "main", "main_dryrun"])
def test_entry_points_need_a_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"entry": lambda: ge.entry(),
           "dryrun": lambda: ge.dryrun_multichip(2),
           "main": lambda: ge.main([]),
           "main_dryrun": lambda: ge.main(["--dryrun", "2", "--repeat-card"])}
    with pytest.raises(RuntimeError, match="CUDA"):
        run[call]()
