"""The port's per-stage profile (bench/parts.py), teleport bench, A/Bs and
synthetic bag on the CPU at reduced windows, held to the JAX package's
scripts (examples/bench_frame_parts.py, bench_merge_parts.py,
bench_teleport.py, bench_edt_gate_ab.py, bench_relax_ab.py,
make_synthetic_bag.py) on the same numpy inputs: the frozen state, each
frame stage's single call, the merge helpers against the JAX pieces, the
stages composed against one mapper frame and one _do_scroll, the teleport
arms' poses and end state, the A/B arms' end states, and the bag byte for
byte."""
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu import map_state as jms
from gie_mapping_tpu.cli import synthetic_frames as jax_synthetic_frames
from gie_mapping_tpu.models import pipeline as jpl
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.ops import fusion as jfusion
from gie_mapping_tpu.ops import raycast as jrc
from gie_mapping_tpu.ops import wave as jwave
from gie_mapping_tpu.ops.edt_batch import batch_edt as jax_batch_edt
from gie_mapping_tpu.runtime.datasets import BoxWorld as JaxBoxWorld
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import constants as jc
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.bench import ab, parts, suite, teleport
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models import pipeline as pl
from gie_mapping_tpu_torch.ops import fusion
from gie_mapping_tpu_torch.ops.wave import mark_frontiers
from gie_mapping_tpu_torch.runtime import synthetic_bag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import make_synthetic_bag as jax_bag  # noqa: E402

# reduced windows (0.2 m voxels, short cutoffs); the gate runs at any size
SMALL = dict(voxel_width=0.2, local_size_m=(3.2, 3.2, 1.6), cutoff_dist=0.8,
             max_blocks=512, edt_gate_min_vox=0)
PC_SMALL = dict(SMALL, max_raycast_points=1024)
SCRIPT_CFG = dict(display_glb_edt=False, display_glb_ogm=False)


def _small(case):
    return PC_SMALL if case in suite.POINTCLOUD_CASES else SMALL


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(state) -> dict:
    return {k: v.copy() for k, v in state_to_numpy(state).items()}


def _jnp(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _assert_same(got, want, msg):
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg}: {k}")


def _jax_freeze(case):
    """bench_frame_parts.py's frozen state and frame inputs, in the JAX
    package, at the reduced window."""
    cfg = jcfg.load_config(case, **{"max_raycast_points": parts.N_RAYS,
                                    **SCRIPT_CFG, **_small(case)})
    m = JaxMapper(cfg)
    for proj, (kind, payload) in jax_synthetic_frames(cfg, parts.N_WARM_FRAMES):
        if kind == "pointcloud":
            m.process_pointcloud(proj, payload)
        elif kind == "scan":
            m.process_scan2d(proj, *payload)
        elif kind == "depth":
            m.process_depth(proj, *payload)
        else:
            m.process_multiscan(proj, *payload)
    pvt, origin_blk, off = m._frame_geometry(np.asarray(proj.trans))
    fence, fence_on = m._fence_args(pvt)
    if kind == "pointcloud":
        world = JaxBoxWorld.corridor(seed=11, n_pillars=8,
                                     extent=max(cfg.local_size_m[:2]) * 0.7,
                                     height=max(1.5, cfg.local_size_m[2]))
        pts = world.pointcloud(proj, n_rays=parts.N_RAYS, seed=99,
                               max_range=0.8 * cfg.local_size_m[0])
        pb, vb = m.stage_pointcloud(pts)
        nt, np_ = jrc.panorama_bins(cfg.local_size)
        # the sensor model as the JAX frame program runs it (jitted), on
        # the eagerly transformed points (fuse_raycast off)
        project = jax.jit(functools.partial(
            jrc.pointcloud_project, local_size=cfg.local_size,
            voxel_width=cfg.voxel_width, ogm_min_h=cfg.ogm_min_h,
            ogm_max_h=cfg.ogm_max_h, for_motion_planner=cfg.for_motion_planner,
            robot_r2_grids=cfg.robot_r2_grids, n_theta=nt, n_phi=np_))
        inst, counts = project(proj.l2g(pb), vb, proj.trans, jnp.asarray(pvt))
    else:
        s = tuple(slice(o, o + w) for o, w in zip(off, cfg.local_size))
        inst = m.state.vox_type[s]
        counts = jnp.zeros(cfg.local_size, jnp.int32)
    return dict(cfg=cfg, mapper=m, state=m.state, kind=kind, pvt=pvt,
                origin_blk=origin_blk, off=off, fence=fence,
                fence_on=fence_on, inst=inst, counts=counts)


@pytest.fixture(scope="module")
def frozen():
    """case -> (the port's parts.Frozen, the JAX side's), made once."""
    cache = {}

    def get(case, with_jax=True):
        key = (case, with_jax)
        if key not in cache:
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                cache[key] = (parts.freeze(case, "cpu", _small(case)),
                              _jax_freeze(case) if with_jax else None)
            finally:
                torch.set_num_threads(n)
        return cache[key]
    return get


@functools.lru_cache(maxsize=None)
def _jax_merge_step(cfg, pointcloud, fence_on):
    return jax.jit(functools.partial(
        jpl.merge_frame_impl, cfg=cfg, input_pointcloud=pointcloud,
        do_scroll=False, use_fence=fence_on))


def _jax_merge(j, state):
    step = _jax_merge_step(j["cfg"], j["kind"] == "pointcloud", j["fence_on"])
    return step(state, j["inst"], j["counts"], jnp.asarray(j["pvt"]),
                jnp.asarray(j["origin_blk"]), jnp.asarray(j["off"]),
                *j["fence"])[0]


@pytest.mark.parametrize("case", ["cow_lady"])
def test_frozen_state_and_frame_stages_match_jax(case, frozen):
    """The state after the 8 warm frames and the frame's geometry against
    the JAX mapper's after run_case's synthetic frames; then each frame
    stage's single call against the function bench_frame_parts.py calls:
    merge_frame_impl(do_scroll=False), batch_edt, pointcloud_project, and
    _do_scroll compact and full, bit for bit."""
    fz, j = frozen(case)
    _assert_same(_np(fz.state), _jnp(j["state"]), f"{case} frozen state")
    for k in ("pvt", "origin_blk", "off"):
        np.testing.assert_array_equal(getattr(fz, k), j[k], err_msg=k)
    assert fz.fence_on == j["fence_on"]
    np.testing.assert_array_equal(fz.inst.numpy(), np.asarray(j["inst"]))
    np.testing.assert_array_equal(fz.counts.numpy(), np.asarray(j["counts"]))

    st = parts.frame_stages(fz)
    one = lambda name: st[name].step(st[name].init())
    _assert_same(_np(one("merge_full")), _jnp(_jax_merge(j, j["state"])),
                 f"{case} merge_full")
    cfg = j["cfg"]
    full = jax_batch_edt(j["state"].vox_type, max_width=sum(cfg.canvas_size))
    np.testing.assert_array_equal(
        one("edt_only").dist_sq.numpy(),
        np.asarray(jnp.where(full["valid"], full["dist_sq"],
                             j["state"].dist_sq)))
    if case == "cow_lady":
        inst, counts = one("sensor")
        np.testing.assert_array_equal(inst.numpy(), np.asarray(j["inst"]))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j["counts"]))
    # bench_frame_parts.py:178-183's compact sizes, then the full path
    cb = np.asarray(cfg.canvas_blocks, np.int64)
    nb = int(cb.prod())
    bound = nb - int((cb - [1, 0, 0]).clip(0).prod())
    rows = next((s for s in (256, 1024) if bound <= s <= nb), None)
    tgt = jnp.asarray(np.asarray(j["origin_blk"]) + [1, 0, 0], jnp.int32)
    for name, kw in (("scroll_step", dict(compact_rows=rows,
                                          compact_cols=parts.x_step_cols(cfg))),
                     ("scroll_teleport", {})):
        got, at = one(name)
        np.testing.assert_array_equal(at, j["origin_blk"] + [1, 0, 0])
        want = jax.jit(functools.partial(jms._do_scroll, cfg=cfg, **kw))(
            j["state"], tgt)
        _assert_same(_np(got), _jnp(want), f"{case} {name}")


@pytest.mark.parametrize("case", ["cow_lady", "scan2D", "depthcam", "laser3D"])
def test_sensor_then_merge_is_one_mapper_frame(case, frozen):
    """The sensor stage's call, then merge_full's, from the frozen state
    equals one process_* frame of the mapper on a copy of that state at the
    same pose, every MapState field bit for bit."""
    fz, _ = frozen(case, with_jax=case == "cow_lady")
    inst, counts = fz.sensor()
    got, _ = fz.merge(fz.state, inst, counts)
    assert parts.state_mismatch(got, fz.mapper_frame(fz.state)) == []


def test_merge_substages_match_jax_pieces(frozen):
    """bench_merge_parts.py's pieces on the frozen cow-lady frame: the
    low-pass of both packages, the block allocation against its full-canvas
    form (alloc_step), the window fusion, mark_frontiers and the changed
    blocks (changed_step) against JAX, each stage's single call."""
    fz, j = frozen("cow_lady")
    cfg = fz.cfg
    x = parts.merge_inputs(fz)
    off = x["off"]
    win = lambda a: jpl._crop(a, jnp.asarray(off), cfg.local_size)
    jst = j["state"]
    counts = j["counts"]
    # the low-pass, hit and miss (the miss probability as the jitted
    # program rounds -count / 10)
    oo, ot = win(jst.occ_val), win(jst.vox_type)
    pbty = jnp.minimum(1.0, (-counts).astype(jnp.float32) * jnp.float32(0.1))
    t = lambda a: torch.from_numpy(np.array(a))
    for v, alpha, palpha in ((jc.OCC_HIT_VAL, 1.0, 1.0),
                             (jc.OCC_FREE_VAL, pbty, t(pbty))):
        want = jfusion._lowpass(oo, ot, v, alpha, cfg.occupancy_threshold)
        got = fusion._lowpass(t(oo), t(ot), v, palpha, cfg.occupancy_threshold)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    st = parts.merge_stages(fz)
    one = lambda name: st[name].step(st[name].init())
    # alloc_step: the observed window's blocks, over the whole canvas
    bx, by, bz = cfg.canvas_blocks
    observed = counts != 0
    canvas_obs = jpl._uncrop(jnp.zeros(cfg.canvas_size, bool), observed,
                             jnp.asarray(off))
    needed = canvas_obs.reshape(bx, 8, by, 8, bz, 8).any((1, 3, 5))
    present = jst.present | needed
    np.testing.assert_array_equal(one("alloc_masks").present.numpy(),
                                  np.asarray(present))
    pvw = win(jpl._expand_blocks(present))
    np.testing.assert_array_equal(x["present_vox_win"].numpy(), np.asarray(pvw))
    # the window fusion (merge_frame_impl's, no fence box is active here)
    assert not fz.fence_on
    hit, miss = counts > 0, counts < 0
    occ_h, type_h = jfusion._lowpass(oo, ot, jc.OCC_HIT_VAL, 1.0,
                                     cfg.occupancy_threshold)
    occ_m, type_m = jfusion._lowpass(oo, ot, jc.OCC_FREE_VAL, pbty,
                                     cfg.occupancy_threshold)
    upd = pvw & (hit | miss)
    new_occ = jnp.where(upd, jnp.where(hit, occ_h, occ_m), oo)
    new_type = jnp.where(upd, jnp.where(hit, type_h, type_m), ot)
    fused = one("fusion_window")
    np.testing.assert_array_equal(
        fused.occ_val.numpy(),
        np.asarray(jpl._uncrop(jst.occ_val, new_occ, jnp.asarray(off))))
    np.testing.assert_array_equal(
        fused.vox_type.numpy(),
        np.asarray(jpl._uncrop(jst.vox_type, new_type, jnp.asarray(off))))
    # frontier_step
    glb = win(jst.vox_type)
    gt2, fnt = jwave.mark_frontiers(jst.vox_type, glb, jnp.asarray(off),
                                    cfg.local_size)
    np.testing.assert_array_equal(
        mark_frontiers(fz.state.vox_type, fz.state.vox_type[x["wb"]], off,
                       cfg.local_size).numpy(), np.asarray(fnt))
    np.testing.assert_array_equal(
        one("frontier").vox_type.numpy(),
        np.asarray(jpl._uncrop(jst.vox_type, gt2, jnp.asarray(off))))
    # changed_step on the window's changed types, within present blocks
    chg = jpl._uncrop(jnp.zeros(cfg.canvas_size, bool), new_type != ot,
                      jnp.asarray(off))
    want = (chg.reshape(bx, 8, by, 8, bz, 8).any((1, 3, 5)) | jst.present) \
        & jst.present
    np.testing.assert_array_equal(one("changed_blk").present.numpy(),
                                  np.asarray(want))
    vals, ms = pl._gate_readback([torch.arange(9, dtype=torch.int32)])
    assert vals == list(range(9)) and ms >= 0
    assert set(st) == {"noop_copy", "alloc_masks", "fusion_window", "gate_sync",
                       "limited_observe", "frontier", "changed_blk", "edt_only",
                       "merge_full"}


def test_scroll_steps_compose_to_do_scroll():
    """bench_scroll_parts.py's random state at a reduced window: the
    recorded steps of a one-block x scroll repeat bit for bit and compose
    to _do_scroll (compact and full columns), and every step is recorded."""
    cfg, st = parts.scroll_state("cow_lady", "cpu", SMALL)
    origin = st.origin_blk.numpy()
    for cols in (32, None):
        assert parts.scroll_composition(st, cfg, origin, cols) == []
    calls, _ = parts.scroll_step_calls(st, cfg, origin, 32)
    names = [c[0] for c in calls]
    assert names.count("directory") == 2 and names.count("compact_ids") == 2
    assert set(names) == set(parts.SCROLL_STEPS)


def test_parts_run_reduced(monkeypatch):
    """Every group on the CPU at a reduced window, K = 2 calls, one rep:
    the fixed stage names with ms, host_ms, wall_ms, launches and the null
    device fields, one JSON line each, the scroll line's glue, and the
    dispatch group's staged frames ending in the mapper loop's state."""
    monkeypatch.setattr(parts, "K", {g: 2 for g in parts.K})
    lines = parts.run("cpu", ("cow_lady",), cfg_overrides=PC_SMALL,
                      edt_cases=(("small", (48, 48, 24), 4, 12, 0.03),),
                      reps=1, dispatch_frames=4, emit=False)
    want = {
        "frame": {"merge_full", "edt_only", "sensor", "scroll_step",
                  "scroll_teleport"},
        "merge": {"noop_copy", "alloc_masks", "fusion_window", "gate_sync",
                  "limited_observe", "frontier", "changed_blk", "edt_only",
                  "merge_full"},
        "sensor": {"project", "l2g", "panorama", "carve", "sensor"},
        "edt": {"phase1", "phase2", "phase3", "glue", "batch_edt",
                "slab_rung0", "slab_rung1", "slab_rung2"},
        "scroll": set(parts.SCROLL_STEPS) | {"compact", "full"},
        "dispatch": {"mapper_loop", "staged_poses", "raw_dispatch"},
    }
    assert [line["group"] for line in lines] == list(parts.GROUPS)
    for line in lines:
        json.dumps(line)
        assert line["metric"] == "parts" and line["device"] == "cpu"
        assert set(line["stages"]) == want[line["group"]], line["group"]
        for rec in line["stages"].values():
            assert rec["ms"] > 0 and rec["host_ms"] > 0 and rec["wall_ms"] > 0
            assert rec["busy_ms"] is None and rec["ops"] is None
            assert rec["launches"] == {}  # CPU tensors launch no kernel
    scroll = lines[parts.GROUPS.index("scroll")]
    assert scroll["glue_ms"] == pytest.approx(
        scroll["stages"]["compact"]["ms"] - scroll["steps_sum_ms"])
    d = parts.dispatch_setup("cpu", PC_SMALL, frames=12)
    assert any(p[3] for p in d.plan)  # the frames scroll
    assert parts.dispatch_check(d) == []


def test_teleport_poses_and_end_state_match_jax():
    """The three arms' poses against bench_teleport.py's formula on
    bench_suite.py's circle; an every-1 arm at a reduced window (2
    frames: a jump out at frame 1 and back at frame 0) through the
    harness, its end
    state against the JAX mapper's batch replay of the same frames, and the
    online pass's jump frames found."""
    sys.path.insert(0, ROOT)
    from bench_suite import case_world_poses

    cfg = jcfg.load_config("depthcam", **SCRIPT_CFG, **SMALL)
    _, base, nb = case_world_poses(cfg, 40)
    jump = np.array([cfg.local_size_m[0] * 3.0, 0.0, 0.0], np.float32)
    pcfg = suite.load_config("depthcam", **suite.case_overrides("depthcam",
                                                                SMALL))
    _, arms, pjump, far = teleport.arm_poses(pcfg, 80)
    np.testing.assert_array_equal(pjump, jump)
    assert set(arms) == {"baseline", "teleport_every_40", "teleport_every_10"}
    for name, poses in arms.items():
        period = int(name.rsplit("_", 1)[1]) if name != "baseline" else None
        for i, p in enumerate(poses):
            q = base[i % nb]
            t = np.asarray(q.trans)
            if period and (i // period) % 2 == 1:
                t = t + jump
            np.testing.assert_array_equal(p.trans.numpy(), t)
            np.testing.assert_array_equal(p.rot.numpy(), np.asarray(q.rot))
    mappers = {}
    line = teleport.run("cpu", "depthcam", frames=2, reps=1, periods=(1,),
                        cfg_overrides=SMALL, mappers=mappers)
    assert set(line["best_ms"]) == {"baseline", "teleport_every_1"}
    on = line["online"]["teleport_every_1"]
    assert on["jump_frames"] == 2 and on["jump_frame_ms"]["max"] > 0
    # the JAX side: the same frames, 2 online, then the batch call (chunk
    # 40) twice (warm-up and the timed pass), then the online pass
    _, parms, _, _ = teleport.arm_poses(pcfg, 2, (1,))
    poses = [jgeo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
             for p in parms["teleport_every_1"]]
    poses = poses[:2] + poses
    world, _ = suite.ds.suite_world_circle(pcfg.local_size_m)
    _, data, sc = suite.make_frames("depthcam", pcfg, world,
                                    parms["teleport_every_1"][:2]
                                    + parms["teleport_every_1"])
    jm = JaxMapper(jcfg.load_config("depthcam", **suite.case_overrides(
        "depthcam", SMALL)))
    for i in range(2):
        jm.process_depth(poses[i], data[i], *sc)
    for _ in range(2):
        jm.process_depth_batch(poses[2:], jnp.asarray(data[2:]), *sc, chunk=40)
    for i in range(2, 4):
        jm.process_depth(poses[i], data[i], *sc)
    _assert_same(_np(mappers["teleport_every_1"].state), _jnp(jm.state),
                 "teleport_every_1 end state")


def _jax_arm(case, frames, chunk, reps, **ovr):
    """bench_edt_gate_ab.py's build_case in the JAX package, run as the
    harness runs an arm: 2 online frames, the batch call 1 + reps times."""
    cfg = jcfg.load_config(case, **suite.case_overrides(case, {**_small(case),
                                                               **ovr}))
    world, loop = suite.ds.suite_world_circle(cfg.local_size_m, frames)
    poses = loop[:2] + loop
    _, data, _ = suite.make_frames(case, cfg, world, poses)
    jposes = [jgeo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
              for p in poses]
    m = JaxMapper(cfg)
    pts, val = m.stage_pointcloud_batch(data)
    for i in range(2):
        m.process_pointcloud(jposes[i], pts[i], val[i])
    for _ in range(1 + reps):
        out = m.process_pointcloud_batch(jposes[2:], pts[2:], val[2:],
                                         chunk=chunk)
    return m.state, int(np.asarray(out.device("gate_level")))


@pytest.mark.parametrize("what", ["gate", "p1c"])
def test_gate_ab_arms_match_jax(what):
    """The gate and phase-1-cache A/Bs at a reduced cow-lady window (2
    frames a call, one rep): the "off" arm's end state against the JAX
    mapper's under the same config, the arms' maps equal (only the gate's
    own bookkeeping may differ), both arms' levels as JAX takes them."""
    states = {}
    line = ab.replay_ab(what, "cow_lady", "cpu", frames=2, reps=1,
                        cfg_overrides=PC_SMALL, states=states)
    assert set(line["best_ms"]) == {"off", "on"}
    assert set(line["state_diff"]) <= {"dmax_cell", "p1c", "p1c_ok"}
    want, level = _jax_arm("cow_lady", 2, ab.GATE_CHUNK, 1,
                           **ab.ARMS[what]["off"])
    _assert_same(_np(states["off"]), _jnp(want), f"{what} off")
    assert line["gate_level"]["off"][-1] == level
    assert line["gate_level"]["on"][-1] >= 0


def test_engine_ab_matches_jax(frozen):
    """bench_relax_ab.py's two arms on the frozen cow-lady frame (K = 2
    chained merges): each arm's state against the JAX package's
    merge_frame_impl chained under the same config."""
    fz, j = frozen("cow_lady")
    states = {}
    line = ab.engine_ab("cpu", reps=1, k=2, cfg_overrides=_small("cow_lady"),
                        states=states)
    assert line["relax_iters"]["relax"] > 0
    for name, cfg in (("canvas_edt", j["cfg"]),
                      ("relax", j["cfg"].replace(merge_mode="relax"))):
        st = j["state"]
        for _ in range(2):
            st = _jax_merge({**j, "cfg": cfg}, st)
        _assert_same(_np(states[name]), _jnp(st), f"engine {name}")


def test_ab_declines_unported_variants():
    for what in ("pmode", "combo", "stack"):
        with pytest.raises(ValueError, match="not ported"):
            ab.run("cpu", what)
        with pytest.raises(SystemExit):
            ab.main(["--what", what, "--cpu"])
    with pytest.raises(SystemExit):
        parts.main(["--groups", "frame,bogus", "--cpu"])


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_synthetic_bag_bytes_match_jax(compression, tmp_path):
    """make_bag at 3 frames x 256 rays: the port's file equals
    make_synthetic_bag.make_bag's byte for byte."""
    a, b = tmp_path / "port.bag", tmp_path / "jax.bag"
    n = synthetic_bag.make_bag(str(a), n_frames=3, n_rays=256,
                               compression=compression)
    assert n == jax_bag.make_bag(str(b), n_frames=3, n_rays=256,
                                 compression=compression) == 33
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("module,args", [
    (parts, ["--groups", "edt"]),
    (teleport, ["--frames", "2"]),
    (ab, ["--what", "gate"]),
    (synthetic_bag, ["{tmp}/x.bag", "--frames", "1", "--rays", "64", "--run"]),
])
def test_harness_raises_without_a_card(module, args, tmp_path):
    """Without --cpu each harness means the card, and raises without one
    (this machine has none)."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main([a.format(tmp=tmp_path) for a in args])
