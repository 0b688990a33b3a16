"""The JAX package's scenario tests as inputs and runners that either
package can run (numpy and the port only; no tests here).

tests/test_torch_scenarios_*.py run each scenario on the JAX package and
on the port (device "cpu") and compare the two records bit for bit;
tests/fixtures/make_torch_port_ref.py --only scenarios writes the JAX
package's records as digests (tests/fixtures/torch_port_scenarios_ref.npz),
and chip_smoke.py's scenarios phase runs the same runners on the card
against them.  A runner takes an `api` (port_api here, jax_api in
tests/test_torch_scenario_jax.py): the package's mapper, projection,
config module and merge step behind one interface.  Every input (the
scans, point clouds, poses and observation grids) is made here with numpy
from the JAX tests' own seeds, and both packages get the same arrays.

A record holds every frame's window outputs and scalars, the canvas
origins, the final MapState (every field, numpy), capacity_report(), the
CapacityWarning / CutoffNarrowedWarning texts, the text of a RuntimeError
raised under capacity_strict, and the host mirror's digest where
streaming is on.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from gie_mapping_tpu_torch import map_state as ms
from gie_mapping_tpu_torch.map_state import FIELDS, output_digest, state_digest
from gie_mapping_tpu_torch.models import mapper as mm
from gie_mapping_tpu_torch.models import pipeline as pp
from gie_mapping_tpu_torch.runtime import datasets as ds
from gie_mapping_tpu_torch.runtime.gt_checker import knn_errors
from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as geo
from gie_mapping_tpu_torch.utils.constants import (EMPTY_VALUE, VOX_FREE,
                                                   VOX_OCCUPIED, VOX_UNKNOWN)

EYE = np.eye(3, dtype=np.float32)
# the per-frame outputs a record keeps (window arrays, then scalars)
OUT_ARRAYS = ("glb_type", "dist_sq", "coc", "edt", "changed_blk")
OUT_SCALARS = ("fnt_count", "arch_dropped", "gate_level", "relax_iters")
WARNING_CLASSES = ("CapacityWarning", "CutoffNarrowedWarning")


def np_of(v):
    """A tensor (any device) or array as a numpy copy (a CPU tensor's
    numpy() and a JAX CPU array's asarray share memory that later frames
    may write in place)."""
    return (v.detach().cpu().numpy() if hasattr(v, "detach")
            else np.asarray(v)).copy()


def state_of(api, state):
    return {k: np.array(v) for k, v in api.state(state).items()}


# ---------------------------------------------------------------------------
# the port behind the runners' interface
# ---------------------------------------------------------------------------

def _proj(rot, trans):
    """A port Projection on the CPU."""
    return geo.Projection(torch.tensor(np.asarray(rot, np.float32)),
                          torch.tensor(np.asarray(trans, np.float32)))


def port_api(device="cpu"):
    """The port's mapper, projection, config and merge step on `device`."""
    dev = torch.device(device)

    def fence(cfg):
        m = cfg.max_ext_obs
        return (torch.zeros(m, 3, device=dev), torch.zeros(m, 3, device=dev),
                torch.zeros(m, dtype=torch.bool, device=dev), 0)

    def merge(cfg, state, inst, pvt, do_scroll=True):
        """One merge_frame of an observation grid at pivot pvt (scrolling
        the canvas first where its origin moves, as merge_frame_impl's
        do_scroll does).  Returns (state', outputs as numpy)."""
        pvt = np.asarray(pvt, np.int32)
        origin_blk, _, off = ms.canvas_geometry(cfg, pvt)
        shift = None
        if do_scroll and not np.array_equal(origin_blk,
                                            np_of(state.origin_blk)):
            state, shift = pp.scroll_step(state, origin_blk, cfg=cfg)
        state, out = pp.merge_frame(
            state, torch.as_tensor(np.asarray(inst, np.int8), device=dev),
            torch.zeros(cfg.local_size, dtype=torch.int32, device=dev),
            pvt, origin_blk, off, fence(cfg), cfg=cfg,
            input_pointcloud=False, enter_shift=shift)
        return state, {k: np_of(v) for k, v in out.items()}

    def scroll(cfg, state, origin_blk):
        return pp.scroll_step(state, np.asarray(origin_blk), cfg=cfg)[0]

    return SimpleNamespace(
        config=tcfg, Mapper=lambda cfg: mm.VolumetricMapper(cfg, device=dev),
        proj=_proj,
        from_pose=geo.Projection.from_pose,
        create=lambda cfg: ms.MapState.create(cfg, device=dev),
        state=ms.state_to_numpy, merge=merge, scroll=scroll,
        canvas_geometry=ms.canvas_geometry,
        zeros_blocks=lambda cb: torch.zeros(tuple(cb), dtype=torch.bool,
                                            device=dev))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def scan_frame(world, rot, trans, n_beams=360, **kw):
    """('scan', rot, trans, (ranges, theta_min, theta_inc)) of a 2-D LiDAR
    frame at the pose, the world simulated with numpy."""
    trans = np.asarray(trans, np.float32)
    r, tmin, tinc = world.scan_2d(_proj(rot, trans), n_beams=n_beams, **kw)
    return ("scan", np.asarray(rot, np.float32), trans, (r, tmin, tinc))


def shifted_scan(world, rot, trans, shift, n_beams=360):
    """A scan at trans of the world moved by `shift` metres along x (the
    JAX tests' ShiftedWorld): the world's scan at trans - shift."""
    trans = np.asarray(trans, np.float32)
    r, tmin, tinc = world.scan_2d(
        _proj(rot, trans - np.asarray([shift, 0, 0], np.float32)),
        n_beams=n_beams)
    return ("scan", np.asarray(rot, np.float32), trans, (r, tmin, tinc))


def orbit(n, radius=2.0, height=1.0):
    """circular_trajectory's poses as (rot, trans) numpy pairs."""
    return [(np_of(p.rot), np_of(p.trans))
            for p in ds.circular_trajectory(n, radius=radius, height=height)]


def world_moved(world, dx):
    """The world's boxes and bounds moved by dx metres along x."""
    d = np.asarray([dx, 0, 0], np.float32)
    return dataclasses.replace(world, boxes=world.boxes + d,
                               bounds_ll=world.bounds_ll + d,
                               bounds_ur=world.bounds_ur + d)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def frame_record(out):
    rec = {k: np_of(out.device(k)) for k in OUT_ARRAYS}
    for k in OUT_SCALARS:
        rec[k] = int(np_of(out.device(k)))
    rec["pvt"] = np.asarray(out.pvt, np.int64)
    return rec


def feed(api, mapper, frame):
    """One frame of a scenario through the package's online entry point."""
    kind, rot, trans, payload = frame
    p = api.proj(rot, trans)
    if kind == "scan":
        return mapper.process_scan2d(p, *payload)
    if kind == "pointcloud":
        return mapper.process_pointcloud(p, payload)
    if kind == "depth":
        return mapper.process_depth(p, *payload)
    return mapper.process_multiscan(p, *payload)


def _warnings(caught):
    return [[w.category.__name__, str(w.message)] for w in caught
            if w.category.__name__ in WARNING_CLASSES]


def run_frames(api, cfg, frames, *, drain=False, on_frame=None, clock=None):
    """Drive a mapper over the frames (then check_capacity, and with
    streaming on flush_stream).  drain: after the frames, stream ticks with
    no change until the rotation has served every column (the stream
    soak's drain).  on_frame(mapper, out): called after every frame, its
    results kept in the record's `extra`.  clock: a context manager
    factory whose value's `ms` is read after each frame's call (the record's
    `ms`).  Returns (mapper, record)."""
    m = api.Mapper(cfg)
    rec = {"frames": [], "origins": [], "leftover": [], "raised": None,
           "extra": [], "ms": []}
    streaming = cfg.display_glb_edt or cfg.display_glb_ogm
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            for fr in frames:
                if clock is None:
                    out = feed(api, m, fr)
                else:
                    with clock() as t:
                        out = feed(api, m, fr)
                    rec["ms"].append(t.ms)
                rec["frames"].append(frame_record(out))
                if on_frame is not None:
                    rec["extra"].append(on_frame(m, out))
                rec["origins"].append([int(v) for v in m._origin])
                rec["leftover"].append(int(m._last_leftover))
            m.check_capacity()
            if drain:
                cb = cfg.canvas_blocks
                k = cfg.stream_k_cols
                zeros = api.zeros_blocks(cb)
                for _ in range(-(-(cb[0] * cb[1]) // k) + 2):
                    m._stream({"changed_blk": zeros}, np.asarray(m._origin))
            if streaming:
                m.flush_stream()
        except RuntimeError as exc:
            rec["raised"] = str(exc)
    rec["warnings"] = _warnings(caught)
    rec["state"] = state_of(api, m.state)
    rec["capacity"] = {k: int(v) for k, v in m.capacity_report().items()}
    rec["mirror"] = (mirror_digest(m.mirror.blocks)
                     if getattr(m, "mirror", None) is not None else None)
    gt = getattr(m, "gt_checker", None)
    rec["gt"] = None if gt is None else [gt.last, gt.last_global]
    log = getattr(m, "logger", None)
    # the CSV rows without their two time columns
    rec["csv"] = None if log is None else [
        row.split(",")[2:] for row in log.getvalue().strip().splitlines()]
    return m, rec


def run_merges(api, cfg, steps, do_scroll=True):
    """merge_frame over (inst grid, pivot) steps from a fresh MapState;
    returns (state, record); the record also keeps the state after every
    step (`states`)."""
    state = api.create(cfg)
    rec = {"frames": [], "origins": [], "raised": None, "warnings": [],
           "capacity": None, "mirror": None, "states": []}
    for inst, pvt in steps:
        state, out = api.merge(cfg, state, inst, pvt, do_scroll)
        fr = {k: out[k] for k in ("glb_type", "dist_sq", "coc", "edt",
                                  "changed_blk")}
        fr.update({k: int(out[k]) for k in OUT_SCALARS})
        rec["frames"].append(fr)
        rec["origins"].append([int(v) for v in np_of(state.origin_blk)])
        rec["states"].append(state_of(api, state))
    rec["state"] = rec["states"][-1]
    return state, rec


def digest(rec) -> dict:
    """A record as strings and integers (the fixture's and the card's form):
    each frame's window-output sha256 over every array and scalar, the
    origins, the capacity report, the warning texts, the state sha256 and
    the mirror digest."""
    frames = []
    for fr in rec["frames"]:
        h = hashlib.sha256(output_digest(fr["glb_type"], fr["dist_sq"],
                                         fr["coc"]).encode())
        for k in sorted(fr):
            a = np.ascontiguousarray(fr[k])
            h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
            h.update(a.tobytes())
        frames.append(h.hexdigest())
    return {"frames": frames, "origins": json.dumps(rec["origins"]),
            "capacity": json.dumps(rec["capacity"], sort_keys=True),
            "warnings": json.dumps(rec["warnings"]),
            "raised": json.dumps(rec["raised"]),
            "state": state_digest(rec["state"]),
            "mirror": json.dumps(rec["mirror"])}


# ---------------------------------------------------------------------------
# the scenarios (the JAX tests' configs, worlds, poses and seeds)
# ---------------------------------------------------------------------------

FAR = 40000  # voxels: the far pivot of tests/test_world_extent.py


def extent_teleport(api):
    """test_world_extent.py::test_long_teleport_beyond_int16: map at the
    origin, teleport to x = +40,000 voxels (8 km at 0.2 m), map there, and
    return."""
    cfg = api.config.scan2d_config(local_size_m=(4.0, 4.0, 1.2),
                                   voxel_width=0.2, cutoff_dist=2.0,
                                   max_blocks=4096, fast_mode=False)
    world = ds.BoxWorld.corridor(seed=7, n_pillars=5, extent=3.0)
    far = FAR * cfg.voxel_width
    frames = [scan_frame(world, EYE, (0.0, 0.0, 0.6)),
              shifted_scan(world, EYE, (far, 0.0, 0.6), far),
              scan_frame(world, EYE, (0.0, 0.0, 0.6))]
    return (cfg, *run_frames(api, cfg, frames))


def extent_mirror(api):
    """test_world_extent.py::test_mirror_global_cocs_beyond_int16: two
    streamed frames at +40,000 voxels."""
    cfg = api.config.scan2d_config(
        local_size_m=(4.0, 4.0, 1.2), voxel_width=0.2, cutoff_dist=2.0,
        max_blocks=4096, fast_mode=False, display_glb_ogm=True,
        display_glb_edt=True, vis_interval=1)
    world = ds.BoxWorld.corridor(seed=8, n_pillars=4, extent=3.0)
    far = FAR * cfg.voxel_width
    frames = [shifted_scan(world, EYE, (far, 0.0, 0.6), far),
              shifted_scan(world, EYE, (far + 0.3, 0.0, 0.6), far)]
    return (cfg, *run_frames(api, cfg, frames))


def true_2d(api, merge_mode="canvas_edt"):
    """test_edge_cases.py::test_true_2d_map (a Z == 1 window), on either
    engine."""
    cfg = api.config.scan2d_config(
        local_size_m=(6.0, 6.0, 0.2), voxel_width=0.2, cutoff_dist=2.0,
        max_blocks=2048, ogm_min_h=-10, ogm_max_h=10, merge_mode=merge_mode)
    world = ds.BoxWorld.corridor(seed=4, n_pillars=3, extent=3.0)
    rot, trans = orbit(1, radius=0.5, height=0.0)[0]
    return (cfg, *run_frames(api, cfg, [scan_frame(world, rot, trans)]))


def empty_frame(api):
    """test_edge_cases.py::test_empty_observation_frame: a scan, then the
    same pose seeing nothing (every range NaN)."""
    cfg = api.config.scan2d_config(local_size_m=(3.2, 3.2, 1.6),
                                   voxel_width=0.2, max_blocks=1024)
    world = ds.BoxWorld.corridor(seed=4, n_pillars=2, extent=2.0)
    rot, trans = orbit(1, radius=0.3)[0]
    kind, rot, trans, (r, tmin, tinc) = scan_frame(world, rot, trans,
                                                   n_beams=90)
    frames = [(kind, rot, trans, (r, tmin, tinc)),
              (kind, rot, trans, (np.full_like(r, np.nan), tmin, tinc))]
    return (cfg, *run_frames(api, cfg, frames))


def fence_box0(api):
    """test_edge_cases.py::test_fence_box0_inactive: a robot far outside
    the default fence box 0 that sees nothing."""
    cfg = api.config.scan2d_config(local_size_m=(3.2, 3.2, 1.6),
                                   voxel_width=0.2, max_blocks=1024,
                                   for_motion_planner=True, robot_r=0.4)
    p = api.from_pose([50.0, 50.0, 1.0], [1, 0, 0, 0])
    frame = ("scan", np_of(p.rot), np_of(p.trans),
             (np.full(90, np.nan, np.float32), -np.pi, 2 * np.pi / 90))
    return (cfg, *run_frames(api, cfg, [frame]))


def _capacity_cfg(api, **kw):
    base = dict(local_size_m=(6.0, 6.0, 1.2), voxel_width=0.2,
                cutoff_dist=3.0, max_blocks=4096)
    base.update(kw)
    return api.config.scan2d_config(**base)


ARCHIVE_MODES = {"warn": {}, "strict": {"capacity_strict": True},
                 "silent": {"capacity_warn": False}}


def archive_drop(api, mode="warn"):
    """test_capacity.py's archive-exhaustion cases (max_blocks 8): a frame
    at the origin, then a teleport 40 m out that archives every block."""
    cfg = _capacity_cfg(api, max_blocks=8, **ARCHIVE_MODES[mode])
    world = ds.BoxWorld.corridor(seed=1, n_pillars=5, extent=4.0)
    frames = [scan_frame(world, EYE, (0.0, 0.0, 0.6), n_beams=120),
              scan_frame(world, EYE, (40.0, 0.0, 0.6), n_beams=120)]
    return (cfg, *run_frames(api, cfg, frames))


def stream_stall(api):
    """test_capacity.py::test_stream_stall_warns: one streamed column a
    tick against a backlog."""
    cfg = _capacity_cfg(api, display_glb_ogm=True, display_glb_edt=True,
                        vis_interval=1, stream_k_cols=1, stream_stall_ticks=2)
    world = ds.BoxWorld.corridor(seed=2, n_pillars=5, extent=4.0)
    frames = [scan_frame(world, r, t, n_beams=120)
              for r, t in orbit(5, radius=1.0)]
    return (cfg, *run_frames(api, cfg, frames))


def relax_cap(api):
    """test_capacity.py::test_relax_cap_warns: the relax engine with one
    sweep."""
    cfg = _capacity_cfg(api, merge_mode="relax", fast_mode=False,
                        max_relax_iters=1)
    world = ds.BoxWorld.corridor(seed=3, n_pillars=5, extent=4.0)
    frames = [scan_frame(world, EYE, (0.0, 0.0, 0.6), n_beams=120)]
    return (cfg, *run_frames(api, cfg, frames))


def _cutoff_cfg(api, fast, cutoff=1.6, merge_mode="canvas_edt"):
    return api.config.scan2d_config(
        local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, fast_mode=fast,
        cutoff_dist=cutoff, max_blocks=2048, for_motion_planner=False,
        merge_mode=merge_mode)


def _free(cfg):
    return np.full(cfg.local_size, VOX_FREE, np.int8)


def fastmode_stale(api, merge_mode="canvas_edt"):
    """test_long_cutoff.py::test_fastmode_out_of_window_voxel_keeps_stale:
    an obstacle observed, then observed free from a pivot whose window no
    longer holds the voxel it set."""
    cfg = _cutoff_cfg(api, True, cutoff=100.0, merge_mode=merge_mode)
    X, Y, Z = cfg.local_size
    inst = _free(cfg)
    inst[14, Y // 2, Z // 2] = VOX_OCCUPIED
    return (cfg, *run_merges(api, cfg, [(inst, [0, 0, 0]),
                                        (_free(cfg), [8, 0, 0])]))


def archived_stale(api):
    """test_long_cutoff.py::test_archived_block_stale_until_reentry: a
    voxel's block archived while its obstacle disappears, then back in the
    canvas beside a new obstacle."""
    cfg = _cutoff_cfg(api, False, cutoff=1.6)
    X, Y, Z = cfg.local_size
    ym, zm = Y // 2, Z // 2
    inst1 = _free(cfg)
    inst1[38 - 24, ym, zm] = VOX_OCCUPIED
    inst4 = _free(cfg)
    inst4[20 - 8, ym, zm] = VOX_OCCUPIED
    steps = [(inst1, [24, 0, 0]), (_free(cfg), [8, 0, 0]),
             (_free(cfg), [36, 0, 0]), (inst4, [8, 0, 0])]
    return (cfg, *run_merges(api, cfg, steps))


def invariants(api, fast):
    """test_state_invariants.py: six orbit frames of a scan."""
    cfg = api.config.scan2d_config(
        local_size_m=(4.0, 4.0, 1.2), voxel_width=0.2, fast_mode=fast,
        cutoff_dist=2.0, max_blocks=4096, for_motion_planner=False)
    world = ds.BoxWorld.corridor(seed=13, n_pillars=5, extent=3.0)
    frames = [scan_frame(world, r, t) for r, t in orbit(6, radius=1.2,
                                                         height=0.6)]
    return (cfg, *run_frames(api, cfg, frames))


def horizon_frames():
    """test_incremental_horizon.py's adversarial script: orbit, mutate the
    world (a pillar gone, a box new), walk (scrolls), teleport 30 m out and
    back."""
    base = ds.BoxWorld.corridor(seed=42, n_pillars=5, extent=3.0)
    removed = dataclasses.replace(base, boxes=base.boxes[1:])
    new_box = np.asarray([[[0.6, -1.4, 0.0], [1.1, -0.9, 1.2]]], np.float32)
    changed = dataclasses.replace(
        removed, boxes=np.concatenate([removed.boxes, new_box]))
    far = 30.0
    shifted = world_moved(changed, far)
    script = [
        (base, (0.0, 0.0)), (base, (0.6, 0.4)), (base, (-0.5, 0.6)),
        (changed, (0.0, 0.0)), (changed, (0.4, -0.5)),
        (changed, (1.6, 0.0)), (changed, (2.8, 0.6)),
        (shifted, (far, 0.0)), (shifted, (far + 0.5, 0.3)),
        (changed, (0.0, 0.0)), (changed, (-0.4, 0.5)),
    ]
    return [scan_frame(w, EYE, (x, y, 0.6)) for w, (x, y) in script]


def horizon(api, merge_mode, on_frame=None):
    cfg = api.config.scan2d_config(
        local_size_m=(6.0, 6.0, 1.2), voxel_width=0.2, cutoff_dist=3.0,
        max_blocks=4096, fast_mode=False, merge_mode=merge_mode,
        for_motion_planner=False)
    return (cfg, *run_frames(api, cfg, horizon_frames(), on_frame=on_frame))


def believed_occupied(state, cfg):
    """Global voxel coordinates of every obstacle a state believes in:
    occupied canvas voxels and occupied archived voxels of blocks whose
    canvas copy is not live (test_incremental_horizon.py's oracle set).
    `state` is either package's MapState."""
    vt = np_of(state.vox_type)
    org = np_of(state.origin_blk).astype(np.int64)
    pts = np.argwhere(vt == VOX_OCCUPIED) + org * 8
    n = int(np_of(state.n_arch))
    if n:
        keys = np_of(state.arch_keys)[:n].astype(np.int64)
        rows = np_of(state.a_packed)[:n].view(np.uint32)
        typ = ms.np_unpack_voxels(rows.reshape(n * 512, 3))[1].reshape(n, 8, 8, 8)
        cb = np.asarray(cfg.canvas_blocks)
        rel = keys - org
        inside = ((rel >= 0) & (rel < cb)).all(-1)
        present = np_of(state.present)
        stale = inside.copy()
        stale[inside] = present[tuple(rel[inside].T)]
        w = np.argwhere((typ == VOX_OCCUPIED) & ~stale[:, None, None, None])
        if len(w):
            pts = np.concatenate([pts, keys[w[:, 0]] * 8 + w[:, 1:]])
    return pts


def global_accuracy(api):
    """test_global_accuracy.py: six streamed orbit frames."""
    cfg = api.config.scan2d_config(
        local_size_m=(6.0, 6.0, 1.2), voxel_width=0.2, cutoff_dist=4.0,
        max_blocks=4096, fast_mode=False, display_glb_edt=True,
        display_glb_ogm=True)
    world = ds.BoxWorld.corridor(seed=21, n_pillars=5, extent=3.0)
    frames = [scan_frame(world, r, t) for r, t in orbit(6, radius=1.2,
                                                         height=0.7)]
    return (cfg, *run_frames(api, cfg, frames))


def gt_global(api, **kw):
    """test_gt_global.py: four streamed orbit frames with the global RMS
    check on (kw: profile_loc_rms)."""
    cfg = api.config.scan2d_config(
        local_size_m=(6.0, 6.0, 1.2), voxel_width=0.2, cutoff_dist=3.0,
        max_blocks=4096, display_glb_ogm=True, display_glb_edt=True,
        vis_interval=1, profile_glb_rms=True, **kw)
    world = ds.BoxWorld.corridor(seed=5, n_pillars=4, extent=4.0)
    frames = [scan_frame(world, r, t, n_beams=180)
              for r, t in orbit(4, radius=1.0)]
    return (cfg, *run_frames(api, cfg, frames))


def soak_frames():
    """test_stream_soak.py's 130-frame random walk (seed 17) with
    teleports at frames 40 and 80."""
    world = ds.BoxWorld.corridor(seed=5, n_pillars=6, extent=3.0, height=1.4)
    rng = np.random.default_rng(17)
    pos = np.zeros(2)
    frames = []
    for i in range(130):
        if i in (40, 80):
            pos = np.asarray([8.0, -6.0]) if i == 40 else np.zeros(2)
        else:
            pos = np.clip(pos + rng.uniform(-0.4, 0.4, 2), -2.5, 2.5)
        frames.append(scan_frame(world, EYE, (pos[0], pos[1], 0.6),
                                 n_beams=90, max_range=8.0))
    return frames


def soak(api, gate):
    cfg = api.config.scan2d_config(
        local_size_m=(4.8, 4.8, 1.2), voxel_width=0.2, fast_mode=True,
        cutoff_dist=1.6, max_blocks=8192, for_motion_planner=False,
        display_glb_ogm=True, display_glb_edt=True, vis_interval=1,
        stream_k_cols=4, stream_stall_ticks=1000, edt_gate=gate,
        edt_gate_min_vox=0)
    return (cfg, *run_frames(api, cfg, soak_frames(), drain=True))


def engines_first_frame(api, merge_mode, fast, seed):
    """test_engine_consistency.py::test_engines_agree_on_first_frame: one
    random observation grid (3 % occupied, 20 % unknown) merged into a
    fresh map."""
    cfg = api.config.scan2d_config(
        local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, fast_mode=fast,
        cutoff_dist=4.0, max_blocks=2048, for_motion_planner=False,
        merge_mode=merge_mode)
    rng = np.random.default_rng(seed)
    inst = np.full(cfg.local_size, VOX_FREE, np.int8)
    inst[rng.random(cfg.local_size) < 0.03] = VOX_OCCUPIED
    inst[rng.random(cfg.local_size) < 0.2] = VOX_UNKNOWN
    _, rec = run_merges(api, cfg, [(inst, [0, 0, 0])])
    return cfg, inst, rec


def dda_mapper(api):
    """test_engine_consistency.py::test_dda_mode_through_mapper: one cloud
    of 1,024 rays through the exact DDA walk."""
    cfg = api.config.scan2d_config(
        local_size_m=(4.0, 4.0, 1.6), voxel_width=0.2, max_blocks=2048,
        raycast_mode="dda", max_raycast_points=1024, data_case="cow_lady")
    world = ds.BoxWorld.corridor(seed=6, n_pillars=3, extent=2.5)
    rot, trans = orbit(1, radius=0.5, height=0.8)[0]
    pts = world.pointcloud(_proj(rot, trans), n_rays=1024, max_range=3.0,
                           seed=0)
    return (cfg, *run_frames(api, cfg, [("pointcloud", rot, trans, pts)]))


def _e2e_cfg(api):
    return api.config.scan2d_config(local_size_m=(6.0, 6.0, 1.2),
                                    voxel_width=0.2, cutoff_dist=3.0,
                                    max_blocks=4096)


def e2e_scan2d(api, which):
    """test_e2e_scan2d.py: `run` (four orbit frames), `frontier` (one
    half-resolution scan) or `repeat` (one scan twice)."""
    cfg = _e2e_cfg(api)
    if which == "run":
        world = ds.BoxWorld.corridor(seed=3, n_pillars=4, extent=4.0)
        frames = [scan_frame(world, r, t, n_beams=180)
                  for r, t in orbit(4, radius=1.0, height=1.0)]
    elif which == "frontier":
        world = ds.BoxWorld.corridor(seed=5, n_pillars=2, extent=4.0)
        frames = [scan_frame(world, *orbit(1, radius=0.5)[0], n_beams=90)]
    else:
        world = ds.BoxWorld.corridor(seed=7, n_pillars=3, extent=4.0)
        frames = [scan_frame(world, *orbit(1, radius=0.5)[0])] * 2
    return (cfg, *run_frames(api, cfg, frames))


def fusion_pivots(n_frames, teleports, seed):
    """test_fusion_sim.py's pivots and observation grids: a random walk of
    the pivot with teleports to (60, -40, 0) and back; 40 % of the window
    observed, 15 % of that occupied, half the rest free."""
    rng = np.random.default_rng(seed)
    pivots = []
    p = np.zeros(3, int)
    for i in range(n_frames):
        if i in teleports:
            p = (np.asarray([60, -40, 0]) if len(pivots) % 2 == 0
                 else np.zeros(3, int))
        else:
            p = p + rng.integers(-3, 4, 3) * np.asarray([1, 1, 0])
        pivots.append(p.copy())
    return rng, pivots


def fusion_fuzz(api, n_frames, teleports, seed):
    """test_fusion_sim.py's horizon: scroll_step then merge_frame (no
    in-frame scroll) at each pivot.  Returns (cfg, steps, record); steps
    are the (inst grid, pivot) pairs."""
    cfg = api.config.scan2d_config(
        local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2, fast_mode=True,
        cutoff_dist=2.0, max_blocks=4096, for_motion_planner=False)
    rng, pivots = fusion_pivots(n_frames, teleports, seed)
    steps = []
    for pvt in pivots:
        inst = np.full(cfg.local_size, VOX_UNKNOWN, np.int8)
        mask = rng.random(cfg.local_size) < 0.4
        inst[mask & (rng.random(cfg.local_size) < 0.15)] = VOX_OCCUPIED
        inst[mask & (inst == VOX_UNKNOWN)
             & (rng.random(cfg.local_size) < 0.5)] = VOX_FREE
        steps.append((inst, pvt))
    state = api.create(cfg)
    origin = None
    rec = {"frames": [], "origins": [], "raised": None, "warnings": [],
           "capacity": None, "mirror": None}
    for inst, pvt in steps:
        origin_blk, _, _ = api.canvas_geometry(cfg, pvt)
        if origin is None or not np.array_equal(origin, origin_blk):
            state = api.scroll(cfg, state, origin_blk)
            origin = origin_blk
        state, out = api.merge(cfg, state, inst, pvt, do_scroll=False)
        rec["frames"].append({k: np_of(out[k])
                              for k in ("glb_type", "dist_sq", "coc")})
        rec["origins"].append([int(v) for v in origin])
    rec["state"] = state_of(api, state)
    return cfg, steps, rec


CASES = ("scan2D", "cow_lady", "ugv_corridor", "depthcam", "laser3D",
         "uav_raycast_fine")


def case_end_to_end(api, case):
    """test_all_cases.py: two orbit frames of the case's own sensor at a
    6 x 6 x 1.6 m window of 0.2 m voxels."""
    cfg = api.config.load_config(case, local_size_m=(6.0, 6.0, 1.6),
                                 voxel_width=0.2, max_blocks=4096,
                                 cutoff_dist=2.0, max_raycast_points=4096)
    world = ds.BoxWorld.corridor(seed=1, n_pillars=4, extent=3.5)
    frames = []
    for i, (rot, trans) in enumerate(orbit(2, radius=0.8, height=0.8)):
        p = _proj(rot, trans)
        if case in ("cow_lady", "ugv_corridor", "uav_raycast_fine"):
            frames.append(("pointcloud", rot, trans,
                           world.pointcloud(p, n_rays=4096, seed=i,
                                            max_range=5.0)))
        elif case == "scan2D":
            frames.append(scan_frame(world, rot, trans, n_beams=180))
        elif case == "depthcam":
            frames.append(("depth", rot, trans, world.depth_image(p)))
        else:
            frames.append(("multiscan", rot, trans,
                           world.multiscan(p, scan_num=180)))
    return (cfg, *run_frames(api, cfg, frames))


# the scenarios chip_smoke.py runs on the card and the fixture holds, by
# name: (runner, keyword arguments)
CHIP = {
    "extent_teleport": (extent_teleport, {}),
    "extent_mirror": (extent_mirror, {}),
    "true_2d_canvas": (true_2d, {}),
    "true_2d_relax": (true_2d, {"merge_mode": "relax"}),
    "empty_frame": (empty_frame, {}),
    "fence_box0": (fence_box0, {}),
    "archive_warn": (archive_drop, {"mode": "warn"}),
    "archive_strict": (archive_drop, {"mode": "strict"}),
    "stream_stall": (stream_stall, {}),
    "relax_cap": (relax_cap, {}),
    "fastmode_stale_canvas": (fastmode_stale, {}),
    "fastmode_stale_relax": (fastmode_stale, {"merge_mode": "relax"}),
    "archived_stale": (archived_stale, {}),
    "horizon_canvas": (horizon, {"merge_mode": "canvas_edt"}),
    "horizon_relax": (horizon, {"merge_mode": "relax"}),
    "soak_gate": (soak, {"gate": True}),
}


def run_chip(api, name):
    """(cfg, mapper or state, record) of a CHIP scenario."""
    fn, kw = CHIP[name]
    return fn(api, **kw)


# ---------------------------------------------------------------------------
# the full-width far-pivot run of the cow_lady preset (card only)
# ---------------------------------------------------------------------------

COW_FAR_VOXELS = 40000  # x of the far frames, in voxels (4,000 m at 0.1 m)


def cow_far_frames():
    """The cow_lady preset's own defaults (131,072 points a frame,
    streaming on): 3 frames near the origin, 3 at x = +40,000 voxels (the
    world moved with them), then 2 back near the origin.  Returns the
    frames as ('pointcloud', rot, trans, points)."""
    world = ds.BoxWorld.corridor(seed=3, n_pillars=8, extent=6.0, height=2.5)
    far = COW_FAR_VOXELS * 0.1
    moved = world_moved(world, far)
    path = [(world, 0.0, (0.0, 0.0)), (world, 0.0, (0.5, 0.2)),
            (world, 0.0, (1.0, 0.4)),
            (moved, far, (0.0, 0.0)), (moved, far, (0.5, -0.2)),
            (moved, far, (1.0, -0.4)),
            (world, 0.0, (0.6, 0.3)), (world, 0.0, (0.0, 0.0))]
    frames = []
    for i, (w, dx, (x, y)) in enumerate(path):
        yaw = 0.3 * i
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        trans = np.asarray([dx + x, y, 1.2], np.float32)
        pts = w.pointcloud(_proj(rot, trans), n_rays=ds.COW_SLICE_RAYS,
                           max_range=8.0, seed=i)
        frames.append(("pointcloud", rot, trans, pts))
    return frames


def cow_far(api, frames=None, clock=None):
    cfg = api.config.cow_lady_config()
    return (cfg, *run_frames(api, cfg, frames or cow_far_frames(),
                             clock=clock))


def mirror_max_global_x(mirror) -> int:
    """The largest global x coc of a valid voxel in the mirror's blocks."""
    best = -(1 << 31)
    for blk in mirror.blocks.values():
        c = blk["coc"]
        valid = (c[..., 0] != 32767)
        if valid.any():
            best = max(best, int(c[..., 0][valid].max()))
    return best



# ---------------------------------------------------------------------------
# the 500-frame RMSE soak (tests/test_soak_rmse.py), the port only
# ---------------------------------------------------------------------------

SOAK_VW = 0.2
SOAK_FRAMES = 500


def soak_rmse_worlds():
    """The soak's corridor (seed 21) and its three mutations: pillar k
    dropped and a box added, k = 1, 2, 3."""
    base = ds.BoxWorld.corridor(seed=21, n_pillars=6, extent=3.0, height=1.4)
    worlds = [base]
    for k in range(1, 4):
        w = dataclasses.replace(base, boxes=np.delete(base.boxes, k, axis=0))
        nb = np.asarray([[[-0.8 + 0.5 * k, 0.9, 0.0],
                          [-0.3 + 0.5 * k, 1.4, 1.2]]], np.float32)
        worlds.append(dataclasses.replace(
            w, boxes=np.concatenate([w.boxes, nb])))
    return worlds


def soak_rmse(api, n_frames=SOAK_FRAMES):
    """test_soak_rmse.py's soak on the package behind `api`: the gated
    canvas engine on a 4.8 x 4.8 x 1.2 m window of 0.2 m voxels; a random
    walk (seed 33) with teleports out 25 m at frame 150 and back at 300,
    the world mutated every 50 frames, a fence box appended at i % 120 ==
    60 and the fence cleared back to box 0 at i % 120 == 0; after every
    frame the published window EDT against the exact 1-NN
    (gt_checker.knn_errors) over the believed-occupied set, canvas and
    archive.  A CapacityWarning raises (the JAX test turns it into an
    error).  Returns {"curve": a row per checked frame, "capacity":
    capacity_report(), "frames": n_frames}."""
    cfg = api.config.scan2d_config(
        local_size_m=(4.8, 4.8, 1.2), voxel_width=SOAK_VW, cutoff_dist=2.4,
        max_blocks=8192, fast_mode=False, for_motion_planner=False,
        edt_gate_min_vox=0)
    worlds = soak_rmse_worlds()
    mapper = api.Mapper(cfg)
    rng = np.random.default_rng(33)
    pos = np.zeros(2)
    tele = 0.0
    curve = []
    with warnings.catch_warnings():
        warnings.simplefilter("error", mm.CapacityWarning)
        for i in range(n_frames):
            if i == 150:
                tele = 25.0
            elif i == 300:
                tele = 0.0
            else:
                pos = np.clip(pos + rng.uniform(-0.35, 0.35, 2), -2.2, 2.2)
            world = worlds[(i // 50) % len(worlds)]
            if tele:
                world = world_moved(world, tele)
            if i % 120 == 60:
                c = np.asarray([pos[0] + tele + 0.9, pos[1], 0.4], np.float32)
                mapper.ext_obs.append(c - 0.25, c + 0.25)
            elif i % 120 == 0 and i:
                mapper.ext_obs.n = 1
            trans = np.asarray([pos[0] + tele, pos[1], 0.6], np.float32)
            r, tmin, tinc = world.scan_2d(_proj(EYE, trans), n_beams=360)
            out = mapper.process_scan2d(api.proj(EYE, trans), r, tmin, tinc)
            d = out.dist_sq
            v = (d < EMPTY_VALUE) & out.seen
            occ = believed_occupied(mapper.state, cfg)
            if len(occ) and v.any():
                q = np.argwhere(v)
                sub = slice(None, None, max(1, len(q) // 400))
                vg = (q[sub] + out.pvt) * SOAK_VW
                edt_m = np.sqrt(d[v][sub].astype(float)) * SOAK_VW
                rmse, mx, _ = knn_errors(occ * SOAK_VW, vg, edt_m)
                curve.append({
                    "frame": i, "rmse_m": rmse, "max_err_m": mx,
                    "n_arch": int(np_of(mapper.state.n_arch)),
                    "arch_dropped": mapper.capacity_report()["arch_dropped"],
                    "gate_level": int(np_of(out.device("gate_level")))})
    return {"curve": curve, "capacity": mapper.capacity_report(),
            "frames": n_frames}


def soak_rmse_faults(rec) -> list:
    """test_soak_rmse.py's assertions on a soak record: each one that
    fails, as text (empty when the soak holds)."""
    bad = [f"frame {r['frame']}: rmse {r['rmse_m']} > {SOAK_VW}"
           for r in rec["curve"] if not r["rmse_m"] <= SOAK_VW]
    bad += [f"frame {r['frame']}: max error {r['max_err_m']} > {SOAK_VW}"
            for r in rec["curve"]
            if not r["max_err_m"] <= SOAK_VW * (1.0 + 1e-6)]
    if rec["capacity"]["arch_dropped"] != 0:
        bad.append(f"arch_dropped {rec['capacity']['arch_dropped']}")
    if not len(rec["curve"]) > rec["frames"] * 0.9:
        bad.append(f"the oracle ran on {len(rec['curve'])} of "
                   f"{rec['frames']} frames")
    return bad
