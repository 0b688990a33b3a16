"""The driver's entry points on the port: one full-width map update and the
sharded dry run.

Counterpart of the repo's root __graft_entry__.py (the JAX package's
entry points).  `entry()` returns one forward map-update step on the
cow-lady preset (the headline case) with its example arguments;
`dryrun_multichip(n)` runs the JAX dry run's steps over an n-shard mesh
(parallel.mesh): one merge, a 10-frame replay with scrolls, confined-change
frames through the gate's slab levels, a raise event and one relax-engine
frame, with the JAX function's assertions.

    python -m gie_mapping_tpu_torch.graft_entry              # entry() on the card
    python -m gie_mapping_tpu_torch.graft_entry --dryrun 4   # 4 distinct cards
    python -m gie_mapping_tpu_torch.graft_entry --dryrun 4 --repeat-card
    python -m gie_mapping_tpu_torch.graft_entry --cpu [--dryrun N]

Both run on the card unless the caller names the CPU; neither falls back to
the CPU or to fewer devices.  The JAX file's persistent compile cache and
its switch to virtual CPU devices are TPU machinery with no counterpart
here: nothing is compiled per shape.
"""
from __future__ import annotations

import argparse
import functools
import hashlib

import numpy as np
import torch

from .map_state import (MapState, canvas_geometry, output_digest,
                        resolve_device, state_digest, state_to_numpy)
from .models import pipeline
from .parallel.mesh import Sharded, make_mesh, shard_state, to_numpy
from .utils.config import cow_lady_config
from .utils.constants import VOX_FREE, VOX_OCCUPIED, VOX_UNKNOWN

# the dry run's replay: pivot x per frame (voxels), incl. a 24-voxel jump
DRYRUN_STEPS = (0, 8, 8, 16, 24, 24, 48, 56, 64, 64)


def frame_inputs(cfg, seed: int = 0, device=None):
    """Deterministic example observation + geometry for one frame (the JAX
    file's _frame_inputs): (inst_type int8, ray_count int32 [X, Y, Z] on
    `device`, pvt, canvas_origin_blk, win_off host int32 triples, the empty
    fence (ll, ur, active, n)), as merge_frame takes them after the state.
    2 % of the window is VOX_OCCUPIED over VOX_FREE; the pivot is 0."""
    dev = resolve_device(device, "frame_inputs")
    rng = np.random.default_rng(seed)
    inst = np.full(cfg.local_size, VOX_FREE, np.int8)
    inst[rng.random(cfg.local_size) < 0.02] = VOX_OCCUPIED
    pvt = np.zeros(3, np.int32)
    origin_blk, _, off = canvas_geometry(cfg, pvt)
    M = cfg.max_ext_obs
    fence = (torch.zeros(M, 3, device=dev), torch.zeros(M, 3, device=dev),
             torch.zeros(M, dtype=torch.bool, device=dev), 0)
    return (torch.from_numpy(inst).to(dev),
            torch.zeros(cfg.local_size, dtype=torch.int32, device=dev),
            pvt, origin_blk, off, fence)


def merge_scrolled(state: MapState, inst_type, ray_count, pvt,
                   canvas_origin_blk, win_off, fence, *, cfg, mesh=None):
    """The JAX package's merge_frame_impl with do_scroll=True and
    input_pointcloud=False: the canvas scrolls to canvas_origin_blk where it
    is not there yet (scroll_step, its enter_shift passed on), then one
    merge_frame.  Returns (state', outputs)."""
    shift = None
    if not np.array_equal(np.asarray(canvas_origin_blk).reshape(3),
                          state.origin_blk.cpu().numpy()):
        state, shift = pipeline.scroll_step(state, canvas_origin_blk, cfg=cfg)
    return pipeline.merge_frame(state, inst_type, ray_count, pvt,
                                canvas_origin_blk, win_off, fence, cfg=cfg,
                                input_pointcloud=False, enter_shift=shift,
                                mesh=mesh)


def entry(device=None):
    """(fn, example_args): one forward map-update step on the cow-lady
    preset at full width (152x152x80 canvas, 100x100x30 window); fn(*args)
    returns (state', outputs).  The state starts at the origin (0, 0, 0),
    so the call scrolls the canvas to its pivot-0 origin first, as the JAX
    entry does."""
    cfg = cow_lady_config()
    dev = resolve_device(device, "entry")
    args = (MapState.create(cfg, dev),) + frame_inputs(cfg, device=dev)
    return functools.partial(merge_scrolled, cfg=cfg), args


# outputs that are host timings, not results
HOST_TIMINGS = ("gate_sync_ms",)


def output_shapes(out: dict) -> dict:
    """{name: shape} of a merge's outputs, as the JAX entry prints them."""
    return {k: tuple(np.shape(v)) for k, v in out.items()
            if k not in HOST_TIMINGS}


def array_sha(a) -> str:
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}|{a.shape}|".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def call_record(state: dict, out: dict, changed, per_frame=None) -> dict:
    """One merge or replay call of the dry run as digests and scalars, from
    numpy arrays (either package's): the state, the window outputs where
    they were emitted, the changed-block mask (changed_blk, or the replay's
    changed_union), gate_level, relax_iters and the replay's per_frame."""
    rec = {"state_sha": state_digest(state), "changed_sha": array_sha(changed),
           "gate_level": int(np.asarray(out["gate_level"])),
           "relax_iters": int(np.asarray(out["relax_iters"]))}
    if "dist_sq" in out:
        rec["out_sha"] = output_digest(*(np.asarray(out[k]) for k in
                                         ("glb_type", "dist_sq", "coc")))
    for k, v in (per_frame or {}).items():
        rec["pf_" + k] = np.asarray(v).astype(np.int64).tolist()
    return rec


def recorder(calls: list):
    """An on_call hook for dryrun_multichip that appends each call's
    call_record (port tensors, gathered from the mesh) to `calls`."""
    def on_call(state, out, changed, per_frame=None):
        calls.append(call_record(
            state_to_numpy(state),
            {k: to_numpy(v) if isinstance(v, (torch.Tensor, Sharded)) else v
             for k, v in out.items()}, to_numpy(changed),
            None if per_frame is None
            else {k: v.cpu().numpy() for k, v in per_frame.items()}))
    return on_call


def _require(cond, msg):
    """The JAX dry run's assertions, kept under python -O."""
    if not cond:
        raise AssertionError(msg)


def dryrun_config(n_devices: int):
    """The dry run's cow-lady-shaped config: 6.4 x 6.4 x 2.4 m at 0.1 m
    (112x112x72 canvas, 64x64x24 window), streaming off, the gate's size
    floor lifted so the small canvas takes the gated switch."""
    return cow_lady_config(
        local_size_m=(6.4, 6.4, 2.4), cutoff_dist=1.6,
        max_blocks=max(n_devices * 256, 2048),
        display_glb_edt=False, display_glb_ogm=False, edt_gate_min_vox=0)


def dryrun_multichip(n_devices: int, devices=None, on_call=None) -> dict:
    """The FULL frame update over an n-shard mesh (the canvas sharded along
    x, the archive along blocks where it divides), run long enough that
    scrolls, block churn, a raise event and intermediate gate levels all
    execute sharded: the JAX file's dryrun_multichip, step for step.

    devices: None for make_mesh(n_devices), n distinct cards (raises with
    fewer); or the mesh's devices, e.g. ["cuda:0"] * n (one card, n
    shards) or ["cpu"] * n.  on_call(state, outputs, changed, per_frame)
    runs after each merge and the replay (changed: changed_blk or the
    replay's changed_union; per_frame None for a merge).  Prints the JAX
    function's line and returns its numbers."""
    mesh = (make_mesh(n_devices) if devices is None
            else make_mesh(n_devices, devices=devices))
    hook = on_call or (lambda *a, **kw: None)
    home = mesh.home

    def merge(state, *inputs, cfg):
        state, out = merge_scrolled(state, *inputs, cfg=cfg, mesh=mesh)
        hook(state, out, out["changed_blk"])
        return state, out

    def dist_at(out, x, y, z):
        return float(to_numpy(out["dist_sq"])[x, y, z])

    # ---- phase A: cow-lady-shaped canvas, change-gated EDT on the mesh ----
    cfg = dryrun_config(n_devices)
    gmap = shard_state(MapState.create(cfg, home), mesh)
    inputs = frame_inputs(cfg, device=home)
    gmap, out = merge(gmap, *inputs, cfg=cfg)
    gate_levels = {int(out["gate_level"])}
    _require(tuple(out["dist_sq"].shape) == cfg.local_size,
             f"dist_sq shape {tuple(out['dist_sq'].shape)}")

    # the replay over the mesh: a 10-frame trajectory with repeated scrolls
    # and per-frame random occupancy (block churn + raise events: every
    # frame frees voxels a previous frame occupied)
    K = len(DRYRUN_STEPS)
    poses = np.zeros((K, 9, 3), np.float32)
    scrolled = np.zeros(K, bool)
    insts = []
    start = prev = gmap.origin_blk.cpu().numpy()
    for i, step in enumerate(DRYRUN_STEPS):
        pvt = np.asarray([step, 0, 0], np.int32)
        origin_blk, _, off = canvas_geometry(cfg, pvt)
        poses[i, 0], poses[i, 1], poses[i, 2] = pvt, origin_blk, off
        scrolled[i] = not np.array_equal(prev, origin_blk)
        prev = origin_blk
        insts.append(frame_inputs(cfg, seed=i + 1, device=home)[0])
    gmap, out2, changed, per_frame = pipeline.replay_frames(
        gmap, poses, scrolled, inputs[5], cfg=cfg, origin_blk=start,
        input_pointcloud=False, inst_type=torch.stack(insts),
        ray_count=torch.zeros((K,) + cfg.local_size, dtype=torch.int32,
                              device=home),
        mesh=mesh)
    hook(gmap, out2, changed, per_frame)
    n_scrolls = int(scrolled.sum())
    gate_levels.add(int(out2["gate_level"]))
    present_blocks = int(to_numpy(gmap.present).sum())

    # confined-change frames: a corner cluster then a half-canvas slab of
    # changes, so the gate's intermediate slab levels (not just smallest /
    # full) execute under the mesh.  Background VOX_UNKNOWN = unobserved, so
    # the flip bbox is exactly the cluster (+ prior raise sites).
    lx, ly, lz = cfg.local_size
    pvt = np.asarray([DRYRUN_STEPS[-1], 0, 0], np.int32)
    origin_blk, _, off = canvas_geometry(cfg, pvt)
    geom = (pvt, origin_blk, off)
    clusters = [
        (slice(0, 6), slice(0, 6)),              # corner -> smallest slab
        (slice(0, lx // 2), slice(0, ly // 2)),  # half-canvas -> mid slab
    ]
    raise_probe = None
    for sl in clusters:
        inst = np.full(cfg.local_size, VOX_UNKNOWN, np.int8)
        inst[sl[0], sl[1], lz // 2] = VOX_OCCUPIED
        gmap, outc = merge(gmap, torch.from_numpy(inst).to(home), inputs[1],
                           *geom, inputs[5], cfg=cfg)
        gate_levels.add(int(outc["gate_level"]))
        if raise_probe is None:
            raise_probe = dist_at(outc, 2, 2, lz // 2)
    # raise event: free the corner cluster (repeat so the hit-prob low-pass
    # actually clears it) and check the distance there RISES sharded
    inst = np.full(cfg.local_size, VOX_UNKNOWN, np.int8)
    inst[0:8, 0:8, :] = VOX_FREE
    inst = torch.from_numpy(inst).to(home)
    for _ in range(3):
        gmap, outr = merge(gmap, inst, inputs[1], *geom, inputs[5], cfg=cfg)
        gate_levels.add(int(outr["gate_level"]))
    raise_after = dist_at(outr, 2, 2, lz // 2)
    _require(raise_after > raise_probe,
             f"raise event did not execute: dist {raise_probe} -> {raise_after}")

    n_menu = len(pipeline._slab_menu(cfg.canvas_size,
                                     pipeline._menu_fracs(cfg)))
    # level n_menu = full recompute, n_menu+1 = zero-site constant fill
    _require(any(0 <= g < n_menu for g in gate_levels),
             f"no slab-level gated frame ran under the mesh: {sorted(gate_levels)}")
    _require(any(0 < g < n_menu for g in gate_levels),
             f"no intermediate gate level ran under the mesh: {sorted(gate_levels)}")

    # ---- phase B: relax engine (data-dependent fixed point) on the mesh ----
    # the reference-mirroring wavefront fixed point is the one program with
    # a convergence loop; it must ITERATE (not just run once) sharded
    cfg_r = cfg.replace(merge_mode="relax", fast_mode=False)
    gmap_r = shard_state(MapState.create(cfg_r, home), mesh)
    gmap_r, out_r = merge(gmap_r, *frame_inputs(cfg_r, seed=3, device=home),
                          cfg=cfg_r)
    relax_iters = int(out_r["relax_iters"])
    _require(relax_iters > 0, "relax fixed point never iterated under the mesh")

    print(f"dryrun_multichip({n_devices}): ok — relax_iters={relax_iters}, "
          f"present={present_blocks}, replay_frames={K}, "
          f"scrolls={n_scrolls}, gate_levels={sorted(gate_levels)}, "
          f"raise_dist {raise_probe}->{raise_after}")
    return {"n_devices": n_devices, "relax_iters": relax_iters,
            "present": present_blocks, "replay_frames": K,
            "scrolls": n_scrolls, "gate_levels": sorted(gate_levels),
            "raise_probe": raise_probe, "raise_after": raise_after,
            "merges": 1 + K + len(clusters) + 3 + 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="run dryrun_multichip(N) instead of entry()")
    ap.add_argument("--repeat-card", action="store_true",
                    help="the dry run's N shards on one card (cuda:0)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.dryrun is None:
        fn, fargs = entry("cpu" if args.cpu else None)
        _, out = fn(*fargs)
        if not args.cpu:
            torch.cuda.synchronize()
        print("entry: ok", output_shapes(out))
        return 0
    devices = (["cpu"] * args.dryrun if args.cpu
               else ["cuda:0"] * args.dryrun if args.repeat_card else None)
    dryrun_multichip(args.dryrun, devices=devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
