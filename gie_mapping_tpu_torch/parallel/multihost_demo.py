"""Multi-process sharded mapping demo (the JAX package's
examples/multihost_demo.py, over torch.distributed).

Runs the frame update with the map state sharded over a mesh that spans
several processes: one rank each, driving `--devices-per-proc` local
devices (CPU devices on gloo with --cpu; one card per rank on NCCL).

Usage (per process):
    python -m gie_mapping_tpu_torch.parallel.multihost_demo <process_id> \\
        <num_processes> [--coordinator 127.0.0.1:45688] \\
        [--devices-per-proc 2] [--out out.npz] [--frames 2] [--cpu]
or under torchrun, which gives the rank, the world size and the address
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK):
    torchrun --nproc-per-node N -m gie_mapping_tpu_torch.parallel.multihost_demo \\
        --devices-per-proc 1 [--out out.npz]
Under torchrun the process group is made even for a world of one, so every
collective runs; with positional arguments only when num_processes > 1.

The frames are the JAX demo's (scan2D-style window, random observations,
the pivot moving 4 voxels a frame in x, through merge_frame), with
`--cases` adding the gated EDT and the relax engine; `--slice` runs the
cow-lady slice instead (the cow_lady preset's width, 131072 points a frame,
through VolumetricMapper.process_pointcloud).  Process 0 writes each
frame's window outputs and the final state (gathered) to --out, for a
bitwise comparison with a single-process run.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import time

import numpy as np
import torch

DEMO_CASES = {"canvas": {}, "gated": {"edt_gate_min_vox": 0},
              "relax": {"merge_mode": "relax"}}
OUTPUTS = ("edt", "glb_type", "dist_sq", "coc", "ogm_changed", "changed_blk",
           "gate_level", "relax_iters", "fnt_count")


def demo_config(case: str = "canvas"):
    """The JAX demo's config (its cases: the default canvas engine, gated,
    relax)."""
    from ..utils.config import scan2d_config

    return scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2,
                         fast_mode=False, cutoff_dist=2.0, max_blocks=1024,
                         for_motion_planner=False, **DEMO_CASES[case])


def demo_frame(cfg, i):
    """Frame i of the JAX demo: (inst_type int8 window, pivot)."""
    from ..utils.constants import VOX_FREE, VOX_OCCUPIED

    rng = np.random.default_rng(i)
    inst = np.full(cfg.local_size, VOX_FREE, np.int8)
    inst[rng.random(cfg.local_size) < 0.03] = VOX_OCCUPIED
    return inst, np.asarray([4 * i, 0, 0], np.int32)


def kernel_wrappers() -> dict:
    """{name: wrapper} of the port's kernels (each keeps a launch count)."""
    from ..ops.kernels import blockrows as kb
    from ..ops.kernels import carve as kc
    from ..ops.kernels import envelope as ke
    from ..ops.kernels import phase1 as kp
    from ..ops.kernels import shift as ks

    return {"phase1": kp.phase1_packed, "envelope_packed": ke.envelope_packed,
            "envelope_mid": ke.envelope_mid, "panorama": kc.panorama,
            "carve": kc.carve, "envelope": ke.envelope,
            "shift_canvas": ks.shift_canvas,
            "gather_block_rows": kb.gather_block_rows,
            "scatter_block_rows": kb.scatter_block_rows,
            "gather_archive_rows": kb.gather_archive_rows,
            "scatter_archive_rows": kb.scatter_archive_rows}


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def run_demo(case, frames, mesh, device) -> dict:
    """The JAX demo's frames through scroll_step + merge_frame; returns
    {"<case>/<frame>/<output>": array, "<case>/state/<field>": array}."""
    from ..map_state import MapState, canvas_geometry, state_to_numpy
    from ..models.pipeline import merge_frame, scroll_step

    cfg = demo_config(case)
    st = (MapState.create(cfg, mesh=mesh) if mesh is not None
          else MapState.create(cfg, device))
    dev = mesh.home if mesh is not None else torch.device(device)
    M = cfg.max_ext_obs
    fence = (torch.zeros(M, 3, device=dev), torch.zeros(M, 3, device=dev),
             torch.zeros(M, dtype=torch.bool, device=dev), 0)
    out_np = {}
    for i in range(frames):
        inst, pvt = demo_frame(cfg, i)
        origin_blk, _, off = canvas_geometry(cfg, pvt)
        shift = None
        if not np.array_equal(origin_blk, st.origin_blk.cpu().numpy()):
            st, shift = scroll_step(st, origin_blk, cfg=cfg)
        st, out = merge_frame(
            st, torch.from_numpy(inst).to(dev),
            torch.zeros(cfg.local_size, dtype=torch.int32, device=dev), pvt,
            origin_blk, off, fence, cfg=cfg, input_pointcloud=False,
            enter_shift=shift, mesh=mesh)
        for k in OUTPUTS:
            out_np[f"{case}/{i}/{k}"] = _host(out[k])
    for k, v in state_to_numpy(st).items():
        out_np[f"{case}/state/{k}"] = v
    return out_np


def collective_us(mesh, state, cfg, calls: int = 50) -> dict:
    """Host microseconds per call of the mesh's collectives on a placed
    state (perf_counter over `calls` calls, one device sync after them):
    the gate's all-reduce of nine int32 scalars, the window crop of a
    canvas field (fetch_rows to each process's home), an x-halo exchange
    of the coc field, a block-any reduction of a canvas mask and a
    reshard of the sharded EDT (all_to_all of a phase-1 word array)."""
    from .mesh import (all_reduce, all_to_all, block_reduce, crop, parts_of,
                       smap, x_halo)

    dev = mesh.home
    off = [(c - l) // 2 for c, l in zip(cfg.canvas_size, cfg.local_size)]
    box = tuple(slice(o, o + l) for o, l in zip(off, cfg.local_size))
    nine = [torch.zeros(9, dtype=torch.int32, device=p.device)
            for p in parts_of(state.vox_type)]
    words = [p.to(torch.int32).permute(0, 2, 1).contiguous()
             for p in parts_of(state.vox_type)]
    jobs = {"all_reduce_9": lambda: all_reduce(mesh, nine, "max"),
            "window_crop": lambda: crop(state.dist_sq, box),
            "x_halo_coc": lambda: x_halo(state.coc, 0),
            "block_any": lambda: block_reduce(
                smap(lambda t: t != 0, state.vox_type), 8, "any", False),
            "reshard_edt": lambda: all_to_all(words, 1, 0, mesh)}
    out = {}
    for name, fn in jobs.items():
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) * 1e6 / calls
    return out


def run_slice(frames, mesh, device) -> dict:
    """The cow-lady slice through VolumetricMapper.process_pointcloud;
    returns per-frame output digests, gate levels and ms, the final state's
    digests and each kernel's launches over the frames."""
    from ..map_state import output_digest, state_digest, state_to_numpy
    from ..models.mapper import VolumetricMapper
    from ..runtime.datasets import COW_SLICE_RAYS, cow_lady_slice
    from ..utils import geometry as geo
    from ..utils.config import cow_lady_config

    overrides, world, poses = cow_lady_slice()
    poses = poses[:frames]
    m = VolumetricMapper(cow_lady_config(**overrides),
                         device=None if mesh is not None else device, mesh=mesh)
    m.warmup(robot_pos=poses[0][0])
    clouds = [m.stage_pointcloud(world.pointcloud(
        geo.Projection.from_pose(*p), n_rays=COW_SLICE_RAYS, max_range=8.0,
        seed=i)) for i, p in enumerate(poses)]
    sha, ms, levels = [], [], []
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    for (pos, quat), (pts, val) in zip(poses, clouds):
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)
        t0 = time.perf_counter()
        out = m.process_pointcloud(geo.Projection.from_pose(pos, quat), pts, val)
        gt = out.glb_type  # the copy to the host ends the frame
        ms.append((time.perf_counter() - t0) * 1e3)
        sha.append(output_digest(gt, out.dist_sq, out.coc))
        levels.append(int(out.gate_level))
    st = state_to_numpy(m.state)
    ckpt = hashlib.sha256()
    for k in m.CHECKPOINT_FIELDS:  # what a mesh run shares with one device
        ckpt.update(np.ascontiguousarray(st[k]).tobytes())
    timed = ({} if mesh is None else
             {f"slice/collective_us/{k}": np.asarray(v) for k, v in
              collective_us(mesh, m.state, m.cfg).items()})
    return {**timed, "slice/out_sha": np.asarray(sha), "slice/ms": np.asarray(ms),
            "slice/gate_level": np.asarray(levels),
            "slice/state_sha": np.asarray(state_digest(st)),
            "slice/ckpt_sha": np.asarray(ckpt.hexdigest()),
            **{f"slice/launches/{k}": np.asarray(w.launches)
               for k, w in wrappers.items()}}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("process_id", type=int, nargs="?")
    ap.add_argument("num_processes", type=int, nargs="?")
    ap.add_argument("--coordinator", default="127.0.0.1:45688")
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU devices and gloo (else one card per device, NCCL)")
    ap.add_argument("--cases", default="canvas",
                    help="comma-separated demo cases: canvas, gated, relax")
    ap.add_argument("--slice", action="store_true",
                    help="run the cow-lady slice instead of the demo frames")
    ap.add_argument("--share-card", action="store_true",
                    help="every local device of a rank on its one card "
                         "(cuda:LOCAL_RANK); else cards LOCAL_RANK * k .. + k - 1")
    return ap


def main(argv=None):
    import torch.distributed as dist

    from .mesh import make_mesh

    args = _parser().parse_args(argv)
    env = os.environ
    if args.process_id is not None:
        rank, world = args.process_id, args.num_processes or 1
        grouped = world > 1
        local_rank = rank
        addr = f"tcp://{args.coordinator}"
    else:
        grouped = "RANK" in env and "WORLD_SIZE" in env
        rank = int(env.get("RANK", 0))
        world = int(env.get("WORLD_SIZE", 1))
        local_rank = int(env.get("LOCAL_RANK", rank))
        addr = "env://"
    k = args.devices_per_proc
    if args.cpu:
        devices = ["cpu"] * k
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the demo runs on CUDA devices; pass --cpu")
        cards = ([local_rank] * k if args.share_card
                 else [local_rank * k + i for i in range(k)])
        if max(cards) >= torch.cuda.device_count():
            raise RuntimeError(f"the demo needs card {max(cards)}; "
                               f"{torch.cuda.device_count()} available")
        devices = [torch.device("cuda", c) for c in cards]
        torch.cuda.set_device(devices[0])
    mesh = None
    if grouped:
        dist.init_process_group("gloo" if args.cpu else "nccl",
                                init_method=addr, rank=rank, world_size=world)
        mesh = make_mesh(group=dist.group.WORLD, local_devices=devices)
    elif k > 1:
        mesh = make_mesh(devices=devices)
    try:
        out = (run_slice(args.frames, mesh, devices[0]) if args.slice else {
            key: v for case in args.cases.split(",")
            for key, v in run_demo(case, args.frames, mesh, devices[0]).items()})
        if rank == 0:
            n_shards = mesh.size if mesh is not None else 1
            print(f"multihost demo ok: {world} processes x {k} devices "
                  f"({n_shards} shards), {args.frames} frames", flush=True)
            if args.out:
                np.savez(args.out, **out)
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
