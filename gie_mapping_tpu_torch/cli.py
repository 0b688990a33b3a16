"""Console entry point of the PyTorch port: run any benchmark case end to end
(the reference's `roslaunch GIE <case>.launch`), on the CUDA card unless
--cpu is given.

Counterpart of gie_mapping_tpu/cli.py, with the same cases, flags and
one-line JSON summary.  Data sources:
  * default: a procedural world and analytic sensor simulation
    (runtime/datasets.py), `synthetic_frames`;
  * --replay frames.npz: an offline-converted bag (save_frames_npz format;
    python -m gie_mapping_tpu_torch.runtime.rosbag writes one).

Examples:
  gie-tpu-torch-run cow_lady --frames 20
  gie-tpu-torch-run scan2D --frames 50 --profile --log scan2d.csv
  gie-tpu-torch-run depthcam --replay depth_frames.npz --save map.npz

The JAX package's A/B toggles (--env-variant, --phase1, --mid,
--gate-pmode) accept only the value the port runs; any other value fails
with the mapper's "not ported" error.  --mesh N shards the map state over
N devices (parallel/mesh.py: the canvas along x, the archive along blocks,
every stage on the shards): the first N cards, or with --cpu N CPU
devices, as the JAX CLI's virtual ones; the results equal one device's.
Under torchrun (`torchrun --nproc-per-node N -m gie_mapping_tpu_torch.cli
...`) the mesh spans the ranks, one process each over NCCL (gloo with
--cpu), each driving max(--mesh, 1) devices; rank 0 prints the summary and
writes --save.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .models.mapper import VolumetricMapper
from .parallel.mesh import make_mesh
from .runtime.datasets import BoxWorld, circular_trajectory, load_frames_npz
from .utils import geometry as geo
from .utils.config import load_config

CASES = ("scan2D", "cow_lady", "ugv_corridor", "depthcam", "laser3D",
         "uav_raycast_fine")


def synthetic_frames(cfg, n_frames):
    """(Projection, (kind, payload)) per frame of the case's synthetic run:
    a seeded corridor world and a circular trajectory sized to the window
    (the same frames as the JAX package's CLI)."""
    world = BoxWorld.corridor(seed=11, n_pillars=8,
                              extent=max(cfg.local_size_m[:2]) * 0.7,
                              height=max(1.5, cfg.local_size_m[2]))
    poses = circular_trajectory(n_frames, radius=cfg.local_size_m[0] * 0.15,
                                height=cfg.local_size_m[2] * 0.4)
    for i, proj in enumerate(poses):
        case = cfg.data_case
        if case in ("cow_lady", "ugv_corridor", "uav_raycast_fine"):
            pts = world.pointcloud(proj, n_rays=8192, seed=i,
                                   max_range=0.8 * cfg.local_size_m[0])
            yield proj, ("pointcloud", pts)
        elif case == "scan2D":
            r, tmin, tinc = world.scan_2d(proj, n_beams=360)
            yield proj, ("scan", (r, tmin, tinc))
        elif case == "depthcam":
            depth, fx, fy, cx, cy = world.depth_image(proj)
            yield proj, ("depth", (depth, fx, fy, cx, cy))
        elif case == "laser3D":
            img, tmin, tinc, pmin, pinc = world.multiscan(proj)
            yield proj, ("multiscan", (img, tmin, tinc, pmin, pinc))
        else:
            raise KeyError(case)


def replay_frames(path):
    """(Projection, (kind, payload)) per frame of a save_frames_npz file."""
    for fr in load_frames_npz(path):
        proj = geo.Projection.from_pose(fr["position"], fr["quat_wxyz"])
        if "points" in fr:
            yield proj, ("pointcloud", fr["points"])
        elif "ranges" in fr:
            yield proj, ("scan", (fr["ranges"], float(fr["theta_min"]),
                                  float(fr["theta_inc"])))
        elif "depth" in fr:
            yield proj, ("depth", (fr["depth"], float(fr["fx"]), float(fr["fy"]),
                                   float(fr["cx"]), float(fr["cy"])))
        elif "rings" in fr:
            yield proj, ("multiscan", (fr["rings"], float(fr["theta_min"]),
                                       float(fr["theta_inc"]), float(fr["phi_min"]),
                                       float(fr["phi_inc"])))


def dispatch(mapper, proj, kind, payload, staged=False):
    """One frame of (kind, payload) through the mapper's online entry
    point; a staged point cloud is a (points, valid) tensor pair."""
    if kind == "pointcloud":
        return (mapper.process_pointcloud(proj, *payload) if staged
                else mapper.process_pointcloud(proj, payload))
    if kind == "scan":
        return mapper.process_scan2d(proj, *payload)
    if kind == "depth":
        return mapper.process_depth(proj, *payload)
    if kind == "multiscan":
        return mapper.process_multiscan(proj, *payload)
    raise KeyError(kind)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=CASES)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--replay", type=str, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="enable RMSE ground-truth checking + CSV log")
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--save", type=str, default=None, help="checkpoint path")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--staged", action="store_true",
                    help="upload sensor payloads to the device before the "
                         "measured loop, size the point capacity to the "
                         "data, stream nothing, and report the best of three "
                         "passes after four warm frames")
    ap.add_argument("--merge-mode", choices=["canvas_edt", "relax"],
                    default=None, help="override the incremental-EDT engine")
    ap.add_argument("--env-variant", default=None,
                    help="cfg.edt_env_variant (the port runs fusepay only)")
    ap.add_argument("--phase1", choices=["xla", "pallas"], default=None,
                    help="cfg.edt_phase1 (the port runs its phase-1 kernel: "
                         "pallas)")
    ap.add_argument("--mid", choices=["on", "off"], default=None,
                    help="cfg.edt_mid (the port runs on)")
    ap.add_argument("--gate", choices=["on", "off"], default=None,
                    help="override cfg.edt_gate (change-gated canvas EDT)")
    ap.add_argument("--gate-pmode", choices=["voxel", "block"], default=None,
                    help="cfg.edt_gate_pmode (the port runs block)")
    ap.add_argument("--p1-cache", choices=["on", "off"], default=None,
                    help="override cfg.edt_p1_cache (phase-1 cache)")
    ap.add_argument("--batch", type=int, default=0, metavar="K",
                    help="replay mode: frames go through process_*_batch "
                         "in runs of up to K (bit-identical to the "
                         "per-frame loop)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the map state (the canvas along x, the "
                         "archive along blocks) over an N-device mesh (with "
                         "--cpu, N CPU devices; under torchrun, N devices "
                         "per rank); bit-identical to one device")
    return ap


def _config(args):
    cfg = load_config(args.case)
    if args.merge_mode is not None:
        cfg = cfg.replace(merge_mode=args.merge_mode)
    if args.env_variant is not None:
        cfg = cfg.replace(edt_env_variant=args.env_variant)
    if args.phase1 is not None:
        cfg = cfg.replace(edt_phase1=args.phase1)
    if args.mid is not None:
        cfg = cfg.replace(edt_mid=(args.mid == "on"))
    if args.gate is not None:
        cfg = cfg.replace(edt_gate=(args.gate == "on"))
    if args.gate_pmode is not None:
        cfg = cfg.replace(edt_gate_pmode=args.gate_pmode)
    if args.p1_cache is not None:
        cfg = cfg.replace(edt_p1_cache=(args.p1_cache == "on"))
    if args.batch and args.profile:
        # the RMSE checker needs each frame's output, which a replay run
        # does not build: profile runs stay per-frame
        print("--profile needs per-frame dispatch; ignoring --batch",
              file=sys.stderr)
        args.batch = 0
    if args.batch:
        cfg = cfg.replace(fuse_raycast=True)  # the point-cloud replay needs it
    if args.profile:
        cfg = cfg.replace(profile_loc_rms=True)
    if args.staged:
        # engine time: streaming's host copies are excluded
        cfg = cfg.replace(display_glb_edt=False, display_glb_ogm=False)
    return cfg


def main(argv=None):
    """Run the CLI on `argv` (sys.argv[1:] when None); prints the one-line
    JSON summary and returns it as a dict."""
    args = _parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    mesh = _torchrun_mesh(args)
    if mesh is not None:
        device = None
    elif args.mesh > 1:
        mesh = (make_mesh(devices=["cpu"] * args.mesh) if args.cpu
                else make_mesh(args.mesh))
        device = None
    try:
        return _main(args, device, mesh)
    finally:
        if mesh is not None and mesh.group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _torchrun_mesh(args):
    """Under torchrun (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and
    LOCAL_RANK in the environment): the process group (NCCL on cards, gloo
    with --cpu) and a mesh over it, each rank driving max(--mesh, 1) local
    devices (cards LOCAL_RANK * N .. + N - 1).  Else None."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    import torch.distributed as dist

    k = max(args.mesh, 1)
    local = int(env.get("LOCAL_RANK", env["RANK"]))
    if args.cpu:
        devices = ["cpu"] * k
    else:
        devices = [torch.device("cuda", local * k + i) for i in range(k)]
        torch.cuda.set_device(devices[0])
    dist.init_process_group("gloo" if args.cpu else "nccl", init_method="env://",
                            rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return make_mesh(group=dist.group.WORLD, local_devices=devices)


def _main(args, device, mesh):
    cfg = _config(args)
    mapper = VolumetricMapper(cfg, device=device, log_path=args.log,
                              mesh=mesh)
    dev = mapper.device

    # frames are made (or decoded) first: simulation is not engine time
    src = list(replay_frames(args.replay) if args.replay
               else synthetic_frames(cfg, args.frames))
    if args.staged:
        # size the point capacity to the data (a deployment sizes its buffer
        # to its sensor)
        maxpts = max((len(p) for _, (k, p) in src if k == "pointcloud"),
                     default=0)
        if maxpts:
            cap = 1 << (maxpts - 1).bit_length()
            cfg = cfg.replace(max_raycast_points=min(
                cfg.max_raycast_points, max(cap, 4096)))
            mapper = VolumetricMapper(cfg, device=device, log_path=args.log,
                                      mesh=mesh)

        def _stage(kind, payload):
            if kind == "pointcloud":
                return mapper.stage_pointcloud(payload)
            return tuple(torch.from_numpy(np.asarray(p, np.float32)).to(dev)
                         if isinstance(p, np.ndarray) else p for p in payload)

        src = [(proj, (kind, _stage(kind, payload)))
               for proj, (kind, payload) in src]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    warm = src[:4] if args.staged and len(src) > 5 else []
    src = src[len(warm):]

    run_batch = None
    if args.batch:
        projs_b = [p for p, _ in src]
        kind0 = src[0][1][0]
        pls = [pl for _, (_, pl) in src]

        def scal(idx):
            return np.asarray([float(pl[idx]) for pl in pls], np.float32)

        if kind0 == "pointcloud":
            if args.staged:  # staged (points, valid) pairs
                pts_b = torch.stack([pl[0] for pl in pls])
                val_b = torch.stack([pl[1] for pl in pls])
            else:
                pts_b, val_b = mapper.stage_pointcloud_batch(pls)
            run_batch = lambda: mapper.process_pointcloud_batch(
                projs_b, pts_b, val_b, chunk=args.batch)
        else:
            data = torch.stack([torch.as_tensor(pl[0], dtype=torch.float32)
                                for pl in pls]).to(dev)
            fn = {"scan": mapper.process_scan2d_batch,
                  "depth": mapper.process_depth_batch,
                  "multiscan": mapper.process_multiscan_batch}[kind0]
            n_sc = {"scan": 2, "depth": 4, "multiscan": 4}[kind0]
            run_batch = lambda: fn(projs_b, data,
                                   *[scal(i) for i in range(1, n_sc + 1)],
                                   chunk=args.batch)

    for proj, (kind, payload) in warm:  # first launches, allocator growth
        out = dispatch(mapper, proj, kind, payload, args.staged)
    if warm:
        out.fetch()
    if run_batch is not None and warm:
        out = run_batch()
        out.fetch()
    # staged: the best of three passes
    n_passes = 3 if warm else 1
    wall = float("inf")
    for _pass in range(n_passes):
        t0 = time.perf_counter()
        if run_batch is not None:
            out = run_batch()
            n = len(src)
        else:
            n = 0
            for proj, (kind, payload) in src:
                out = dispatch(mapper, proj, kind, payload, args.staged)
                n += 1
        out.fetch()
        dt = time.perf_counter() - t0
        print(f"pass {_pass}: {dt*1e3/max(n,1):.2f} ms/frame", file=sys.stderr)
        wall = min(wall, dt)

    if mapper.mirror is not None:
        mapper.flush_stream()  # ingest the in-flight rows before reporting
    if args.save:
        mapper.save(args.save)

    summary = {
        "case": args.case,
        "frames": n,
        "wall_s": round(wall, 3),
        "ms_per_frame": round(wall * 1e3 / max(n, 1), 2),
        "occupied_voxels": int((out.glb_type == 2).sum()),
        "gate_level_last": int(out.gate_level),
        "frontier_voxels": int(out.fnt_count),
        "mirror_blocks": len(mapper.mirror) if mapper.mirror else 0,
        "arch_dropped": int(out.arch_dropped),
    }
    if mesh is None or mesh.rank == 0:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
