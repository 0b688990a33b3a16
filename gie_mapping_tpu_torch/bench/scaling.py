"""The port's scaling benchmark: merge ms/frame by device count; its
counterpart is the JAX package's bench_scaling.py.

    python -m gie_mapping_tpu_torch.bench.scaling [--frames N]
        [--virtual N] [--distributed] [--cpu]

Each point runs pipeline.merge_frame on the cow_lady preset with
streaming off: one 1 %-occupied observation grid (seed 0) at pivot 0 with
the default fence, one untimed call, then `--frames` timed calls (CUDA
events around the loop, one synchronisation after it), on one device and
on a mesh of n (parallel.mesh; the canvas sharded along x).  The mesh is
every visible card; with `--virtual N`, N shards of the run's one device
(with --cpu, `make_mesh(devices=["cpu"] * N)`, JAX's virtual CPU
devices): a functional run of the sharded program and its collectives,
not a hardware scaling number.  With `--distributed` the mesh spans
torchrun's processes (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_RANK; NCCL, or gloo with --cpu), one card each; rank 0 prints.

Prints one JSON line: cowlady_merge_ms_per_frame_by_devices, with
points_ms, devices, scaling_efficiency where n > 1, and device.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..map_state import MapState, canvas_geometry, resolve_device
from ..models.pipeline import merge_frame
from ..parallel.mesh import make_mesh
from ..utils.config import cow_lady_config
from .common import device_line, timed

N_FRAMES = 20
TARGET_MS = 10.0


def run_point(dev, frames, cfg_overrides=None, mesh=None):
    """(ms per merge, final MapState) of one point: on `dev`, or on `mesh`
    (its home holds the inputs)."""
    cfg = cow_lady_config(display_glb_edt=False, display_glb_ogm=False,
                          **(cfg_overrides or {}))
    if mesh is not None:
        state = MapState.create(cfg, mesh=mesh)
        dev = mesh.home
    else:
        state = MapState.create(cfg, dev)
    rng = np.random.default_rng(0)
    inst = np.full(cfg.local_size, 1, np.int8)
    inst[rng.random(cfg.local_size) < 0.01] = 2
    pvt = np.zeros(3, np.int32)
    ob, _, off = canvas_geometry(cfg, pvt)
    m = cfg.max_ext_obs
    fence = (torch.zeros(m, 3, device=dev), torch.zeros(m, 3, device=dev),
             torch.zeros(m, dtype=torch.bool, device=dev), 0)
    args = (torch.from_numpy(inst).to(dev),
            torch.zeros(cfg.local_size, dtype=torch.int32, device=dev),
            pvt, ob, off, fence)

    def merges(n):
        nonlocal state
        for _ in range(n):
            state, out = merge_frame(state, *args, cfg=cfg,
                                     input_pointcloud=False, mesh=mesh)
        return int(out["relax_iters"])

    timed(dev, lambda: merges(1))
    _, ms, _ = timed(dev, lambda: merges(frames))
    return ms / frames, state


def _distributed_mesh(cpu):
    """The mesh over torchrun's process group: one local device a rank."""
    import torch.distributed as dist

    env = os.environ
    local = int(env.get("LOCAL_RANK", env["RANK"]))
    dev = torch.device("cpu") if cpu else torch.device("cuda", local)
    if not cpu:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://",
                            rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return dev, make_mesh(group=dist.group.WORLD, local_devices=[dev])


def run(device, frames=N_FRAMES, *, virtual=0, distributed=False,
        cfg_overrides=None):
    """(JSON line dict, {points key: final MapState}) of the 1-device point
    and, where n > 1, the n-way point (see the module docstring)."""
    dev = resolve_device(device, "bench.scaling")
    cpu = dev.type == "cpu"
    mesh = None
    if distributed:
        dev, mesh = _distributed_mesh(cpu)
    elif virtual:
        mesh = make_mesh(devices=[dev] * virtual)
    elif not cpu and torch.cuda.device_count() > 1:
        mesh = make_mesh(torch.cuda.device_count())
    n = 1 if mesh is None else mesh.size
    t1, s1 = run_point(dev, frames, cfg_overrides)
    points, states = {"1": t1}, {"1": s1}
    extra = {}
    if n > 1:
        tn, states[str(n)] = run_point(dev, frames, cfg_overrides, mesh)
        points[str(n)] = tn
        extra["scaling_efficiency"] = t1 / tn / n
    value = points[str(n)]
    line = {"metric": "cowlady_merge_ms_per_frame_by_devices",
            "value": value, "unit": "ms", "vs_baseline": TARGET_MS / value,
            "extra": {"points_ms": points, "devices": n, **extra,
                      "virtual": bool(virtual), "frames": frames,
                      "device": device_line(dev)}}
    if virtual:
        line["extra"]["note"] = (f"{n} shards of one device: a functional "
                                 "run, not a hardware scaling number")
    return line, states


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--virtual", type=int, default=0,
                    help="the n-way point on N shards of the run's device "
                         "(functional)")
    ap.add_argument("--distributed", action="store_true",
                    help="the mesh over torchrun's processes")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    line, _ = run("cpu" if args.cpu else "cuda", args.frames,
                  virtual=args.virtual, distributed=args.distributed)
    if not args.distributed or int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps(line), flush=True)
    if args.distributed:
        import torch.distributed as dist

        dist.destroy_process_group()
    return line


if __name__ == "__main__":
    main()
