"""The control of the benchmark's comparison: the plain reference computed
in bfloat16, the precision below the float32 that the configuration
states, put in the engine's place and compared with the float32 reference
by the comparison that decides `correct`.  A control that reads as correct
would mean the comparison cannot see a lower-precision engine.

    python -m mapbench.control --workload depthcam.flight --frames 300 --seeds 1 2 3

replays the cell's first `--frames` frames (set-up pass and window, as a
run of that many frames would) for each seed and prints one JSON line per
seed: each compared number beside its limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import compare
from .generate import make_traffic, sensor_module
from .reference.mapper import RefMapper
from .run import cell_spec


def control_checks(config, traffic, seed, frames, device):
    """[(name, value, limit)] of the bfloat16 reference against the float32
    one over the cell's first `frames` frames."""
    tr = make_traffic(traffic, config["sensor"], seed, device)
    F, K = tr["counts"]["frames_per_pass"], tr["counts"]["passes"]
    cam = config["sensor"]
    sm = sensor_module(cam)
    sides = []
    for low in (False, True):
        ref = RefMapper(config["deployment"], device, low=low)
        for j in range(frames):
            sm.reference_frame(ref, cam, tr["rots"][j % F], tr["trans"][j % F],
                               tr["data"][(j // F) % K, j % F])
        sides.append(ref)
    return compare.compare(compare.ref_snapshot(sides[1]), sides[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, config, traffic, _ = cell_spec(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_checks(config, traffic, seed, args.frames, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": args.frames,
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": lim} for k, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
