"""Profiling hooks of the PyTorch port.

Counterpart of gie_mapping_tpu/runtime/profiler.py (the reference's
wall-clock brackets with explicit device syncs, volumetric_mapper.cpp:153,
186-203): stage timers that wait for the device before they stop, and a
torch.profiler trace writer.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulating per-stage wall timers.  A stage given `sync_on` (a
    device, or a tensor whose device is meant) waits for that device's
    queued work before its clock stops."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            _sync(sync_on.device if isinstance(sync_on, torch.Tensor)
                  else sync_on)
        self.times[name].append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.times.items():
            a = np.asarray(v)
            out[k] = {
                "median_ms": float(np.median(a)),
                "p90_ms": float(np.percentile(a, 90)),
                "n": len(a),
            }
        return out


@contextlib.contextmanager
def torch_trace(log_dir: str, device="cuda"):
    """Trace the enclosed work with torch.profiler (host and, on a card,
    device activity) and write it as a Chrome trace to
    log_dir/trace.json.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
