"""What the harnesses share: the run's nvidia-smi line, timing on the
device clock and per-frame percentiles."""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def device_line(dev: torch.device) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` line, verbatim ("cpu" for a CPU run)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    lines = r.stdout.strip().splitlines()
    idx = dev.index or 0
    return lines[idx] if idx < len(lines) else \
        f"nvidia-smi: no line for card {idx} (rc {r.returncode})"


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev: torch.device, fn):
    """(fn(), device ms, wall ms) of one call from an idle device: CUDA
    events around the call and one synchronisation after it, with
    perf_counter wall time beside them; on the CPU both are the wall
    time."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        r = fn()
        ms = (time.perf_counter() - t0) * 1e3
        return r, ms, ms
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        r = fn()
        e.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return r, s.elapsed_time(e), wall


def best_of(dev: torch.device, fn, reps: int) -> float:
    """The least device ms of `reps` timed calls of fn, after one untimed
    call (first use: kernel builds, allocator growth)."""
    fn()
    sync(dev)
    return min(timed(dev, fn)[1] for _ in range(reps))


def per_frame_stats(prefix: str, ms) -> dict:
    """The p50 / p95 / max of per-frame ms, with their sample count."""
    a = np.asarray(ms, np.float64)
    return {f"{prefix}_p50_ms": float(np.percentile(a, 50)),
            f"{prefix}_p95_ms": float(np.percentile(a, 95)),
            f"{prefix}_max_ms": float(a.max()), f"{prefix}_samples": len(a)}
