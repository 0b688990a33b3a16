"""Run one cell of the mapping engine's benchmark once.

    python -m mapbench.run --workload depthcam.flight --seed 7 --seconds 10 --trace 0

A cell (BENCHMARK.json's `workloads`) names a configuration
(mapbench/configs/<config>.json: the engine's preset at its published
settings, the sensor, the guarantees) and a traffic mix
(mapbench/traffic/<traffic>.json, read by mapbench/generate.py, which
finds the path and the sensor by their kinds).  Set-up makes the mapper,
renders the traffic's noisy passes on the card from the seed and runs the
traffic's warm-up passes untimed; then the window runs map cycles, one
call of the engine's entry for the sensor each (mapbench/sensors/<kind>.py),
in loop order until `--seconds` have passed, and ends with the mirror's
flush and a synchronisation.  Afterwards the plain reference
(mapbench/reference/) replays every frame the engine took and
mapbench/compare.py decides `correct`.

--trace 0 prints the cell's end-to-end metrics (setup_s, frame_ms,
frame_ms_p95); --trace 1 wraps the engine's layers (mapbench/trace.py),
profiles the window and prints the per-layer metrics, each read by
mapbench/metrics/<name>.py.  The last line of standard output is the
result; the numbers compared, each beside its limit, end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
THREADS = 1          # torch's intra-op threads: the host work is one thread
FORBIDDEN = ("jax", "jaxlib", "flax", "gie_mapping_tpu")


def cell_spec(workload: str):
    """(cell, config, traffic, per-layer metric names) of a workload."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"mapbench: no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    reports = {m["name"] for m in bench["end_to_end"]
               if workload in m.get("workloads", [workload])}
    layer = [m["name"] for m in bench["per_layer"]
             if workload in m.get("workloads", [workload]) and m["moves"] in reports]
    return cell, config, traffic, layer


def metric_reader(name: str):
    """The reader module of per-layer metric `name`
    (mapbench/metrics/<name>.py): its read(trace), and optionally SPANS,
    further engine functions to wrap as spans ({span: (module, attribute
    path)}, as trace.SPANS)."""
    spec = importlib.util.spec_from_file_location(
        f"mapbench_metric_{name.replace('.', '_')}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, trace):
    """The value of per-layer metric `name` (its reader returns None where
    it finds nothing to read)."""
    return metric_reader(name).read(trace)


def _smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _check_program(mapper, config):
    """The engine's preset must still hold the deployment's settings."""
    bad = []
    for k, v in config["deployment"].items():
        pv = getattr(mapper.cfg, k)
        if (list(pv) if isinstance(pv, tuple) else pv) != v:
            bad.append(f"{k}: engine {pv!r}, configuration {v!r}")
    if bad:
        raise SystemExit("mapbench: the engine's preset departs from the "
                         "configuration: " + "; ".join(bad))


def end_to_end(starts, t_first, t_end, setup_s) -> dict:
    """The end-to-end metrics of a window: its wall time over the frames it
    completed, and the 95th percentile of every frame's time (the start of
    its call to the start of the next; the last frame's ends with the
    flush and the synchronisation)."""
    import numpy as np

    dur = np.diff(np.asarray(list(starts) + [t_end]))
    return {"setup_s": setup_s,
            "frame_ms": (t_end - t_first) * 1e3 / len(starts),
            "frame_ms_p95": float(np.percentile(dur, 95)) * 1e3}


def run_cell(config, traffic, *, seed, seconds, trace=False, device="cuda",
             metrics=(), max_frames=None):
    """Set-up, window and comparison of one run (`max_frames`, where
    given, ends the window instead of `seconds`).  Returns (result dict
    without its checks, [(name, value, limit)], facts of the run)."""
    import torch

    from gie_mapping_tpu_torch import create_mapper
    from gie_mapping_tpu_torch.utils.geometry import Projection

    from . import compare
    from .generate import make_traffic, sensor_module
    from .reference.mapper import RefMapper

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    torch.set_num_threads(THREADS)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # ---- set-up -------------------------------------------------------------
    mapper = create_mapper(config["preset"], device=dev, **config.get("overrides", {}))
    _check_program(mapper, config)
    cam = config["sensor"]
    tr = make_traffic(traffic, cam, seed, dev)
    sm = sensor_module(cam)
    F, K = tr["counts"]["frames_per_pass"], tr["counts"]["passes"]
    projs = [Projection(torch.from_numpy(tr["rots"][k].copy()),
                        torch.from_numpy(tr["trans"][k].copy())) for k in range(F)]
    data = tr["data"]

    def frame(i):
        sm.engine_frame(mapper, cam, projs[i % F], data[(i // F) % K, i % F])

    warm = F * int(traffic.get("warmup_passes", 1))
    for i in range(warm):                # whole passes, untimed
        frame(i)
    flush = getattr(sm, "flush", lambda m: None)
    flush(mapper)
    sync()
    gc.collect()
    gc.freeze()
    gc.disable()

    rec = restore = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from .trace import Recorder, install
        rec = Recorder()
        extra = {}
        for name in metrics:
            extra.update(getattr(metric_reader(name), "SPANS", {}))
        restore = install(rec, sm.SPAN, extra)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        rec.active = True

    # ---- the window -----------------------------------------------------------
    sync()
    starts = []
    i = warm
    t_first = time.perf_counter()
    setup_s = t_first - T_START
    win = torch.profiler.record_function("mapbench/window") if trace else None
    if win is not None:
        win.__enter__()
    while True:
        t = time.perf_counter()
        if (t - t_first >= seconds) if max_frames is None else len(starts) >= max_frames:
            break
        starts.append(t)
        if rec is not None:
            with rec.frame():
                frame(i)
        else:
            frame(i)
        i += 1
    flush(mapper)
    mapper.flush_stream()
    sync()
    if win is not None:
        win.__exit__(None, None, None)
    t_end = time.perf_counter()
    gc.enable()
    gc.unfreeze()

    n = len(starts)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
    result = {"attempted": n, "failed": 0}
    if trace:
        from .trace import Trace, read_events
        rec.active = False
        prof.__exit__(None, None, None)
        restore()
        ev = read_events(prof)
        wr = ev["window"][0] if ev["window"] else (0, 0, "")
        ev["device"] = [e for e in ev["device"] if wr[0] <= e[0] < wr[1]]
        tr_obj = Trace(rec, n, ev, (wr[0], wr[1]))
        vals = {}
        for name in metrics:
            v = read_metric(name, tr_obj)
            if v is not None:
                vals[name] = v
        result["metrics"] = vals
        device_info["busy_s"] = tr_obj.busy_ns() / 1e9
        device_info["window_s"] = (wr[1] - wr[0]) / 1e9
        top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        result["breakdown"] = {"device_ops": top(tr_obj.device_ops()),
                               "idle_gaps": top(tr_obj.idle_gaps())}
        print(f"mapbench: {len(ev['device'])} device records in the window, "
              f"{ev['linked']} linked to a runtime call", file=sys.stderr)
        del prof, ev, tr_obj
    else:
        result["metrics"] = end_to_end(starts, t_first, t_end, setup_s)
    result["device"] = device_info

    # ---- the comparison -------------------------------------------------------
    eng = compare.snapshot(mapper)
    del mapper
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = RefMapper(config["deployment"], dev)
    for j in range(i):
        sm.reference_frame(ref, cam, tr["rots"][j % F], tr["trans"][j % F],
                           data[(j // F) % K, j % F])
    checks = compare.compare(eng, ref)
    bad = any(v > lim for _, v, lim in checks)
    result["correct"] = not bad
    info = {"reference_s": time.perf_counter() - t_ref, "frames_replayed": i, "scrolls_replayed": ref.scrolls,
            "archived_blocks": len(ref.archive), "mirror_blocks": len(ref.mirror),
            "counts": tr["counts"]}
    if bad:
        info["detail"] = compare.detail(eng, ref)
    return result, checks, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config, traffic, layer = cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"mapbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks, info = run_cell(config, traffic, seed=args.seed, seconds=args.seconds,
                                    trace=bool(args.trace), metrics=layer)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print("mapbench: modules of JAX or the JAX package are loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 3
    info["nvidia_smi"] = _smi()
    print("mapbench: " + json.dumps(info), file=sys.stderr)
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": {}, "device": result["device"]}
    units = {m["name"]: m["unit"] for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())[("per_layer" if args.trace else "end_to_end")]}
    for k, v in result["metrics"].items():
        line["metrics"][k] = {"value": v, "unit": units[k]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    print(json.dumps(line), flush=True)
    for k, v, lim in checks:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
