#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (gie_mapping_tpu_torch) on one card.

    python3 chip_smoke.py [--out DIR] [--profile]

Phases, one JSON line each; any failure exits non-zero:
  1. device   - a CUDA card is required (there is no CPU path); prints its
                name and power limit as nvidia-smi reports them.
  2. build    - compiles the CUDA kernels (csrc/) with nvcc and, beside
                them, the host library (native/src/gie_host.cpp) with g++.
  3. kernels  - each kernel against its plain PyTorch version on the card, at
                the paths' shapes and at random ones (ties, empty lanes):
                phase 1 and the three envelopes bitwise on every lane (also
                on the edge cases of tests/test_torch_envelope_cases.py:
                N from 1 to 257, costs just below the cap, lane counts that
                are not multiples of 32; phase 1 on those of
                tests/test_torch_phase1_cases.py; the generic envelope
                also at N in {1, 2, 100, 128, 152}, cap-valued sites);
                batch_edt / batch_edt_slab bitwise against the plain chain;
                the panorama and the carve bitwise on every bin and voxel
                (the cow-lady window at three poses, the ugv_corridor
                window, the cases of tests/test_torch_carve_cases.py); the
                canvas shift and the four block/archive row copies bitwise
                (every z arm, shifts past the canvas, sentinel cocs,
                all-invalid and repeated ids; archive gathers of 1, 320
                and 3610 rows).  Times each kernel (`timing`: ms over
                back-to-back calls, device_ms on the profiler's device
                clock, host_us per call), its plain version and, where one
                PyTorch call computes the same function, that call;
                computes each kernel's bound (see `result`).  Where PARENT
                holds a copy of the parent commit's package, the kernels
                against the parent's at the paths' shapes, in turns
                (phase1_packed at five shapes, the three envelopes and the
                carve at two or three, and the whole sensor model,
                pointcloud_project); gather_archive_rows against
                index_select at four row counts, warm and cold L2.
  4. slice    - the cow-lady point-cloud frame through
                VolumetricMapper.process_pointcloud at full size (152x152x80
                canvas, 131072 points per frame, 12 frames, streaming off);
                its five kernels must have launched; the final canvas EDT
                must equal scipy's exactly; the run must agree with the JAX
                package's results (tests/fixtures/torch_port_cow_ref.npz).
  5. scroll   - the cow_lady preset at its own defaults (streaming on) over
                26 poses that scroll in x both ways, in z and by a teleport
                past the canvas and back; all ten kernels of the path must
                have launched, no CapacityWarning may fire, the final canvas EDT
                must equal scipy's, and origins, every frame's outputs, the
                final state and the host mirror must equal the JAX package's
                (tests/fixtures/torch_port_cow_scroll_ref.npz).
  6. scan2d   - the scan2D preset at its own defaults (2-D LiDAR, fast_mode,
                for_motion_planner, gated canvas EDT, streaming off) through
                VolumetricMapper.process_scan2d over 16 poses that scroll
                its 128x128x56 canvas 6 times after frame 0's placement;
                kernels 1-3 and the five
                scroll kernels must have launched; the final canvas EDT
                must equal scipy's (as on the scroll path); origins, gate
                levels, every frame's outputs and the final state must
                equal the JAX package's (tests/fixtures/torch_port_scan2d_ref.npz).
  7. scan2d_flat - the same sensor on a true 2-D map (a one-voxel-deep
                window) on the relax engine, 10 poses; the generic envelope
                (kernel 5) must have launched; every valid voxel's dist_sq
                must be its squared distance to its coc; relax sweep counts,
                frames and state must equal the JAX package's
                (tests/fixtures/torch_port_scan2d_flat_ref.npz).
  8. replay   - the replay mapper (process_pointcloud_batch) at bench.py's
                own settings (datasets.cow_lady_bench: fuse_raycast on,
                131072 points, streaming off): 3 frames through
                process_pointcloud, then the 40-frame closed circle in one
                call with chunk 40; then the scroll path's 26 poses with
                fuse_raycast on and streaming on, in one call with chunk
                10.  Each must equal the JAX package's replay
                (tests/fixtures/torch_port_replay_ref.npz: final state,
                last window outputs, payload8 of cost_map_msg, every run's
                per_frame scalars, counters, and the scroll part's host
                mirror) and the port's own per-frame run of the same frames
                in this process (final state and last outputs); the bench
                part's final canvas EDT must equal scipy's.  Prints online
                and replay ms per frame (CUDA events over each call; the
                replay timed again over a second pass, as bench.py does).
  9. depthcam - the depth camera (process_depth, process_depth_batch) at
                bench_suite.py's settings (datasets.depthcam_bench: the
                depthcam preset, 240x240x168 canvas with one slack block,
                streaming off, 96x128 depth images): 2 frames online, then
                the closed 40-pose circle in one batch call with chunk 40;
                then the same 42 frames through process_depth on a fresh
                mapper.  The replay must equal the JAX package's
                (tests/fixtures/torch_port_depthcam_ref.npz: the 2 online
                frames' outputs, final state, last outputs, payload8,
                every run's per_frame, counters), the per-frame run the
                JAX per-frame run (state, last outputs), and the two runs
                must be equal exactly where JAX's are (the per-frame
                program rounds the sensor's height offset unlike the
                replay's scan loop), and the replay's state must equal
                JAX's replay (`replay_equals_jax_replay`); the final
                canvas EDT must equal
                scipy's; the path must scroll, and phases 1-3 and the five
                scroll kernels must launch.  Prints online and replay ms
                per frame (the replay timed again over a second pass).
 10. laser3D  - the same for the 16-ring LiDAR (process_multiscan,
                process_multiscan_batch) at the laser3D preset's own
                defaults (datasets.laser3d_bench: 112x112x40 canvas,
                fast_mode, streaming on), also the host mirror's digest
                (tests/fixtures/torch_port_laser3d_ref.npz).
 11. dda      - the exact ray cast (raycast_mode "dda") at the
                uav_raycast_fine preset (datasets.dda_path: 80x80x40
                canvas, streaming on, 16384 points): 12 frames through
                process_pointcloud, each frame's outputs, origins, the
                final state and the host mirror against
                tests/fixtures/torch_port_dda_ref.npz; every valid voxel's
                dist_sq against its coc and scipy in the last window.
 12. cli      - the entry points a user runs, against the JAX package's
                results on the same inputs (tests/fixtures/torch_port_cli_ref.npz):
                (a) the two committed bags (tests/fixtures/handmade_v2*.bag)
                through the port's bag reader, every converted frame's
                arrays; (b) every preset at its own defaults (cow_lady,
                ugv_corridor, uav_raycast_fine, depthcam, laser3D, scan2D)
                through cli.main with 4 frames, a checkpoint and a CSV log,
                and cow_lady again with --batch 4: the summary's counts, the
                sha256 of every checkpoint array, one CSV row per frame,
                each case's ms per frame; (e) scan2D again with --profile:
                the CSV's RMSE column; (c) a resume: cow_lady's 6 synthetic
                frames saved after frame 3 and loaded into a fresh mapper,
                against the JAX resume and the uninterrupted run; (d)
                process_multiscan_cloud at the laser3D preset (the host
                library's ring images bitwise, outputs, state, mirror) and
                against the port's replay of its ring images, and
                process_ext_cloud between two process_pointcloud_batch calls
                at the cow_lady preset's width (datasets.ext_churn_path)
                and in the port's frame loop.
 13. mesh     - the map state sharded between frames (parallel/mesh.py: the
                canvas along x, the archive along blocks where it divides)
                on this card: the cow-lady slice over [card] * 2 and
                [card] * 4, bench.py's replay and the scroll path
                (streaming, the archive, x, z and teleport scrolls) over
                [card] * 4, through VolumetricMapper(cfg, mesh=...): every
                frame's window outputs, gate levels and origins, the final
                state, the replay's per_frame scalars, counters and
                payload8, the scroll traffic, the stream's leftovers and the
                host mirror against the JAX package's 4-device mesh run
                (tests/fixtures/torch_port_mesh_ref.npz), and window outputs,
                checkpoint fields and the mirror against the port's
                single-device run of the same frames; the canvas must be
                x-sharded, the sharded EDT's kernels (phases 1, 2 and the
                generic envelope) and on the scroll path the five scroll
                kernels must launch, and envelope_mid must not.  Prints each
                run's ms per frame, the parent commit's state-on-home mesh
                beside it where scratch_checkout holds its copy, each
                shard's bytes and the card's nvidia-smi line.  With two or
                more cards, the slice again over distinct cards; else a
                line that says it was not run.
 14. multiproc - the multi-process mesh over torch.distributed: one NCCL
                process per card runs parallel/multihost_demo.py --slice (6
                frames of the cow-lady slice) from torchrun's environment,
                against the single-device run and one process over the same
                shards: outputs, gate levels, state and kernel launches.
                With one card a world of one process drives two shards on
                it (every collective still runs through NCCL) and a line
                says the two-card run waits for a machine with two.
 15. scenarios - the JAX package's scenario tests that carry state through
                frames (tests/test_torch_scenario_cases.py's CHIP, their
                test sizes): world extent out to +40,000 voxels and back
                and the streamed mirror there, a true 2-D map on both
                engines, an empty frame, fence box 0 inactive, archive
                exhaustion warned and strict, a stream stall, the relax
                sweep cap, fast-mode staleness on both engines, an archived
                block stale until re-entry, the adversarial horizon on
                both engines and the stream soak (gate on); then the
                cow_lady preset at its own defaults (131,072 points,
                streaming on) over 3 frames near the origin, 3 at x =
                +40,000 voxels and 2 back.  Each against the JAX package's
                records (tests/fixtures/torch_port_scenarios_ref.npz: every
                frame's outputs, origins, capacity report, warning texts, a
                strict mapper's error, state, mirror); the canvas EDT of
                the extent, horizon, soak and far runs against scipy; the
                far run's mirror must hold global cocs past 32,767; phases
                1-3 and the five scroll kernels must launch in the small
                scenarios, the generic envelope on the 2-D relax map, and
                every kernel but the generic envelope in the far run.
                Prints the far run's ms per frame beside the scroll path's
                of the same call, with the nvidia-smi line.
 16. entry    - the driver's entry points (gie_mapping_tpu_torch/graft_entry.py,
                the port of the root __graft_entry__.py): entry()'s fn(*args)
                at the cow_lady preset's full width (152x152x80 canvas; a
                scroll from the fresh state's origin to the pivot-0 origin,
                then one merge) bitwise against the JAX entry (state, every
                output, input digests; tests/fixtures/torch_port_entry_ref.npz),
                timed with CUDA events (1 warm call, then 10); then
                dryrun_multichip(4) over [card] * 4 (112x112x72 canvas: one
                merge, a 10-frame replay of precomputed observations with 6
                scrolls, confined-change and raise frames, one relax-engine
                frame), every merge and the replay bitwise against the JAX
                dry run's n = 4, its printed line and its four assertions
                on numbers, timed again without the recording (ms per
                frame); phases 1, 2 and 3 and the canvas shift must launch
                for entry(), phases 1, 2, the generic envelope and the shift
                in the dry run's canvas-engine frames with no phase 3 (the
                sharded EDT), and phase 3 in its relax frame (the window
                EDT).  With two or more cards the dry run again over
                distinct cards; else a line that says it was not run.
 17. bench    - the port's harnesses (gie_mapping_tpu_torch/bench/) at
                full size: the headline (bench.py's run; its state after
                warm-up and the first batch call against the fixture's
                bench run in tests/fixtures/torch_port_replay_ref.npz),
                the suite's six cases (every stage cost measured and
                positive, no clamp; 0 < p50 <= p95 <= worst, or p95 above
                worst only within the two scroll chains' spread: the
                suite's tail_order), the scaling
                point on this card (and on every card where there are
                more), and the 500-frame RMSE soak
                (tests/test_torch_scenario_cases.py's soak_rmse) under the
                JAX test's assertions.  Prints each harness's JSON line,
                each step's wall time and launches.
 18. parts    - the last of the JAX package's examples/ on the port:
                bench/parts.py (every group at cow_lady, the frame group at
                scan2D, depthcam and laser3D; each stage's ms > 0, busy_ms
                <= 1.05 ms, and the kernels it must launch), the
                composition checks (the sensor stage then merge_full equal
                one process_* frame on a copy of the frozen state, every
                MapState field; the scroll steps compose to _do_scroll,
                compact and full; the edt group's batch_edt equals the
                plain chain), bench/teleport.py at depthcam (40 frames, 2
                reps; every arm timed, the jump frames found),
                bench/ab.py (gate and p1c at cow_lady, rung at depthcam,
                engine; both arms timed, their state differences
                printed) and runtime/synthetic_bag.py (10 frames converted
                and replayed through the CLI).  Prints each line, each
                step's wall time and launches.
 19. profile  - only with --profile: torch.profiler over a second run of
                each path of phases 4-7, over bench.py's 40 frames after
                its 3 online ones, online and replayed, and over phases
                9-11's frames (online and replayed).
The kernels phase also holds phase 1 and the two envelopes against their
plain versions at the new paths' canvases and the gate's slabs of them
(240x240x168, 112x112x40, 80x80x40), and the canvas shift and the four
row copies at those canvases' blocks (30x30x21, 14x14x5, 10x10x5) and
their presets' archive sizes (every z arm, shifts past the canvas, a
stream tick's 64 columns, repeated and zero ids, a full scroll's rows),
and times each of the eight there; and the sharded EDT
(batch_edt_sharded, and its y-slabs) on the [152, 152, 80] canvas over 2, 4
and 8 shards of this card, bitwise against the single-device and plain
chains, with its three kernels at the shard shapes and the two all_to_all
reshards timed (the `mesh_shards` line).
Then one line with every kernel's launches (summed over the paths, each
counted from 0 just before it), error, times, bound and share, the
card's nvidia-smi line, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(ROOT, "tests", "fixtures", "torch_port_cow_ref.npz")
REF_SCROLL = os.path.join(ROOT, "tests", "fixtures", "torch_port_cow_scroll_ref.npz")
REF_SCAN2D = os.path.join(ROOT, "tests", "fixtures", "torch_port_scan2d_ref.npz")
REF_FLAT = os.path.join(ROOT, "tests", "fixtures", "torch_port_scan2d_flat_ref.npz")
REF_REPLAY = os.path.join(ROOT, "tests", "fixtures", "torch_port_replay_ref.npz")
REF_SENSOR = {kind: os.path.join(ROOT, "tests", "fixtures",
                                 f"torch_port_{name}_ref.npz")
              for kind, name in (("depth", "depthcam"), ("multiscan", "laser3d"),
                                 ("dda", "dda"))}
# the scroll path's replay: frames per run (make_torch_port_ref.SCROLL_CHUNK)
SCROLL_CHUNK = 10
# the true 2-D map: the scan2D preset with a one-voxel-deep window on the
# relax engine (tests/fixtures/make_torch_port_ref.py::FLAT)
FLAT = dict(local_size_m=(10.0, 10.0, 0.1), merge_mode="relax")
SCROLL_KERNELS = ("shift_canvas", "gather_block_rows", "scatter_block_rows",
                  "gather_archive_rows", "scatter_archive_rows")
LOG: list = []

# the cli phase (tests/fixtures/make_torch_port_ref.py --only cli writes its
# JAX results): every preset through cli.main at its own defaults, one
# replayed in runs of 4, one with the RMSE check; the committed bags; a
# resume; the two side channels
REF_CLI = os.path.join(ROOT, "tests", "fixtures", "torch_port_cli_ref.npz")
# the mesh phase (make_torch_port_ref.py --only mesh writes its fixture)
REF_MESH = os.path.join(ROOT, "tests", "fixtures", "torch_port_mesh_ref.npz")
# the scenarios phase (make_torch_port_ref.py --only scenarios writes it)
REF_SCENARIOS = os.path.join(ROOT, "tests", "fixtures",
                             "torch_port_scenarios_ref.npz")
REF_ENTRY = os.path.join(ROOT, "tests", "fixtures", "torch_port_entry_ref.npz")
ENTRY_REPS = 10  # the entry phase's timed calls of entry()'s fn, after 1 warm
ENTRY_DRYRUN = 4  # the entry phase's dry run: shards over this card
MESH_SIZES = (2, 4, 8)  # the sharded EDT's mesh sizes in the kernels phase
MESH_PATH_SIZES = (2, 4)  # the mesh phase's slice runs over [card] * n
MULTIPROC_FRAMES = 6  # the multiproc phase's frames of the slice
CLI_FRAMES = 4
CLI_CASES = ("cow_lady", "ugv_corridor", "uav_raycast_fine", "depthcam",
             "laser3D", "scan2D")
CLI_RUNS = tuple((c, c, ()) for c in CLI_CASES) + (
    ("cow_lady_batch4", "cow_lady", ("--batch", "4")),
    ("scan2D_profile", "scan2D", ("--profile",)))
CLI_COUNTS = ("frames", "occupied_voxels", "gate_level_last",
              "frontier_voxels", "mirror_blocks", "arch_dropped")
BAGS = (("handmade_v2.bag", "/scan", "/odom"),
        ("handmade_v2_pc2.bag", "/velodyne_points", "/odom"))
RESUME_FRAMES, RESUME_SPLIT = 6, 4


def cli_argv(case, extra, workdir):
    """The CLI's argv for one run: CLI_FRAMES frames, a checkpoint and a
    CSV log in `workdir`."""
    return [case, "--frames", str(CLI_FRAMES),
            "--save", os.path.join(workdir, "map.npz"),
            "--log", os.path.join(workdir, "log.csv"), *extra]


def array_digest(a) -> str:
    """sha256 over an array's dtype, shape and bytes."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def checkpoint_digests(path) -> dict:
    """{key: array_digest} of every array in a checkpoint (the arrays, not
    the compressed file)."""
    import numpy as np

    with np.load(path) as raw:
        return {k: array_digest(raw[k]) for k in raw.files}


def csv_rows(path):
    """The data rows of a CSV log, each a list of cells."""
    with open(path) as f:
        lines = f.read().strip().splitlines()
    return [ln.split(",") for ln in lines[1:]]


def bag_frames(rosbag, path, sensor, odom) -> dict:
    """{"i/field": array} of a bag's frames as `rosbag.bag_to_frames`
    converts them (one second of slop: the handmade bags' poses lie up to
    half a second from their sensor messages)."""
    import numpy as np

    frames = rosbag.bag_to_frames(path, sensor, odom, slop=1.0)
    return {f"{i}/{k}": np.asarray(v) for i, fr in enumerate(frames)
            for k, v in fr.items()}


# the studies' old kernels: a copy of the parent commit's package
# (`git archive`), put here by the caller; git ignores the directory, and
# without the copy the studies have no old times
PARENT = os.path.join(ROOT, "scratch_checkout", "gie_mapping_tpu_torch")


# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes over the H100's 3.35 TB/s and its operations over
# 67 T/s, the card's float32 rate outside the tensor cores (NVIDIA's H100
# SXM data sheet; the integer rate is no higher, so the bound stays a lower
# bound).  Operation counts per element are estimates of what
# the function needs, not what the kernels do: an exact 1-D envelope needs
# O(N) per line (a few compares and a parabola intersection per site), not
# the kernels' O(N^2).
HBM_BYTES_PER_MS = 3.35e9
OPS_PER_MS = 67e9
ENV_OPS_PER_SITE = 10
P1_OPS_PER_VOXEL = 12
CARVE_OPS_PER_VOXEL = 150
PANORAMA_OPS_PER_POINT = 250


def result(max_abs_err, t, plain_ms, *, bytes_, ops, library=None):
    """One kernel's entry of the summary line: its timing `t` (see
    `timing`), its bound, and the timing of one PyTorch call that computes
    the same function, where there is one.  Device times and share =
    bound / device_ms are filled in by `settle` after CLOCK has run."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_MS, ops / OPS_PER_MS
    lib = library or {}
    return dict(max_abs_err=max_abs_err, ms=t["ms"], device_ms=t["device_ms"],
                host_us=t["host_us"], plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                share=None, library_ms=lib.get("ms"),
                library_device_ms=lib.get("device_ms"),
                library_host_us=lib.get("host_us"))


class Job(tuple):
    """Indices of CLOCK's jobs: a device time that stands for their mean."""


class DeviceClock:
    """Timing jobs (fn, kernel, between) collected over the kernels phase
    and measured together by `device_times` in ONE profiler session: in a
    process that opens many sessions, later ones stop getting device
    records."""

    def __init__(self):
        self.jobs, self.times = [], None

    def add(self, fn, kernel=None, between=None) -> Job:
        self.jobs.append((fn, kernel, between))
        return Job((len(self.jobs) - 1,))

    def run(self, reps=20):
        self.times = device_times(self.jobs, reps)
        self.jobs = []

    def ms(self, v):
        """The device time a Job stands for (other values unchanged)."""
        return sum(self.times[i] for i in v) / len(v) if isinstance(v, Job) else v


CLOCK = DeviceClock()


def settle(entry):
    """Fill in an entry's device times from CLOCK, and its share."""
    for k in ("device_ms", "library_device_ms"):
        entry[k] = CLOCK.ms(entry[k])
    entry["share"] = entry["bound_ms"] / entry["device_ms"]
    return entry


def emit(obj):
    line = json.dumps(obj)
    LOG.append(line)
    print(line, flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond, phase, msg):
    if not cond:
        raise PhaseError(f"{phase}: {msg}")


def cuda_ms(fn, reps, warm=2):
    """Mean time of fn() over `reps` back-to-back calls (CUDA events): the
    slower of the device's time and the host's issue rate."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def device_times(jobs, reps=20):
    """Mean device duration per call (ms) of each job's fn.  A job is
    (fn, kernel, between): `kernel` (a name) counts that kernel alone;
    otherwise every kernel fn() launches counts but those of `between()`,
    which runs before each call (an L2 flush).

    The clock is the device's own: torch.profiler's (CUPTI) kernel records
    of one session over all the jobs, a marker kernel before each job's
    `reps` calls and after the last, the records cut at the markers; per
    kernel its total duration over its count (a record may be dropped),
    times its launches per call.  A session whose markers do not all
    arrive is run again; after three such sessions the phase fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            calls()
            torch.cuda.synchronize()
        return sorted(((e.time_range.start, e.name, e.time_range.elapsed_us())
                       for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda r: r[0])

    mark = lambda: torch.cuda._sleep(1000)

    def run_all():
        for fn, _, between in jobs:
            mark()
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
        mark()

    run_all()  # warm-up
    names = {}  # the kernel names of the marker and of each `between`
    for _ in range(3):
        for key, f in [("mark", mark)] + [(id(b), b) for _, _, b in jobs if b]:
            names[key] = names.get(key) or {n for _, n, _ in session(f)}
        recs = session(run_all)
        cuts = [i for i, (_, n, _) in enumerate(recs) if n in names["mark"]]
        if len(cuts) == len(jobs) + 1:
            break
    require(len(cuts) == len(jobs) + 1, "kernels",
            f"three profiler sessions lost marker records ({len(cuts)} of "
            f"{len(jobs) + 1} arrived): no device clock")
    out = []
    for j, (fn, kernel, between) in enumerate(jobs):
        per = {}
        for _, n, us in recs[cuts[j] + 1:cuts[j + 1]]:
            if (kernel in n) if kernel is not None else \
                    n not in names.get(id(between), ()):
                c, t = per.get(n, (0, 0.0))
                per[n] = (c + 1, t + us)
        require(per and all(c >= reps // 2 for c, _ in per.values()), "kernels",
                f"the profiler saw {per} for {reps} calls of {kernel or 'a call'}")
        out.append(sum(t / c * max(1, round(c / reps)) for c, t in per.values()) / 1e3)
    return out


def host_us(fn, calls=200):
    """Host time per call of fn() in microseconds: time.perf_counter over
    `calls` back-to-back calls, the device synchronised once after them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def timing(fn, kernel=None, reps=50):
    """ms (CUDA events over back-to-back calls), device_ms (a CLOCK job)
    and host_us of fn(); `kernel` names the device kernel it launches
    (None: all)."""
    return dict(ms=cuda_ms(fn, reps), device_ms=CLOCK.add(fn, kernel),
                host_us=host_us(fn))


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
            f"nvidia-smi: no output (rc {r.returncode})"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


# ---------------------------------------------------------------------------
def random_canvas(shape, frac, seed, device):
    """int8 type canvas: OCCUPIED with probability frac, else FREE/UNKNOWN."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = np.where(rng.random(shape) < frac, 2,
                 rng.integers(0, 2, shape)).astype(np.int8)
    return torch.from_numpy(t).to(device)


def world_canvas(device):
    """Slice-shaped [152, 152, 80] canvas whose sites are the corridor
    world's boxes and walls sampled at 0.1 m (realistic site structure)."""
    import numpy as np
    import torch

    from gie_mapping_tpu_torch.runtime.datasets import BoxWorld

    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    X, Y, Z = 152, 152, 80
    g = np.stack(np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                             indexing="ij"), -1).astype(np.float32)
    pos = (g - [76, 76, 20]) * 0.1
    occ = world.occupied(pos.reshape(-1, 3)).reshape(X, Y, Z)
    t = np.where(occ, 2, 1).astype(np.int8)
    t[:, :, :8] = 0  # unknown layers: x-lanes and z-columns without a site
    return torch.from_numpy(t).to(device)


def tie_packed(N, L, yb, device):
    """Phase-1 words with many equal-cost sites per lane (distance ties),
    and every 7th lane without a site."""
    import torch

    w = torch.zeros(N, L, dtype=torch.int32)
    for l in range(L):
        if l % 7 == 0:
            continue
        step = 2 + l % 5
        for i in range(l % 3, N, step):
            g1sq = (l % 4) ** 2
            w[i, l] = (g1sq << (yb + 1)) | ((l % 50) << 1) | 1
    return w.to(device)


def start_parent_build():
    """Import the parent commit's package from PARENT under another name
    and start building its kernels beside ours.  Returns a function that
    waits for that build and gives the package (its `ops.kernels` modules
    imported), or None without the copy."""
    import importlib
    import importlib.util
    import threading

    init = os.path.join(PARENT, "__init__.py")
    if not os.path.exists(init):
        return lambda: None
    name = "parent_gie_mapping_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[PARENT])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    build = importlib.import_module(name + ".ops.kernels._build")
    for mod in ("carve", "envelope", "phase1"):
        importlib.import_module(f"{name}.ops.kernels.{mod}")
    importlib.import_module(name + ".ops.raycast")
    err = []

    def run():
        try:
            build.build()
        except RuntimeError as exc:
            err.append(str(exc))
    th = threading.Thread(target=run)
    th.start()

    def finish():
        th.join()
        require(not err, "build", f"the parent's kernels: {err[:1]}")
        build.library()
        return pkg
    return finish


def phase_kernels(dev, results, parent):
    import torch

    from gie_mapping_tpu_torch.ops import edt_batch as eb
    from gie_mapping_tpu_torch.ops.kernels import envelope as ke
    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp
    from gie_mapping_tpu_torch.models.pipeline import _slab_menu

    ph = "kernels"
    X, Y, Z = 152, 152, 80
    mw = X + Y + Z
    yb = kp.phase1_pack_bits(Y)

    # ---- phase 1 ------------------------------------------------------------
    canvases = [world_canvas(dev), random_canvas((X, Y, Z), 0.02, 1, dev),
                random_canvas((X, Y, Z), 0.3, 2, dev),
                random_canvas((37, 41, 29), 0.05, 3, dev),
                torch.zeros((16, 24, 8), dtype=torch.int8, device=dev)]
    p1_cases = [(t, sum(t.shape)) for t in canvases]
    p1_cases += [(torch.from_numpy(t).to(dev), mw1) for t, mw1 in phase1_cases()]
    p1_bad = 0
    for t, mw1 in p1_cases:  # every voxel
        p1_bad += int((kp.phase1_packed(t, mw1) != kp.phase1_packed_plain(t, mw1)).sum())
    # the p1-cache patch: a launch on an x-slab view of a larger buffer
    full = kp.phase1_packed_plain(canvases[0], mw)
    for fx, o in ((32, 0), (48, 40), (64, 88), (96, 56)):
        buf = torch.zeros_like(full)
        kp.phase1_packed(canvases[0][o:o + fx], mw, out=buf[o:o + fx])
        p1_bad += int((buf[o:o + fx] != full[o:o + fx]).sum())
        p1_bad += int(buf[:o].abs().sum() + buf[o + fx:].abs().sum())
    torch.cuda.synchronize()
    require(p1_bad == 0, ph, f"phase1 differs from its plain version in {p1_bad} voxels")
    results["phase1"], p1_report = phase1_study(
        canvases[0], random_canvas((128, 128, 56), 0.02, 4, dev),
        random_canvas((100, 100, 1), 0.01, 6, dev), parent)

    # ---- envelopes ------------------------------------------------------------
    env_bad = {"packed": 0, "mid": 0}
    err = {"packed": 0, "mid": 0}
    cases = []
    for t in canvases[:4]:
        w = kp.phase1_packed_plain(t, sum(t.shape)).permute(0, 2, 1).contiguous()
        cases.append((w, kp.phase1_pack_bits(t.shape[1])))
    cases.append((tie_packed(50, 300, 6, dev), 6))
    cases += [(torch.from_numpy(w).to(dev), ybw) for w, ybw in envelope_cases()]
    for w, ybw in cases:  # every lane, site-free ones included
        kk, kpay = ke.envelope_packed(w, ybw)
        pk, ppay = ke.envelope_packed_plain(w, ybw)
        env_bad["packed"] += int(((kk != pk) | (kpay != ppay)).sum())
        err["packed"] = max(err["packed"], int((kk.long() - pk).abs().max()))
    # phase-3 inputs as the chain builds them, plus random / tie cases
    mids = []
    for t in canvases[:3]:
        w = kp.phase1_packed_plain(t, sum(t.shape)).permute(0, 2, 1).contiguous()
        pk, ppay = ke.envelope_packed_plain(w, kp.phase1_pack_bits(t.shape[1]))
        ib2 = ke.env_idx_bits(t.shape[0])
        d2m = torch.where((ppay & 1) > 0, pk >> ib2, 1 << 28)
        mids.append((d2m, ((pk & ((1 << ib2) - 1)) << 11) | ppay))
    g = torch.Generator().manual_seed(5)
    f = torch.randint(0, 400, (7, 33, 65), generator=g, dtype=torch.int32)
    f[:, :, ::5] = 1 << 28                      # lanes without a site
    f[:, ::3, 1::5] = 9                          # equal costs: ties
    pay = torch.randint(0, 1 << 20, f.shape, generator=g, dtype=torch.int32) | 1
    mids.append((f.to(dev), pay.to(dev)))
    mids += [tuple(torch.from_numpy(a).to(dev) for a in fp) for fp in envelope_cases(mid=True)]
    for f, pay in mids:  # every lane, site-free ones included
        kk, kpay = ke.envelope_mid(f, pay)
        pk, ppay = ke.envelope_mid_plain(f, pay)
        env_bad["mid"] += int(((kk != pk) | (kpay != ppay)).sum())
        err["mid"] = max(err["mid"], int((kk.long() - pk).abs().max()))
    torch.cuda.synchronize()
    require(env_bad["packed"] == 0 and env_bad["mid"] == 0, ph,
            f"envelopes differ from their plain versions: {env_bad}")
    w0 = cases[0][0]
    scan_canvas = random_canvas((128, 128, 56), 0.02, 4, dev)
    results["envelope_packed"], env_report = envelope_packed_study(
        w0, yb, err["packed"], scan_canvas, parent)
    results["envelope_mid"], mid_report = envelope_mid_study(
        mids[0], err["mid"], scan_canvas, parent)
    env5_bad, env5_report = envelope_generic(dev, results, parent)

    # ---- batch_edt / batch_edt_slab (kernel chain vs plain chain on CPU) ------
    edt_bad = 0
    for t in canvases[:4]:
        ref = eb.batch_edt(t.cpu(), sum(t.shape))
        got = eb.batch_edt(t, sum(t.shape))
        edt_bad += sum(int((got[k].cpu() != ref[k]).sum()) for k in ref)
    t = canvases[0]
    p1c = kp.phase1_packed(t, mw)
    p1c_cpu = p1c.cpu()
    ref_full = eb.batch_edt(t.cpu(), mw)
    for sx, sy in _slab_menu((X, Y, Z)):
        for x0, y0 in ((0, 0), (X - sx, Y - sy), (40, 24)):
            for p1 in (None, p1c):
                got = eb.batch_edt_slab(t, x0, y0, sx=sx, sy=sy, max_width=mw,
                                        p1_packed=p1)
                ref = eb.batch_edt_slab(t.cpu(), x0, y0, sx=sx, sy=sy,
                                        max_width=mw,
                                        p1_packed=None if p1 is None else p1c_cpu)
                edt_bad += sum(int((got[k].cpu() != ref[k]).sum()) for k in ref)
                edt_bad += int((ref["dist_sq"] != ref_full["dist_sq"][
                    x0:x0 + sx, y0:y0 + sy]).sum())
    require(edt_bad == 0, ph, f"batch_edt chain differs in {edt_bad} values")

    # ---- the point-cloud sensor model: panorama, then carve ---------------------
    sensor_bad, sensor_report = sensor_model_kernels(dev, results, parent)
    scroll_bad, gather_report = scroll_kernels(dev, results)
    new_bad, new_report = new_shape_kernels(dev)
    mesh_bad, mesh_report = mesh_shard_kernels(dev)
    CLOCK.run()
    for entry in results.values():
        settle(entry)
    p1_report()
    env_report()
    mid_report()
    env5_report()
    sensor_report()
    gather_report()
    new_report()
    mesh_report()
    emit({"phase": ph, "ok": True, "phase1_bad": p1_bad, "envelope_bad": env_bad,
          "new_canvases_bad": new_bad, "mesh_shards_bad": mesh_bad,
          "envelope_generic_bad": env5_bad, "sensor_model_bad": sensor_bad,
          "edt_bad": edt_bad, "scroll_kernels_bad": scroll_bad,
          "ms": {k: round(v["ms"], 4) for k, v in results.items()},
          "device_ms": {k: round(v["device_ms"], 5) for k, v in results.items()},
          "host_us": {k: round(v["host_us"], 2) for k, v in results.items()},
          "plain_ms": {k: round(v["plain_ms"], 4) for k, v in results.items()}})


def new_shape_kernels(dev):
    """The kernels of the sensor paths at their canvases (depthcam
    [240, 240, 168], laser3D [112, 112, 40], uav_raycast_fine [80, 80, 40]),
    bitwise against their plain versions on the card: phase 1 and the two
    envelopes there and at the gate's smallest and largest slab of each;
    the canvas shift and the four row copies (scroll_checks) at each
    preset's canvas blocks and archive size.  Each kernel timed at each
    full canvas (device_ms, ms, host_us, bound).  Returns ({kernel:
    differing values}, a function that prints the times once CLOCK has
    run)."""
    import torch

    from gie_mapping_tpu_torch.models.pipeline import _slab_menu
    from gie_mapping_tpu_torch.ops.kernels import envelope as ke
    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp
    from gie_mapping_tpu_torch.utils.config import (depthcam_config,
                                                     uav_laser3d_config,
                                                     uav_laser3d_fine_config)

    presets = {"depthcam": depthcam_config(), "laser3D": uav_laser3d_config(),
               "uav_raycast_fine": uav_laser3d_fine_config(raycast_mode="dda")}
    bad = {k: 0 for k in ("phase1", "envelope_packed", "envelope_mid") + SCROLL_KERNELS}
    err, rows = {k: 0 for k in bad}, {}

    def compare(name, a, b):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        bad[name] += int((d != 0).sum())
        err[name] = max(err[name], int(d.max()) if d.numel() else 0)

    def chain(t, mw):
        """The three kernels' inputs at canvas t, as batch_edt builds them,
        checked against the plain versions on the way."""
        p1 = kp.phase1_packed(t, mw)
        compare("phase1", p1, kp.phase1_packed_plain(t, mw))
        w = p1.permute(0, 2, 1).contiguous()
        yb = kp.phase1_pack_bits(t.shape[1])
        kk, kpay = ke.envelope_packed(w, yb)
        pk, ppay = ke.envelope_packed_plain(w, yb)
        compare("envelope_packed", kk, pk)
        compare("envelope_packed", kpay, ppay)
        ib2 = ke.env_idx_bits(t.shape[0])
        f = torch.where((ppay & 1) > 0, pk >> ib2, 1 << 28)
        pay = ((pk & ((1 << ib2) - 1)) << 11) | ppay
        km, kmp = ke.envelope_mid(f, pay)
        pm, pmp = ke.envelope_mid_plain(f, pay)
        compare("envelope_mid", km, pm)
        compare("envelope_mid", kmp, pmp)
        return w, yb, f, pay

    for seed, (name, cfg) in enumerate(presets.items()):
        shape = cfg.canvas_size
        t = random_canvas(shape, 0.02, 40 + seed, dev)
        mw = sum(shape)
        w, yb, f, pay = chain(t, mw)
        menu = _slab_menu(shape)
        for sx, sy in (menu[0], menu[-1]):
            chain(t[:sx, :sy].contiguous(), mw)
        n = t.numel()
        fns = {"phase1": (lambda t=t, mw=mw: kp.phase1_packed(t, mw),
                          lambda t=t, mw=mw: kp.phase1_packed_plain(t, mw),
                          5 * n, P1_OPS_PER_VOXEL * n),
               "envelope_packed": (lambda w=w, yb=yb: ke.envelope_packed(w, yb),
                                   lambda w=w, yb=yb: ke.envelope_packed_plain(w, yb),
                                   12 * n, ENV_OPS_PER_SITE * n),
               "envelope_mid": (lambda f=f, pay=pay: ke.envelope_mid(f, pay),
                                lambda f=f, pay=pay: ke.envelope_mid_plain(f, pay),
                                16 * n, ENV_OPS_PER_SITE * n)}
        kname = {"phase1": "phase1_bits_kernel",
                 "envelope_packed": "envelope_packed_fh_kernel",
                 "envelope_mid": "envelope_mid_fh_kernel"}
        inputs = scroll_checks(dev, cfg.canvas_blocks, cfg.max_blocks, 50 + 10 * seed,
                               compare)
        scroll = scroll_timings(cfg.canvas_blocks, inputs)
        for k, (fn, plain, bytes_) in scroll.items():
            fns[k] = (fn, plain, bytes_, 0)
            kname[k] = k + "_kernel"
        for k, (fn, plain, bytes_, ops) in fns.items():
            entry = result(None, timing(fn, kname[k]), cuda_ms(plain, 3, warm=1),
                           bytes_=bytes_, ops=ops)
            if k in ("phase1", "envelope_packed", "envelope_mid"):
                entry["slabs"] = [list(menu[0]), list(menu[-1])]
            else:
                entry["blocks"], entry["archive_rows"] = list(cfg.canvas_blocks), \
                    cfg.max_blocks
            rows[f"{k}@{name}"] = entry
    torch.cuda.synchronize()
    require(not any(bad.values()), "kernels",
            f"kernels differ from their plain versions at the new canvases: {bad}")

    def report():
        for k, entry in rows.items():
            settle(entry)
            entry["max_abs_err"] = err[k.split("@")[0]]
        emit({"phase": "kernels", "new_canvases": {
            k: {f: v for f, v in e.items() if f not in ("library_ms",
                                                      "library_device_ms",
                                                      "library_host_us")}
            for k, e in rows.items()}})
    return bad, report


def mesh_shard_kernels(dev):
    """The sharded EDT (batch_edt_sharded, and batch_edt_sharded_slab at the
    mesh gate's y-slabs) on the cow-lady canvas [152, 152, 80] (the
    corridor world's sites) over [dev] * n for n in MESH_SIZES, bitwise
    against the single-device kernel chain and the plain chain; its three
    kernels bitwise against their plain versions at the shard shapes.  Each
    n's phase 1 ([X/n, Y, Z]), phase 2 ([X, (Z/n) Y]) and generic envelope
    ([Z, (X/n) Y]) timed on one shard (device_ms, ms, host_us, bound), and
    the two all_to_all reshards (every copy and concatenation they launch;
    bound: each word read once and written once).  Returns (differing
    values, a function that prints the times once CLOCK has run)."""
    import torch

    from gie_mapping_tpu_torch.models.pipeline import _slab_menu
    from gie_mapping_tpu_torch.ops import edt_batch as eb
    from gie_mapping_tpu_torch.ops.kernels import envelope as ke
    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp
    from gie_mapping_tpu_torch.parallel.mesh import (all_to_all,
                                                     canvas_sharding, gather,
                                                     make_mesh, put)

    t = world_canvas(dev)
    X, Y, Z = t.shape
    mw = X + Y + Z
    yb, ib2 = kp.phase1_pack_bits(Y), ke.env_idx_bits(X)
    one = eb.batch_edt(t, mw)
    plain = eb.batch_edt(t.cpu(), mw)
    bad = {"edt": 0, "phase1": 0, "envelope_packed": 0, "envelope": 0}
    err = dict.fromkeys(bad, 0)

    def compare(name, a, b):
        d = (a.to(torch.int64).cpu() - b.to(torch.int64).cpu()).abs()
        bad[name] += int((d != 0).sum())
        err[name] = max(err[name], int(d.max()) if d.numel() else 0)

    rows = {}
    for n in MESH_SIZES:
        mesh = make_mesh(devices=[dev] * n)
        xs = put(t, canvas_sharding(mesh))
        got = {k: gather(v) for k, v in eb.batch_edt_sharded(xs, mw).items()}
        for k in one:
            compare("edt", got[k], one[k])
            compare("edt", got[k], plain[k])
        for _, sy in _slab_menu((X, Y, Z)):
            for y0 in (0, Y - sy):
                s = {k: gather(v) for k, v in eb.batch_edt_sharded_slab(
                    xs, y0, sy=sy, max_width=mw).items()}
                for k in one:
                    compare("edt", s[k], plain[k][:, y0:y0 + sy])
        # the chain's shard-shape inputs, as _edt_sharded builds them
        shards = xs.parts
        p1 = [kp.phase1_packed(a, mw) for a in shards]
        compare("phase1", p1[0], kp.phase1_packed_plain(shards[0], mw))
        f2 = all_to_all([eb._zyx(a) for a in p1], 1, 0)
        kk, kpay = ke.envelope_packed(f2[0], yb)
        pk, ppay = ke.envelope_packed_plain(f2[0], yb)
        compare("envelope_packed", kk, pk)
        compare("envelope_packed", kpay, ppay)
        d2m, pay3 = zip(*[eb._phase3_inputs(*ke.envelope_packed(f, yb), ib2)
                          for f in f2])
        f3 = all_to_all([a.movedim(1, 0) for a in d2m], 1, 0)
        p3 = all_to_all([a.movedim(1, 0) for a in pay3], 1, 0)
        kk, kpay = ke.envelope(f3[0], p3[0])
        pk, ppay = ke.envelope_plain(f3[0], p3[0])
        compare("envelope", kk, pk)
        compare("envelope", kpay, ppay)
        v = t.numel()
        s0, g, f, pay = shards[0], f2[0], f3[0], p3[0]
        fns = {
            "phase1": (lambda s0=s0: kp.phase1_packed(s0, mw),
                       lambda s0=s0: kp.phase1_packed_plain(s0, mw),
                       5 * s0.numel(), P1_OPS_PER_VOXEL * s0.numel(),
                       "phase1_bits_kernel", s0.shape),
            "envelope_packed": (lambda g=g: ke.envelope_packed(g, yb),
                                lambda g=g: ke.envelope_packed_plain(g, yb),
                                12 * g.numel(), ENV_OPS_PER_SITE * g.numel(),
                                "envelope_packed_fh_kernel", g.shape),
            "envelope": (lambda f=f, pay=pay: ke.envelope(f, pay),
                         lambda f=f, pay=pay: ke.envelope_plain(f, pay),
                         16 * f.numel(), ENV_OPS_PER_SITE * f.numel(),
                         "envelope_mid_fh_kernel", f.shape),
            "reshard1": (lambda p1=p1: all_to_all([eb._zyx(a) for a in p1], 1, 0),
                         None, 8 * v, 0, None, (n, X // n, Z, Y)),
            "reshard2": (lambda d2m=d2m, pay3=pay3: (
                all_to_all([a.movedim(1, 0) for a in d2m], 1, 0),
                all_to_all([a.movedim(1, 0) for a in pay3], 1, 0)),
                None, 16 * v, 0, None, (2, n, Z // n, X, Y)),
        }
        for k, (fn, plain_fn, bytes_, ops, kname, shape) in fns.items():
            entry = result(None, timing(fn, kname),
                           cuda_ms(plain_fn, 3, warm=1) if plain_fn else None,
                           bytes_=bytes_, ops=ops)
            entry.update(n=n, shape=list(shape))
            if kname:
                entry["launches_per_edt"] = n
            rows[f"{k}@n{n}"] = entry
    torch.cuda.synchronize()
    require(not any(bad.values()), "kernels",
            f"the sharded EDT or its kernels at shard shapes differ: {bad}")

    def report():
        for k, entry in rows.items():
            settle(entry)
            entry["max_abs_err"] = err.get(k.split("@")[0])
        emit({"phase": "kernels", "mesh_shards": {
            k: {f: v for f, v in e.items() if not f.startswith("library")}
            for k, e in rows.items()}})
    return bad, report


def envelope_cases(mid=False):
    """The O(N) envelopes' edge cases (ties, site-free and single-site
    lanes, N at the idx_bits boundaries, costs just below the cap, falling
    costs): [(words int32 numpy [N, ...], yb)] for envelope_packed, or with
    `mid` [(f, pay) int32 numpy [B, N, L]] for envelope_mid; the cases on
    which the CPU tests hold the kernels' numpy models
    (tests/test_torch_envelope_cases.py, numpy only)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_envelope_cases as cases

    if mid:
        return [cases.mid_case(n) for n in cases.MID_CASES]
    return [cases.case(n) for n in cases.CASES]


def phase1_cases():
    """[(types int8 numpy [X, Y, Z], max_width)]: phase 1's edge cases (Y
    across the word boundaries up to 1024, empty and full columns, ties,
    max_width below Y, Z from 1 to 80), on which the CPU tests hold the
    kernel's numpy model (tests/test_torch_phase1_cases.py, numpy only)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_phase1_cases as cases

    return [cases.case(n) for n in cases.CASES]


def turns(new, old, kernel_new, kernel_old):
    """CLOCK jobs in turns, new, old, old, new; `old` may be None."""
    if old is None:
        return [CLOCK.add(new, kernel_new), CLOCK.add(new, kernel_new)]
    return [CLOCK.add(new, kernel_new), CLOCK.add(old, kernel_old),
            CLOCK.add(old, kernel_old), CLOCK.add(new, kernel_new)]


def turn_times(j):
    """(new, old) device times of a `turns` list: the new kernel's two
    readings and the old one's (None without it)."""
    t = [CLOCK.ms(x) for x in j]
    return (t, None) if len(t) == 2 else ([t[0], t[3]], [t[1], t[2]])


def phase1_study(world, scan_canvas, flat_canvas, parent):
    """Phase 1 at the main paths' shapes: the slice's canvas [152, 152, 80],
    the gate's p1-cache patches [32|96, 152, 80] (into x-slab views of a
    cache), scan2d's canvas [128, 128, 56] and scan2d_flat's 2-D window
    [100, 100, 1].  At each, the kernel against the parent's (None without
    its copy), bitwise, device times in turns: new, old, old, new; and the
    z-tile width the wrapper chose.
    Returns the summary entry (at the canvas) and a function that prints
    the study once CLOCK has run."""
    import torch

    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp

    cache = torch.zeros(world.shape, dtype=torch.int32, device=world.device)
    shapes = {"152x152x80": (world, None),
              "32x152x80_p1c": (world[56:88], cache[56:88]),
              "96x152x80_p1c": (world[28:124], cache[28:124]),
              "128x128x56": (scan_canvas, None),
              "100x100x1": (flat_canvas, None)}
    wave = kp.phase1_wave(world.get_device())
    old = None if parent is None else parent.ops.kernels.phase1.phase1_packed
    jobs, bad = [], 0
    for t, out in shapes.values():
        mw = sum(t.shape)
        new = lambda t=t, out=out, mw=mw: kp.phase1_packed(t, mw, out=out)
        ref = kp.phase1_packed_plain(t, mw)
        bad += int((new() != ref).sum())
        run_old = None
        if old is not None:
            o_out = torch.empty_like(ref) if out is None else out
            run_old = lambda t=t, o_out=o_out, mw=mw: old(t, mw, out=o_out)
            run_old()
            bad += int((o_out != ref).sum())
        jobs.append(turns(new, run_old, "phase1_bits_kernel", "phase1_bits_kernel"))
    require(bad == 0, "kernels", f"phase1 study: {bad} voxels differ from the plain version")
    canvas = lambda: kp.phase1_packed(world, sum(world.shape))
    j = jobs[0]
    t = dict(ms=cuda_ms(canvas, 50), device_ms=Job(j[0] + j[-1]), host_us=host_us(canvas))
    plain_ms = cuda_ms(lambda: kp.phase1_packed_plain(world, sum(world.shape)), 10)

    def report():
        rows = {}
        for (label, (t_, _)), j in zip(shapes.items(), jobs):
            new_t, old_t = turn_times(j)
            rows[label] = dict(device_ms=new_t, parent_device_ms=old_t,
                               tile_z=kp.phase1_tile(t_.shape[0], t_.shape[2], wave),
                               bound_ms=5 * t_.numel() / HBM_BYTES_PER_MS)
        emit({"phase": "kernels", "kernel": "phase1_packed", "shapes": rows})
    n = world.numel()
    return result(0, t, plain_ms, bytes_=5 * n, ops=P1_OPS_PER_VOXEL * n), report


def envelope_mid_study(chain, err, scan_canvas, parent):
    """Phase 3 at the main paths' three shapes: the slice's full
    [152, 80, 152] (the chain's input `chain` on the world canvas), the
    gate's slab after frame 0 [96, 80, 96] (that input's x- and y-slab, as
    batch_edt_slab cuts it) and scan2d's [128, 56, 128].  At each, the
    kernel against the parent's (None without its copy), both bitwise
    against the plain version, device times in turns: new, old, old, new.
    Returns
    the summary entry (at the slice's shape) and a function that prints the
    study once CLOCK has run."""
    import torch

    from gie_mapping_tpu_torch.ops.kernels import envelope as ke
    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp

    d0, p0 = chain
    s3 = scan_canvas.shape
    w3 = kp.phase1_packed_plain(scan_canvas, sum(s3)).permute(0, 2, 1).contiguous()
    pk, ppay = ke.envelope_packed_plain(w3, kp.phase1_pack_bits(s3[1]))
    ib2 = ke.env_idx_bits(s3[0])
    shapes = {
        "152x80x152": (d0, p0),
        "96x80x96": (d0[28:124, :, 28:124].contiguous(),
                     p0[28:124, :, 28:124].contiguous()),
        "128x56x128": (torch.where((ppay & 1) > 0, pk >> ib2, 1 << 28),
                       ((pk & ((1 << ib2) - 1)) << 11) | ppay),
    }
    pke = None if parent is None else parent.ops.kernels.envelope
    jobs, bad = [], 0
    for f, pay in shapes.values():
        new = lambda f=f, pay=pay: ke.envelope_mid(f, pay)
        old = None if pke is None else (lambda f=f, pay=pay: pke.envelope_mid(f, pay))
        ref = ke.envelope_mid_plain(f, pay)
        for run in (new, old) if old else (new,):
            bad += sum(int((a != b).sum()) for a, b in zip(run(), ref))
        jobs.append(turns(new, old, "envelope_mid_fh_kernel", "envelope_mid_fh_kernel"))
    require(bad == 0, "kernels", f"envelope_mid study: {bad} words differ from the plain version")
    new = lambda: ke.envelope_mid(d0, p0)
    j = jobs[0]
    t = dict(ms=cuda_ms(new, 20), device_ms=Job(j[0] + j[-1]), host_us=host_us(new))
    plain_ms = cuda_ms(lambda: ke.envelope_mid_plain(d0, p0), 3, warm=1)

    def report():
        rows = {}
        for (label, (f, _)), j in zip(shapes.items(), jobs):
            new_t, old_t = turn_times(j)
            rows[label] = dict(device_ms=new_t, parent_device_ms=old_t,
                               bound_ms=16 * f.numel() / HBM_BYTES_PER_MS)
        emit({"phase": "kernels", "kernel": "envelope_mid", "shapes": rows})
    n3 = d0.numel()
    return result(err, t, plain_ms, bytes_=16 * n3, ops=ENV_OPS_PER_SITE * n3), report


def envelope_packed_study(w_slice, yb, err, scan_canvas, parent):
    """Phase 2 at the main paths' three shapes: the slice's full
    [152, 80 * 152], the gate's slab after frame 0 [152, 80 * 96] and
    scan2d's [128, 56 * 128].  At each, the kernel against the parent's
    (None without its copy), both bitwise against the plain version,
    device times in turns: new, old, old, new.
    Returns the summary entry (at the slice's shape) and a function that
    prints the comparison once CLOCK has run."""
    from gie_mapping_tpu_torch.ops.kernels import envelope as ke
    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp

    X, Z, Y = 152, 80, 152
    s3 = scan_canvas.shape
    shapes = {
        "152x12160": (w_slice, yb),
        "152x7680": (w_slice.reshape(X, Z, Y)[:, :, 28:124].contiguous(), yb),
        "128x7168": (kp.phase1_packed_plain(scan_canvas, sum(s3))
                     .permute(0, 2, 1).contiguous(), kp.phase1_pack_bits(s3[1])),
    }
    pke = None if parent is None else parent.ops.kernels.envelope
    jobs, bad = [], 0
    for w, ybw in shapes.values():
        new = lambda w=w, ybw=ybw: ke.envelope_packed(w, ybw)
        old = None if pke is None else (lambda w=w, ybw=ybw: pke.envelope_packed(w, ybw))
        ref = ke.envelope_packed_plain(w, ybw)
        for run in (new, old) if old else (new,):
            bad += sum(int((a != b).sum()) for a, b in zip(run(), ref))
        jobs.append(turns(new, old, "envelope_packed_fh_kernel",
                          "envelope_packed_fh_kernel"))
    require(bad == 0, "kernels", f"envelope_packed study: {bad} words differ "
            "from the plain version")
    new = lambda: ke.envelope_packed(w_slice, yb)
    t = dict(ms=cuda_ms(new, 20), device_ms=Job(jobs[0][0] + jobs[0][-1]),
             host_us=host_us(new))
    plain_ms = cuda_ms(lambda: ke.envelope_packed_plain(w_slice, yb), 3, warm=1)

    def report():
        rows = {}
        for (label, (w, _)), j in zip(shapes.items(), jobs):
            new_t, old_t = turn_times(j)
            rows[label] = dict(device_ms=new_t, parent_device_ms=old_t,
                               bound_ms=12 * w.numel() / HBM_BYTES_PER_MS)
        emit({"phase": "kernels", "kernel": "envelope_packed", "shapes": rows})
    n2 = w_slice.numel()
    return result(err, t, plain_ms, bytes_=12 * n2, ops=ENV_OPS_PER_SITE * n2), report


def packed_words(shape, seed, device):
    """Random packed voxel words (int32 bit patterns) whose 16-bit coc
    halves include the 0x7FFF sentinel and negative values."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    w = np.where(rng.random(shape) < 0.1, (w & 0xFFFF0000) | 0x7FFF, w)
    w = np.where(rng.random(shape) < 0.1, (w & 0xFFFF) | 0x7FFF0000, w)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def scroll_checks(dev, cb, B, seed, compare):
    """The canvas shift and the four row copies against their plain
    versions, bitwise (`compare(name, kernel's, plain's)`), at canvas blocks
    `cb` and an archive of B rows: every z arm of the TPU kernel and shifts
    past the canvas; all block columns, a stream tick's 64 (valid first,
    zero padding repeated) and repeated ids; a full scroll's rows into the
    archive (unique valid slots; where the canvas holds more blocks than the
    archive, the rest invalid on slot 0, as _do_scroll passes them) and
    gathers of 1, 32 columns' and all columns' rows.  Returns the inputs
    the timings use."""
    import numpy as np
    import torch

    from gie_mapping_tpu_torch import map_state as ms
    from gie_mapping_tpu_torch.ops.kernels import blockrows as kb
    from gie_mapping_tpu_torch.ops.kernels import shift as ks

    bx, by, bz = cb
    X, Y, Z = 8 * bx, 8 * by, 8 * bz
    ncols = bx * by
    nb = ncols * bz
    # ---- shift: every z arm of the TPU kernel, and shifts past the canvas
    cv = packed_words((X, Y, 3 * Z), seed, dev)
    dflt = torch.from_numpy(np.tile(ms._PACKED_DEFAULT, Z).view(np.int32)).to(dev)
    for sh in ((1, 0, 0), (-1, 0, 0), (1, -1, 0), (0, 0, 1), (0, 0, -1),
               (0, 0, 3), (0, 0, -3), (0, 0, bz - 1), (0, 0, 1 - bz),
               (0, 0, bz + 2), (0, 0, -bz - 2), (bx + 1, 0, 0),
               (-bx - 1, 0, 0), (3, -2, 2), (1 << 27, 0, 0)):
        compare("shift_canvas", ks.shift_canvas(cv, dflt, sh),
                ks.shift_canvas_plain(cv, dflt, sh))
    # ---- canvas block-columns -> rows: all columns, a stream tick's 64
    # (valid first, zero padding repeated), repeats
    packed = cv.reshape(X, Y, Z, 3)
    g = torch.Generator().manual_seed(seed + 1)
    id_sets = [torch.arange(ncols, dtype=torch.int32),
               torch.cat([torch.randperm(ncols, generator=g)[:40].to(torch.int32),
                          torch.zeros(24, dtype=torch.int32)]),
               torch.tensor([7, 7, ncols - 1, 0, 7], dtype=torch.int32)]
    for ids in id_sets:
        ids = ids.to(dev)
        compare("gather_block_rows", kb.gather_block_rows(packed, ids, cb),
                kb.gather_block_rows_plain(packed, ids, cb))
    # ---- rows -> canvas blocks: partly valid unique columns with repeated
    # invalid (zero) column ids, all invalid, everything valid
    perm = torch.randperm(ncols, generator=g).to(torch.int32)
    cols = torch.cat([perm[:48], torch.zeros(16, dtype=torch.int32)]).to(dev)
    rows = packed_words((64 * bz, 512, 3), seed + 2, dev)
    part = (torch.rand(64 * bz, generator=g) < 0.5).to(torch.int32)
    part[48 * bz:] = 0
    for c, r, v in ((cols, rows, part.to(dev)),
                    (cols, rows, torch.zeros(64 * bz, dtype=torch.int32, device=dev)),
                    (perm.to(dev), packed_words((nb, 512, 3), seed + 3, dev),
                     torch.ones(nb, dtype=torch.int32, device=dev))):
        compare("scatter_block_rows",
                kb.scatter_block_rows(packed.clone(), r, c, v, cb),
                kb.scatter_block_rows_plain(packed.clone(), r, c, v, cb))
    # ---- archive rows: a full scroll's nb rows, unique valid targets
    arch = packed_words((B, 1536), seed + 4, dev)
    na = min(nb, B)
    aids = torch.cat([torch.randperm(B, generator=g)[:na].to(torch.int32),
                      torch.zeros(nb - na, dtype=torch.int32)]).to(dev)
    # gathers of K = 1, 32 columns' and all columns' rows with repeated ids
    # and ids 0 and B - 1
    for K in (1, 32 * bz, nb):
        ids = torch.randint(0, B, (K,), generator=g, dtype=torch.int32)
        ids[0] = B - 1
        if K > 3:
            ids[1], ids[2] = 0, ids[3]
        ids = ids.to(dev)
        compare("gather_archive_rows", kb.gather_archive_rows(arch, ids),
                kb.gather_archive_rows_plain(arch, ids))
    arows = packed_words((nb, 512, 3), seed + 5, dev)
    for v in ((torch.rand(nb, generator=g) < 0.5).to(torch.int32),
              torch.zeros(nb, dtype=torch.int32), torch.ones(nb, dtype=torch.int32)):
        v[na:] = 0
        v = v.to(dev)
        compare("scatter_archive_rows",
                kb.scatter_archive_rows(arch.clone(), arows, aids, v),
                kb.scatter_archive_rows_plain(arch.clone(), arows, aids, v))
    return dict(cv=cv, dflt=dflt, packed=packed, s64=id_sets[1].to(dev),
                perm=perm.to(dev), arch=arch, aids=aids[:na], arows=arows[:na],
                g=g)


def scroll_timings(cb, i):
    """{kernel: (kernel's call, plain call, kernel name, bytes)} at canvas
    blocks `cb` on scroll_checks' inputs `i`: a 1-block x shift; a stream
    tick's 64 columns out; a full scroll bucket of every column in; a full
    scroll's rows into the archive (as many as it holds).  Bytes are each
    kernel's rows (or the canvas) read once and written once."""
    import torch

    from gie_mapping_tpu_torch.ops.kernels import blockrows as kb
    from gie_mapping_tpu_torch.ops.kernels import shift as ks

    cv, dflt, packed, s64, perm = (i[k] for k in ("cv", "dflt", "packed", "s64", "perm"))
    arch2, arows, aids = i["arch"].clone(), i["arows"], i["aids"]
    nb, na = perm.numel() * cb[2], aids.numel()
    all_valid = torch.ones(nb, dtype=torch.int32, device=cv.device)
    r_all = kb.gather_block_rows(packed, perm, cb)
    return {
        "shift_canvas": (lambda: ks.shift_canvas(cv, dflt, (1, 0, 0)),
                         lambda: ks.shift_canvas_plain(cv, dflt, (1, 0, 0)),
                         2 * cv.numel() * 4),
        "gather_block_rows": (lambda: kb.gather_block_rows(packed, s64, cb),
                              lambda: kb.gather_block_rows_plain(packed, s64, cb),
                              2 * s64.numel() * cb[2] * 1536 * 4),
        "scatter_block_rows": (
            lambda: kb.scatter_block_rows(packed, r_all, perm, all_valid, cb),
            lambda: kb.scatter_block_rows_plain(packed, r_all, perm, all_valid, cb),
            2 * nb * 1536 * 4),
        "scatter_archive_rows": (
            lambda: kb.scatter_archive_rows(arch2, arows, aids, all_valid[:na]),
            lambda: kb.scatter_archive_rows_plain(arch2, arows, aids, all_valid[:na]),
            2 * na * 1536 * 4),
        "gather_archive_rows": (
            lambda: kb.gather_archive_rows(arch2, aids),
            lambda: kb.gather_archive_rows_plain(arch2, aids),
            2 * na * 1536 * 4),
    }


def scroll_kernels(dev, results):
    """The canvas shift and the four row copies against their plain
    versions, bitwise, at the cow-lady scroll's shapes (scroll_checks), and
    timed there; returns the count of differing words per kernel and the
    archive gather study's report."""
    import torch

    from gie_mapping_tpu_torch.ops.kernels import blockrows as kb

    ph = "kernels"
    cb, B = (19, 19, 10), 11997
    bad, err = {}, {}

    def compare(name, a, b):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        bad[name] = bad.get(name, 0) + int((d != 0).sum())
        err[name] = max(err.get(name, 0), int(d.max()))
    i = scroll_checks(dev, cb, B, 21, compare)
    torch.cuda.synchronize()
    require(not any(bad.values()), ph, f"scroll kernels differ from their plain versions: {bad}")
    timings = scroll_timings(cb, i)
    # one PyTorch call that computes the same function, where there is one:
    # index_copy_ for the archive rows; for the block rows, the plain
    # versions' one advanced-indexing copy on a view of the canvas, with
    # its index arithmetic made beforehand
    packed, s64, perm = i["packed"], i["s64"], i["perm"]
    arch2 = i["arch"].clone()
    aids64 = i["aids"].long()
    arows2 = i["arows"].reshape(-1, 1536)
    view = packed.reshape(cb[0], 8, cb[1], 8, cb[2], 24)
    g_ix = kb._entries(s64, cb[2], cb[1])
    s_ix = kb._entries(perm, cb[2], cb[1])
    s_rows = kb.gather_block_rows(packed, perm, cb).reshape(-1, 8, 8, 24)

    def scatter_view():
        view[s_ix[0], :, s_ix[1], :, s_ix[2], :] = s_rows
    library = {"scatter_archive_rows": lambda: arch2.index_copy_(0, aids64, arows2),
               "gather_block_rows": lambda: view[g_ix[0], :, g_ix[1], :, g_ix[2], :],
               "scatter_block_rows": scatter_view}
    for k, (fk, fp, moved) in timings.items():
        if k == "gather_archive_rows":
            continue  # its entry is the study's (archive_gather_study)
        results[k] = result(
            err[k], timing(fk, k + "_kernel"), cuda_ms(fp, 10), bytes_=moved,
            ops=0, library=timing(library[k]) if k in library else None)
    results["gather_archive_rows"], report = archive_gather_study(
        dev, i["arch"], err["gather_archive_rows"], i["g"])
    return bad, report


def archive_gather_study(dev, arch, err, g):
    """gather_archive_rows against index_select at the row counts a
    cow-lady scroll launches (10 z-blocks times its column bucket of 32,
    64, 128 or all 361), with warm L2 (back-to-back calls) and cold (a
    64 MB write between calls; the 73.7 MB archive exceeds the 50 MB L2).
    Device times in turns: kernel, index_select, index_select, kernel.
    Returns the summary entry at K = 3610, cold (the state a scroll finds
    the archive in; warm, L2 serves part of the reads and the time can
    fall below the HBM bound), and a function that prints the study once
    CLOCK has run."""
    import torch

    from gie_mapping_tpu_torch.ops.kernels import blockrows as kb

    B = arch.shape[0]
    flush = torch.empty(16 << 20, dtype=torch.int32, device=dev)
    cold = lambda: flush.fill_(1)
    jobs, rows = [], []
    for K in (320, 640, 1280, 3610):
        ids = torch.randperm(B, generator=g)[:K].to(torch.int32).to(dev)
        ids64 = ids.long()
        kern = (lambda ids=ids: kb.gather_archive_rows(arch, ids),
                "gather_archive_rows_kernel")
        lib = (lambda ids64=ids64: arch.index_select(0, ids64), None)
        for l2 in ("warm", "cold"):
            btw = cold if l2 == "cold" else None
            jobs.append([CLOCK.add(f, k, btw) for f, k in (kern, lib, lib, kern)])
            rows.append(dict(K=K, l2=l2, bound_ms=2 * K * 6144 / HBM_BYTES_PER_MS))
            if l2 == "warm":
                rows[-1].update(host_us=host_us(kern[0]),
                                index_select_host_us=host_us(lib[0]))
    # the summary entry: the last row count (3610), cold; host time is
    # read with warm L2 (the host's work does not depend on it)
    warm, j = rows[-2], jobs[-1]
    entry = result(
        err, dict(ms=cuda_ms(kern[0], 50), device_ms=Job(j[0] + j[3]),
                  host_us=warm["host_us"]),
        cuda_ms(lambda: kb.gather_archive_rows_plain(arch, ids), 10),
        bytes_=2 * K * 6144, ops=0,
        library=dict(ms=cuda_ms(lib[0], 50), device_ms=Job(j[1] + j[2]),
                     host_us=warm["index_select_host_us"]))

    def report():
        for r, j in zip(rows, jobs):
            r.update(device_ms=[CLOCK.ms(j[0]), CLOCK.ms(j[3])],
                     index_select_device_ms=[CLOCK.ms(j[1]), CLOCK.ms(j[2])])
        emit({"phase": "kernels", "kernel": "gather_archive_rows", "study": rows})
    return entry, report


def cost_lanes(N, L, seed, device):
    """Site costs int32 [N, L] for the generic envelope: random costs with
    ties, cap-valued and site-free (1 << 28) sites, lanes without a site
    and lanes whose every site sits at the cap; and a payload per site."""
    import torch

    from gie_mapping_tpu_torch.ops.kernels import envelope as ke

    g = torch.Generator().manual_seed(seed)
    cap = (1 << (31 - ke.env_idx_bits(N))) - 1
    f = torch.randint(0, 300, (N, L), generator=g, dtype=torch.int32)
    f[torch.rand(N, L, generator=g) < 0.4] = 1 << 28
    f[torch.rand(N, L, generator=g) < 0.1] = cap
    f[:, 1::4] = torch.where(torch.rand(N, len(range(1, L, 4)), generator=g) < 0.5,
                             5, 1 << 28).to(torch.int32)
    f[:, ::9] = 1 << 28
    f[:, 4::9] = cap
    pay = torch.randint(0, 1 << 30, (N, L), generator=g, dtype=torch.int32)
    return f.to(device), pay.to(device)


def envelope_generic(dev, results, parent):
    """Kernel 5 (the generic axis-0 envelope) against its plain version,
    bitwise, on every lane: N in {1, 2, 100, 128, 152}, lane counts that are
    not multiples of 32, the edge cases of tests/test_torch_envelope_cases.py
    as [N, B * L] lanes, and the shapes [100, 100] (the 2-D window's phase
    2), [128, 56 * 128] and [56, 128 * 128] (the sharded EDT's class).  At
    those three, device times in turns against the parent's kernel (None
    without its copy).  Returns the differing words and a function that
    prints the study once CLOCK has run."""
    import torch

    from gie_mapping_tpu_torch.ops.kernels import envelope as ke

    shapes = [(1, 45), (2, 45), (100, 77), (128, 1003), (152, 333),
              (100, 100), (128, 56 * 128), (56, 128 * 128)]
    cases = [cost_lanes(N, L, 40 + i, dev) for i, (N, L) in enumerate(shapes)]
    for f, pay in envelope_cases(mid=True):
        B, N, L = f.shape
        cols = lambda a: torch.from_numpy(a).permute(1, 0, 2).reshape(N, B * L)
        cases.append((cols(f).contiguous().to(dev), cols(pay).contiguous().to(dev)))
    bad, err = 0, 0
    for f, pay in cases:
        kk, kp_ = ke.envelope(f, pay)
        pk, pp = ke.envelope_plain(f, pay)
        bad += int(((kk != pk) | (kp_ != pp)).sum())
        err = max(err, int((kk.to(torch.int64) - pk).abs().max()))
    pke = None if parent is None else parent.ops.kernels.envelope
    jobs = []
    for f, pay in cases[5:8]:
        new = lambda f=f, pay=pay: ke.envelope(f, pay)
        old = None if pke is None else (lambda f=f, pay=pay: pke.envelope(f, pay))
        if old:
            bad += sum(int((a != b).sum()) for a, b in zip(old(), ke.envelope_plain(f, pay)))
        # the parent's generic envelope is phase 3's kernel with B = 1 too
        jobs.append(turns(new, old, "envelope_mid_fh_kernel",
                          "envelope_mid_fh_kernel"))
    torch.cuda.synchronize()
    require(bad == 0, "kernels", f"envelope differs from its plain version in {bad} words")
    f, pay = cases[5]
    new = lambda: ke.envelope(f, pay)
    j = jobs[0]
    results["envelope"] = result(
        err, dict(ms=cuda_ms(new, 20), device_ms=Job(j[0] + j[-1]),
                  host_us=host_us(new)),
        cuda_ms(lambda: ke.envelope_plain(f, pay), 10),
        bytes_=16 * f.numel(), ops=ENV_OPS_PER_SITE * f.numel())
    extra = {f"{N}x{L}": dict(ms=cuda_ms(lambda f=f, pay=pay: ke.envelope(f, pay), 20),
                              plain_ms=cuda_ms(lambda f=f, pay=pay: ke.envelope_plain(f, pay),
                                               3, warm=1))
             for (N, L), (f, pay) in zip(shapes[6:8], cases[6:8])}

    def report():
        rows = {}
        for (N, L), (f, _), j in zip(shapes[5:8], cases[5:8], jobs):
            new_t, old_t = turn_times(j)
            rows[f"{N}x{L}"] = dict(device_ms=new_t, parent_device_ms=old_t,
                                    bound_ms=16 * f.numel() / HBM_BYTES_PER_MS,
                                    **extra.get(f"{N}x{L}", {}))
        emit({"phase": "kernels", "kernel": "envelope", "bad": bad, "shapes": rows})
    return bad, report


def sensor_scene(dev, world, preset, pose, seed):
    """One point-cloud frame of `preset` ("cow_lady": a 100x100x30 window of
    0.1 m voxels, heights 0-2.5 m; "ugv_corridor": 200x200x24 of 0.05 m,
    heights -10-10 m) at pose ((x, y, z), yaw): the world's 131072 points
    on the card, every 37th invalid, and the keyword arguments of
    panorama and carve."""
    import numpy as np
    import torch

    from gie_mapping_tpu_torch.ops import raycast as rcm
    from gie_mapping_tpu_torch.utils import geometry as geo

    local, vw, (lo, hi) = {"cow_lady": ((100, 100, 30), 0.1, (0.0, 2.5)),
                           "ugv_corridor": ((200, 200, 24), 0.05, (-10.0, 10.0))}[preset]
    pos, yaw = pose
    proj = geo.Projection.from_pose(np.asarray(pos, np.float32),
                                    (np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)))
    pts = world.pointcloud(proj, n_rays=131072, max_range=8.0, seed=seed)
    world_pts = proj.to(dev).l2g(torch.from_numpy(pts).to(dev))
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    valid[::37] = False
    origin = np.asarray(pos, np.float32)
    pvt = geo.calculate_pivot(origin, vw, local)
    nt, npp = rcm.panorama_bins(local)
    pano = dict(local_size=local, voxel_width=vw, ogm_min_h=lo, ogm_max_h=hi,
                n_theta=nt, n_phi=npp)
    carve = dict(local_size=local, voxel_width=vw, n_theta=nt, n_phi=npp,
                 for_motion_planner=bool(seed % 2), robot_r2_grids=16)
    return world_pts, valid, origin, pvt, pano, carve


def sensor_model_kernels(dev, results, parent):
    """The panorama and the carve against their plain versions, bitwise on
    every bin, count and voxel: the cow-lady window at the three poses of
    the carve's CPU tests with 131072 points each, the ugv_corridor window
    at one, and the cases of tests/test_torch_carve_cases.py.  Times both
    kernels at the two windows, the carve against the parent's kernel and
    the whole sensor model (pointcloud_project) against the parent's
    (None without its copy).  Returns the differing values and a function
    that prints the study once CLOCK has run."""
    import torch

    from gie_mapping_tpu_torch.ops import raycast as rcm
    from gie_mapping_tpu_torch.ops.kernels import carve as kc
    from gie_mapping_tpu_torch.runtime.datasets import BoxWorld

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_carve_cases as cc

    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    scenes = [sensor_scene(dev, world, "cow_lady", pose, seed) for seed, pose in
              enumerate((((0.0, 0.0, 1.2), 0.0), ((0.37, -0.81, 1.13), 0.7),
                         ((-1.05, 0.55, 0.9), 2.1)))]
    scenes.append(sensor_scene(dev, world, "ugv_corridor", ((0.61, -0.33, 0.45), 1.3), 4))
    for name in cc.POINTS:
        c = cc.points(name)
        scenes.append((torch.from_numpy(c["points"]).to(dev),
                       torch.from_numpy(c["valid"]).to(dev), c["origin"], c["pvt"],
                       dict(local_size=c["local_size"], voxel_width=c["voxel_width"],
                            ogm_min_h=c["ogm_min_h"], ogm_max_h=c["ogm_max_h"],
                            n_theta=c["n_theta"], n_phi=c["n_phi"]),
                       dict(local_size=c["local_size"], voxel_width=c["voxel_width"],
                            n_theta=c["n_theta"], n_phi=c["n_phi"],
                            for_motion_planner=name.startswith("cloud"),
                            robot_r2_grids=16)))
    bad = {"panorama": 0, "carve": 0}
    err = {"panorama": 0, "carve": 0}

    def compare(name, got, want):
        for a, b in zip(got, want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            d = (a.to(torch.int64) - b.to(torch.int64)).abs()
            bad[name] += int((d != 0).sum())
            err[name] = max(err[name], int(d.max()))

    n_bins, n_vox = 0, 0
    for pts, valid, origin, pvt, pkw, ckw in scenes:
        tables = kc.panorama(pts, valid, origin, pvt, **pkw)
        compare("panorama", tables, kc.panorama_plain(pts, valid, origin, pvt, **pkw))
        compare("carve", kc.carve(*tables, pvt, origin, **ckw),
                kc.carve_plain(*tables, pvt, origin, **ckw))
        n_bins += tables[0].numel()
        n_vox += tables[2].numel()
    for name in cc.WINDOWS:  # random tables: every kind of bin
        w = cc.window(name)
        tables = [torch.from_numpy(a).to(dev) for a in cc.tables(name)]
        ckw = dict(local_size=w["local_size"], voxel_width=w["voxel_width"],
                   n_theta=w["n_theta"], n_phi=w["n_phi"],
                   for_motion_planner=name.endswith("_off"), robot_r2_grids=16)
        compare("carve", kc.carve(*tables, w["pvt"], w["origin"], **ckw),
                kc.carve_plain(*tables, w["pvt"], w["origin"], **ckw))
        n_vox += tables[2].numel()
    torch.cuda.synchronize()
    emit({"phase": "kernels", "sensor_model_mismatch": bad, "bins": n_bins,
          "voxels": n_vox})
    require(not any(bad.values()), "kernels",
            f"the sensor model's kernels differ from their plain versions: {bad}")

    pkc = None if parent is None else parent.ops.kernels.carve
    prc = None if parent is None else parent.ops.raycast
    jobs, rows = [], {}
    for label, (pts, valid, origin, pvt, pkw, ckw) in (("cow_lady_100x100x30", scenes[0]),
                                                       ("ugv_corridor_200x200x24", scenes[3])):
        tables = kc.panorama(pts, valid, origin, pvt, **pkw)
        pano = lambda a=(pts, valid, origin, pvt), k=pkw: kc.panorama(*a, **k)
        new = lambda t=tables, a=(pvt, origin), k=ckw: kc.carve(*t, *a, **k)
        old = None if pkc is None else (
            lambda t=tables, a=(pvt, origin), k=ckw: pkc.carve(*t, *a, **k))
        if old:
            compare("carve", old(), new())
        jobs.append((CLOCK.add(pano), turns(new, old, "carve_kernel", "carve_kernel")))
        proj_kw = dict(pkw, for_motion_planner=ckw["for_motion_planner"],
                       robot_r2_grids=16)
        model = lambda a=(pts, valid, origin, pvt), k=proj_kw: rcm.pointcloud_project(*a, **k)
        rows[label] = dict(
            points=int(pts.shape[0]), voxels=int(tables[2].numel()),
            panorama=dict(ms=cuda_ms(pano, 50), host_us=host_us(pano),
                          plain_ms=cuda_ms(lambda a=(pts, valid, origin, pvt), k=pkw:
                                           kc.panorama_plain(*a, **k), 10),
                          bound_ms=panorama_bytes(pts, tables) / HBM_BYTES_PER_MS),
            carve=dict(ms=cuda_ms(new, 50), host_us=host_us(new),
                       plain_ms=cuda_ms(lambda t=tables, a=(pvt, origin), k=ckw:
                                        kc.carve_plain(*t, *a, **k), 5),
                       bound_ms=carve_bytes(tables) / HBM_BYTES_PER_MS),
            pointcloud_project=dict(ms=cuda_ms(model, 50), host_us=host_us(model)))
        if prc is not None:
            old_model = lambda a=(pts, valid, origin, pvt), k=proj_kw: prc.pointcloud_project(*a, **k)
            compare("carve", old_model(), model())
            rows[label]["pointcloud_project"].update(
                parent_ms=cuda_ms(old_model, 20), parent_host_us=host_us(old_model, 50))
    require(not any(bad.values()), "kernels",
            f"the sensor model differs from the parent's: {bad}")
    pts, valid, origin, pvt, pkw, ckw = scenes[0]
    tables = kc.panorama(pts, valid, origin, pvt, **pkw)
    row = rows["cow_lady_100x100x30"]
    jp, jc = jobs[0]
    results["panorama"] = result(
        err["panorama"], dict(ms=row["panorama"]["ms"], device_ms=jp,
                              host_us=row["panorama"]["host_us"]),
        row["panorama"]["plain_ms"], bytes_=panorama_bytes(pts, tables),
        ops=PANORAMA_OPS_PER_POINT * pts.shape[0])
    results["carve"] = result(
        err["carve"], dict(ms=row["carve"]["ms"], device_ms=Job(jc[0] + jc[-1]),
                           host_us=row["carve"]["host_us"]),
        row["carve"]["plain_ms"], bytes_=carve_bytes(tables),
        ops=CARVE_OPS_PER_VOXEL * tables[2].numel())

    def report():
        for (label, r), (jp, jc) in zip(rows.items(), jobs):
            new_t, old_t = turn_times(jc)
            r["panorama"]["device_ms"] = CLOCK.ms(jp)
            r["carve"].update(device_ms=new_t, parent_device_ms=old_t)
        emit({"phase": "kernels", "kernel": "sensor_model", "shapes": rows})
    return sum(bad.values()), report


def panorama_bytes(points, tables):
    """What the panorama must move: 12 bytes of position and 1 of validity
    a point read, its two tables and the endpoint counts written."""
    return 13 * points.shape[0] + 4 * sum(t.numel() for t in tables)


def carve_bytes(tables):
    """What the carve must move: its tables and the endpoint counts read, a
    ray count and a type a voxel written."""
    depth, cnt, ep = tables
    return 4 * (depth.numel() + cnt.numel()) + 9 * ep.numel()


def run_slice(dev, frames, poses, wrappers=(), loop_ctx=None, mesh=None):
    """Drive the slice through VolumetricMapper.process_pointcloud (on
    `dev`, or over `mesh`); the launch counters of `wrappers` are zeroed
    right before the first frame, and `loop_ctx` (a context manager) wraps
    the frame loop alone.  Returns (mapper, per-frame records)."""
    import torch

    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.runtime.datasets import cow_lady_slice
    from gie_mapping_tpu_torch.utils.config import cow_lady_config

    overrides, _, _ = cow_lady_slice()
    mapper = VolumetricMapper(cow_lady_config(**overrides),
                              device=None if mesh else dev, mesh=mesh)
    mapper.warmup(robot_pos=poses[0][0])
    staged = [mapper.stage_pointcloud(p) for p in frames]
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    recs = []
    with loop_ctx or contextlib.nullcontext():
        _frames(mapper, poses, staged, recs)
    return mapper, recs


def _frames(mapper, poses, staged, recs):
    import numpy as np
    import torch

    from gie_mapping_tpu_torch.map_state import output_digest
    from gie_mapping_tpu_torch.utils import geometry as geo

    for i, ((pos, quat), (pts, val)) in enumerate(zip(poses, staged)):
        proj = geo.Projection.from_pose(pos, quat)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        out = mapper.process_pointcloud(proj, pts, val)
        e.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        gt = out.glb_type
        recs.append(dict(
            frame=i, gate_level=int(out.gate_level),
            occupied=int((gt == 2).sum()), frontier=int((gt == 3).sum()),
            ms=s.elapsed_time(e), wall_ms=wall,
            gate_sync_ms=float(out.gate_sync_ms),
            origin=[int(v) for v in mapper._origin],
            type_counts=np.bincount(gt.astype(np.int64).ravel(), minlength=4)[:4].tolist(),
            out_sha=output_digest(gt, out.dist_sq, out.coc)))


def edt_mismatch(st, window=None):
    """Voxels of a final state (numpy fields) whose EDT is wrong: every
    valid voxel's dist_sq must be its squared distance to its stored coc;
    where the coc lies in the canvas it must equal scipy's exact EDT over
    the canvas's sites; where it lies outside (a site that scrolled out,
    kept by the limited-observation memory) it must be strictly nearer than
    any canvas site.  `window` (a tuple of slices) limits the two scipy
    clauses to the last frame's window: with fast_mode on, the merge
    updates no voxel outside it, so those keep the distances of earlier
    frames' sites.  Returns (mismatching voxels, voxels kept from
    outside)."""
    import numpy as np
    from scipy import ndimage

    occ = st["vox_type"] == 2
    require(occ.any(), "edt", "the final canvas holds no site")
    sq = np.rint(ndimage.distance_transform_edt(~occ) ** 2).astype(np.int64)
    chk = (st["vox_type"] != 0) & (st["dist_sq"] != 999_999)
    coc = st["coc"].astype(np.int64)
    cs = np.asarray(occ.shape)
    inside = np.all((coc >= 0) & (coc < cs), axis=-1)
    g = np.stack(np.meshgrid(*[np.arange(n) for n in cs], indexing="ij"), -1)
    d = st["dist_sq"].astype(np.int64)
    exact = chk.copy()
    if window is not None:
        exact[:] = False
        exact[window] = chk[window]
    bad = (chk & (((g - coc) ** 2).sum(-1) != d)) \
        | (exact & inside & (d != sq)) | (exact & ~inside & (d >= sq))
    return int(bad.sum()), int((exact & ~inside).sum())


def all_wrappers():
    """{name: wrapper} of every kernel of the port (each keeps a launch
    count)."""
    from gie_mapping_tpu_torch.bench.parts import kernel_wrappers

    return kernel_wrappers()


def phase_slice(dev):
    import numpy as np

    from gie_mapping_tpu_torch.map_state import state_digest, state_to_numpy
    from gie_mapping_tpu_torch.ops.kernels import carve as kc
    from gie_mapping_tpu_torch.ops.kernels import envelope as ke
    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp
    from gie_mapping_tpu_torch.runtime.datasets import (COW_SLICE_RAYS,
                                                        cow_lady_slice)
    from gie_mapping_tpu_torch.utils import geometry as geo

    ph = "slice"
    ref = np.load(REF)
    _, world, poses = cow_lady_slice()
    frames = [world.pointcloud(geo.Projection.from_pose(*p),
                               n_rays=COW_SLICE_RAYS, max_range=8.0, seed=i)
              for i, p in enumerate(poses)]
    wrappers = {"phase1": kp.phase1_packed, "envelope_packed": ke.envelope_packed,
                "envelope_mid": ke.envelope_mid, "panorama": kc.panorama,
                "carve": kc.carve}
    mapper, recs = run_slice(dev, frames, poses, wrappers.values())
    launches = {k: w.launches for k, w in wrappers.items()}
    for r in recs:
        emit({"phase": ph, **{k: (round(v, 4) if isinstance(v, float) else v)
                             for k, v in r.items() if k != "out_sha"}})
    require(all(v > 0 for v in launches.values()), ph,
            f"a kernel of the path never launched: {launches}")

    # final canvas EDT against scipy on observed voxels with a valid pair
    st = state_to_numpy(mapper.state)
    edt_bad, _ = edt_mismatch(st)
    require(edt_bad == 0, ph, f"canvas dist_sq differs from scipy at {edt_bad} voxels")

    # agreement with the JAX package's results on the same slice
    origins_ok = all(r["origin"] == ref["origin"][i].tolist()
                     for i, r in enumerate(recs))
    tdiff = max(int(np.abs(np.asarray(r["type_counts"]) - ref["type_counts"][i]).max())
                for i, r in enumerate(recs))
    out_match = sum(r["out_sha"] == str(ref["out_sha"][i]) for i, r in enumerate(recs))
    gates_match = [r["gate_level"] for r in recs] == ref["gate_level"].tolist()
    sha_ok = state_digest(st) == str(ref["state_sha"])
    emit({"phase": ph, "ok": True, "launches": launches, "scipy_mismatch": edt_bad,
          "origins_match": origins_ok, "type_count_max_diff": tdiff,
          "gate_levels_match": gates_match, "frames_bitwise": out_match,
          "state_sha_match": sha_ok,
          "ms_per_frame_mean_after_first": round(float(np.mean([r["ms"] for r in recs[1:]])), 4)})
    require(origins_ok, ph, "canvas origins differ from the JAX reference")
    require(tdiff == 0, ph, f"voxel type counts differ from the JAX reference by {tdiff}")
    require(out_match == len(recs), ph,
            f"only {out_match} of {len(recs)} frames match the JAX reference")
    require(sha_ok, ph, "final state differs from the JAX reference")
    return launches, frames, poses


def run_scroll(dev, cfg, frames, poses, wrappers=(), loop_ctx=None, mesh=None):
    """Drive the scroll path through VolumetricMapper.process_pointcloud (on
    `dev`, or over `mesh`);
    the launch counters of `wrappers` are zeroed right before the first
    frame and `loop_ctx` wraps the frame loop alone.  Returns (mapper,
    per-frame records, the warnings caught)."""
    import warnings

    import numpy as np
    import torch

    from gie_mapping_tpu_torch.map_state import np_scroll_counts, output_digest
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.parallel.mesh import to_numpy
    from gie_mapping_tpu_torch.utils import geometry as geo

    mapper = VolumetricMapper(cfg, device=None if mesh else dev, mesh=mesh)
    mapper.warmup(robot_pos=poses[0][0])
    staged = [mapper.stage_pointcloud(p) for p in frames]
    torch.cuda.synchronize()
    # host time of the mirror ingest (pure Python; the device idles through it)
    flush, ingest_ms = mapper.flush_stream, [0.0]

    def timed_flush():
        t = time.perf_counter()
        n = flush()
        ingest_ms[0] += (time.perf_counter() - t) * 1e3
        return n

    mapper.flush_stream = timed_flush
    recs = []
    for w in wrappers:
        w.launches = 0
    with warnings.catch_warnings(record=True) as caught, \
            (loop_ctx or contextlib.nullcontext()):
        warnings.simplefilter("always")
        for i, ((pos, quat), (pts, val)) in enumerate(zip(poses, staged)):
            before = None if mapper._origin is None else mapper._origin.copy()
            present = mapper.state.present.cpu().numpy()
            ingested = mapper.stream_ingested
            ingest_ms[0] = 0.0
            proj = geo.Projection.from_pose(pos, quat)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            out = mapper.process_pointcloud(proj, pts, val)
            e.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            scrolled = before is None or not np.array_equal(before, mapper._origin)
            n_arch = int(mapper.state.n_arch)
            old = np.zeros(3, np.int64) if before is None else before
            ex, en = (np_scroll_counts(present, mapper._origin - old,
                                       to_numpy(mapper.state.arch_keys)[:n_arch],
                                       n_arch, mapper._origin)
                      if scrolled else (0, 0))
            gt = out.glb_type
            recs.append(dict(
                frame=i, origin=[int(v) for v in mapper._origin], scrolled=bool(scrolled),
                exits=ex, enters=en, n_arch=n_arch,
                ingested=mapper.stream_ingested - ingested,
                leftover=int(mapper._stream_pending[0][4]),
                gate_level=int(out.gate_level), ms=s.elapsed_time(e), wall_ms=wall,
                ingest_ms=ingest_ms[0],
                out_sha=output_digest(gt, out.dist_sq, out.coc)))
        mapper.flush_stream()
        mapper.check_capacity()
    return mapper, recs, caught


def scroll_inputs():
    """(config, clouds, poses) of the scroll path."""
    from gie_mapping_tpu_torch.runtime.datasets import (COW_SLICE_RAYS,
                                                        cow_lady_scroll)
    from gie_mapping_tpu_torch.utils import geometry as geo
    from gie_mapping_tpu_torch.utils.config import cow_lady_config

    overrides, world, poses = cow_lady_scroll()
    frames = [world.pointcloud(geo.Projection.from_pose(*p), n_rays=COW_SLICE_RAYS,
                               max_range=8.0, seed=i) for i, p in enumerate(poses)]
    return cow_lady_config(**overrides), frames, poses


@contextlib.contextmanager
def logged_gathers(ks):
    """Append the row count K of every archive gather that map_state's
    scroll launches to `ks` (the kernel's own launch count is untouched)."""
    from gie_mapping_tpu_torch import map_state as ms

    orig = ms.gather_archive_rows

    def logged(a_packed, ids):
        ks.append(int(ids.shape[0]))
        return orig(a_packed, ids)

    ms.gather_archive_rows = logged
    try:
        yield
    finally:
        ms.gather_archive_rows = orig


def phase_scroll(dev, wrappers):
    """The cow_lady preset at its own defaults (streaming on) over the
    scroll trajectory; returns the launch counts of its run."""
    import numpy as np
    import torch

    from gie_mapping_tpu_torch.map_state import state_digest, state_to_numpy
    from gie_mapping_tpu_torch.models.mapper import CapacityWarning

    ph = "scroll"
    ref = np.load(REF_SCROLL)
    cfg, frames, poses = scroll_inputs()
    require(cfg.display_glb_edt and cfg.display_glb_ogm, ph, "streaming is off")
    gather_k = []
    mapper, recs, caught = run_scroll(dev, cfg, frames, poses, wrappers.values(),
                                      loop_ctx=logged_gathers(gather_k))
    launches = {k: w.launches for k, w in wrappers.items()}
    cap_warn = [str(w.message) for w in caught if issubclass(w.category, CapacityWarning)]
    for r in recs:
        emit({"phase": ph, **{k: (round(v, 4) if isinstance(v, float) else v)
                             for k, v in r.items() if k != "out_sha"}})

    # the per-tick streaming copy: extraction of 64 columns + copy to the host
    from gie_mapping_tpu_torch.map_state import stream_extract

    cb = cfg.canvas_blocks
    k_cols = mapper._stream_k_cols
    changed = torch.ones(cb, dtype=torch.bool, device=dev)
    carry = torch.zeros(cb, dtype=torch.bool, device=dev)
    host = torch.empty((k_cols * cb[2], 512, 3), dtype=torch.int32, pin_memory=True)

    def tick():
        rows = stream_extract(mapper.state, changed, carry, 0, cfg=cfg,
                              k_cols=k_cols)[2]
        host.copy_(rows, non_blocking=True)

    saved = dict(launches)
    stream_tick_ms = cuda_ms(tick, 20)
    for k, w in wrappers.items():
        w.launches = saved[k]

    st = state_to_numpy(mapper.state)
    edt_bad, kept = edt_mismatch(st)
    origins_ok = [r["origin"] for r in recs] == ref["origin"].tolist()
    out_match = sum(r["out_sha"] == str(ref["out_sha"][i]) for i, r in enumerate(recs))
    traffic_ok = ([r["exits"] for r in recs] == ref["exits"].tolist()
                  and [r["enters"] for r in recs] == ref["enters"].tolist()
                  and [r["n_arch"] for r in recs] == ref["n_arch"].tolist())
    sha_ok = state_digest(st) == str(ref["state_sha"])
    mirror_ok = mapper.mirror.digest() == str(ref["mirror_sha"])
    scroll_ms = [r["ms"] for r in recs[1:] if r["scrolled"]]
    other_ms = [r["ms"] for r in recs[1:] if not r["scrolled"]]
    emit({"phase": ph, "ok": True, "launches": launches, "scipy_mismatch": edt_bad,
          "kept_outside_canvas": kept,
          "origins_match": origins_ok, "frames_bitwise": out_match,
          "frames": len(recs), "traffic_match": traffic_ok,
          "state_sha_match": sha_ok, "mirror_sha_match": mirror_ok,
          "mirror_blocks": len(mapper.mirror), "capacity": mapper.capacity_report(),
          "capacity_warnings": cap_warn,
          "ms_scroll_frames_mean": round(float(np.mean(scroll_ms)), 4),
          "ms_other_frames_mean": round(float(np.mean(other_ms)), 4),
          "n_scroll_frames": len(scroll_ms), "n_other_frames": len(other_ms),
          "host_ingest_ms_mean": round(float(np.mean([r["ingest_ms"] for r in recs[1:]])), 4),
          "gather_archive_rows_K": gather_k,
          "stream_tick_ms": round(stream_tick_ms, 4)})
    # every kernel but the generic envelope, which only the 2-D map runs
    require(all(v > 0 for k, v in launches.items() if k != "envelope"), ph,
            f"a kernel of the path never launched: {launches}")
    require(not cap_warn, ph, f"CapacityWarning fired: {cap_warn}")
    require(edt_bad == 0, ph, f"canvas dist_sq differs from scipy at {edt_bad} voxels")
    require(origins_ok, ph, "canvas origins differ from the JAX reference")
    require(traffic_ok, ph, "scroll traffic (exits, enters, n_arch) differs "
            "from the JAX reference")
    require(out_match == len(recs), ph,
            f"only {out_match} of {len(recs)} frames match the JAX reference")
    require(sha_ok, ph, "final state differs from the JAX reference")
    require(mirror_ok, ph, "host mirror differs from the JAX reference")
    return launches


def scan_inputs(flat):
    """(config, ranges per pose, poses) of a 2-D LiDAR path: the scan2D
    preset at its own defaults over datasets.scan2d_path, or (flat) its
    true 2-D map on the relax engine over datasets.scan2d_flat_path."""
    from gie_mapping_tpu_torch.runtime import datasets as ds
    from gie_mapping_tpu_torch.utils.config import scan2d_config

    world = ds.scan2d_world()
    cfg = scan2d_config(**(FLAT if flat else {}))
    poses = ds.scan2d_flat_path() if flat else ds.scan2d_path()
    return cfg, [ds.hokuyo_scan(world, p) for p in poses], poses


def run_scan(dev, cfg, scans, poses, wrappers=(), loop_ctx=None):
    """Drive a 2-D LiDAR path through VolumetricMapper.process_scan2d; the
    launch counters of `wrappers` are zeroed right before the first frame
    and `loop_ctx` wraps the frame loop alone.  Returns (mapper, per-frame
    records, the warnings caught)."""
    import warnings

    import numpy as np
    import torch

    from gie_mapping_tpu_torch.map_state import output_digest
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.utils import geometry as geo

    mapper = VolumetricMapper(cfg, device=dev)
    mapper.warmup(robot_pos=poses[0][0])
    staged = [torch.from_numpy(r).to(dev) for r, _, _ in scans]
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    recs = []
    with warnings.catch_warnings(record=True) as caught, \
            (loop_ctx or contextlib.nullcontext()):
        warnings.simplefilter("always")
        for i, (pose, ranges, (_, tmin, tinc)) in enumerate(zip(poses, staged, scans)):
            before = None if mapper._origin is None else mapper._origin.copy()
            proj = geo.Projection.from_pose(*pose)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            out = mapper.process_scan2d(proj, ranges, tmin, tinc)
            e.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            gt = out.glb_type
            recs.append(dict(
                frame=i, origin=[int(v) for v in mapper._origin],
                scrolled=before is None or not np.array_equal(before, mapper._origin),
                gate_level=int(out.gate_level), relax_iters=int(out.relax_iters),
                occupied=int((gt == 2).sum()), ms=s.elapsed_time(e), wall_ms=wall,
                out_sha=output_digest(gt, out.dist_sq, out.coc)))
        mapper.check_capacity()
    return mapper, recs, caught


def coc_mismatch(st):
    """Valid voxels of a final state whose dist_sq is not the squared
    distance to their stored coc."""
    import numpy as np

    chk = (st["vox_type"] != 0) & (st["dist_sq"] != 999_999)
    cs = st["vox_type"].shape
    g = np.stack(np.meshgrid(*[np.arange(n) for n in cs], indexing="ij"), -1)
    d2 = ((g - st["coc"].astype(np.int64)) ** 2).sum(-1)
    return int((chk & (d2 != st["dist_sq"])).sum())


def phase_scan(dev, wrappers, flat):
    """A 2-D LiDAR path (`scan2d`, or `scan2d_flat` with `flat`) against its
    JAX fixture; returns the launch counts of its run."""
    import numpy as np

    from gie_mapping_tpu_torch.map_state import state_digest, state_to_numpy
    from gie_mapping_tpu_torch.models.mapper import CapacityWarning

    ph = "scan2d_flat" if flat else "scan2d"
    ref = np.load(REF_FLAT if flat else REF_SCAN2D)
    cfg, scans, poses = scan_inputs(flat)
    gather_k = []
    mapper, recs, caught = run_scan(dev, cfg, scans, poses, wrappers.values(),
                                    loop_ctx=logged_gathers(gather_k))
    launches = {k: w.launches for k, w in wrappers.items()}
    cap_warn = [str(w.message) for w in caught if issubclass(w.category, CapacityWarning)]
    for r in recs:
        emit({"phase": ph, **{k: (round(v, 4) if isinstance(v, float) else v)
                             for k, v in r.items() if k != "out_sha"}})
    st = state_to_numpy(mapper.state)
    if flat:
        # the relax engine is not an exact Voronoi: hold it to its coc
        edt_bad, kept = coc_mismatch(st), None
    else:
        edt_bad, kept = edt_mismatch(st, _window_slices(mapper, cfg))
    col = lambda k: [r[k] for r in recs]
    origins_ok = col("origin") == ref["origin"].tolist()
    steps_ok = (col("scrolled") == ref["scrolled"].tolist()
                and col("gate_level") == ref["gate_level"].tolist()
                and col("relax_iters") == ref["relax_iters"].tolist())
    out_match = sum(r["out_sha"] == str(ref["out_sha"][i]) for i, r in enumerate(recs))
    sha_ok = state_digest(st) == str(ref["state_sha"])
    scroll_ms = [r["ms"] for r in recs[1:] if r["scrolled"]]
    other_ms = [r["ms"] for r in recs[1:] if not r["scrolled"]]
    emit({"phase": ph, "ok": True, "launches": launches,
          "edt_mismatch": edt_bad, "kept_outside_canvas": kept,
          "origins_match": origins_ok, "scroll_gate_relax_match": steps_ok,
          "frames_bitwise": out_match, "frames": len(recs),
          "state_sha_match": sha_ok, "capacity": mapper.capacity_report(),
          "capacity_warnings": cap_warn, "gather_archive_rows_K": gather_k,
          "ms_per_frame_mean_after_first": round(float(np.mean(col("ms")[1:])), 4),
          "ms_scroll_frames_mean": round(float(np.mean(scroll_ms)), 4),
          "ms_other_frames_mean": round(float(np.mean(other_ms)), 4),
          "n_scroll_frames": len(scroll_ms), "n_other_frames": len(other_ms)})
    need = (("envelope", "phase1") if flat
            else ("phase1", "envelope_packed", "envelope_mid")) + SCROLL_KERNELS
    require(all(launches[k] > 0 for k in need), ph,
            f"a kernel of the path never launched: {launches}")
    require(not cap_warn, ph, f"CapacityWarning fired: {cap_warn}")
    require(edt_bad == 0, ph, f"canvas dist_sq is wrong at {edt_bad} voxels")
    require(origins_ok, ph, "canvas origins differ from the JAX reference")
    require(steps_ok, ph, "scrolls, gate levels or relax sweeps differ from "
            "the JAX reference")
    require(out_match == len(recs), ph,
            f"only {out_match} of {len(recs)} frames match the JAX reference")
    require(sha_ok, ph, "final state differs from the JAX reference")
    return launches


def shard_bytes(state) -> dict:
    """Bytes of a MapState by shard: each sharded field's part i counts
    for shard i; the replicated fields lie on home (shard 0's device)."""
    from gie_mapping_tpu_torch.parallel.mesh import Sharded

    per, home = {}, 0
    for f in state.__dataclass_fields__:
        v = getattr(state, f)
        if isinstance(v, Sharded):
            for i, p in enumerate(v.parts):
                per[i] = per.get(i, 0) + p.numel() * p.element_size()
        else:
            home += v.numel() * v.element_size()
    return {"sharded_bytes_per_shard": [per[i] for i in sorted(per)],
            "replicated_bytes_on_home": home}


def parent_mesh_slice(parent, dev, frames, poses, n):
    """The parent commit's mesh (the state whole on the mesh's first
    device, only the EDT sharded) over the slice: ms per frame, or None
    without the parent's copy."""
    import importlib

    import numpy as np
    import torch

    if parent is None:
        return None
    name = parent.__name__
    pm = importlib.import_module(name + ".models.mapper")
    pmesh = importlib.import_module(name + ".parallel.mesh")
    pcfg = importlib.import_module(name + ".utils.config")
    pgeo = importlib.import_module(name + ".utils.geometry")
    pds = importlib.import_module(name + ".runtime.datasets")
    overrides, _, _ = pds.cow_lady_slice()
    m = pm.VolumetricMapper(pcfg.cow_lady_config(**overrides),
                            mesh=pmesh.make_mesh(devices=[dev] * n))
    m.warmup(robot_pos=poses[0][0])
    staged = [m.stage_pointcloud(p) for p in frames]
    ms = []
    for (pos, quat), (pts, val) in zip(poses, staged):
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        m.process_pointcloud(pgeo.Projection.from_pose(pos, quat), pts, val)
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return float(np.mean(ms[1:]))


def phase_mesh(dev, wrappers, smi, frames, poses, parent):
    """The map state sharded between frames (parallel/mesh.py) on this card:
    the cow-lady slice over [dev] * 2 and [dev] * 4, bench.py's replay and
    the scroll path (streaming, the archive, teleports) over [dev] * 4,
    through VolumetricMapper(cfg, mesh=...), against the JAX package's
    4-device mesh run (tests/fixtures/torch_port_mesh_ref.npz; the JAX mesh
    results do not depend on its size) and the port's single-device run of
    the same frames in this process; with two or more cards the slice again
    over distinct cards.  Prints each run's ms per frame (and the parent's
    state-on-home mesh where its copy is present), each shard's bytes and
    the card's nvidia-smi line.  Returns the launch counts of the mesh runs."""
    import numpy as np
    import torch

    from gie_mapping_tpu_torch.map_state import (output_digest, state_digest,
                                                 state_to_numpy)
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.parallel import multihost_demo as demo
    from gie_mapping_tpu_torch.parallel.mesh import Sharded, make_mesh

    ph = "mesh"
    ref = np.load(REF_MESH)
    n = int(ref["devices"])
    launches = dict.fromkeys(wrappers, 0)
    keep = VolumetricMapper.CHECKPOINT_FIELDS

    def same_fields(a, b):
        sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
        return [k for k in keep if not np.array_equal(sa[k], sb[k])]

    def add(got):
        for k, v in got.items():
            launches[k] += v

    def sharded_canvas(m, size):
        parts = [getattr(m.state, f) for f in ("occ_val", "vox_type", "dist_sq", "coc")]
        return all(isinstance(v, Sharded) and len(v.parts) == size
                   and v.parts[0].shape[0] == m.cfg.canvas_size[0] // size
                   for v in parts)

    # -- the slice over 2 and 4 shards -------------------------------------------
    om, orecs = run_slice(dev, frames, poses)
    ms = lambda recs: float(np.mean([r["ms"] for r in recs[1:]]))
    for size in MESH_PATH_SIZES:
        mesh = make_mesh(devices=[dev] * size)
        sm, srecs = run_slice(dev, frames, poses, wrappers.values(), mesh=mesh)
        got_s = {k: w.launches for k, w in wrappers.items()}
        bad = [k for k in ("out_sha", "gate_level", "origin")
               if [r[k] for r in srecs] != ref[f"slice_{k}"].tolist()]
        if state_digest(state_to_numpy(sm.state)) != str(ref["slice_state_sha"]):
            bad.append("state_sha")
        one_bad = same_fields(sm, om)
        if [r["out_sha"] for r in srecs] != [r["out_sha"] for r in orecs]:
            one_bad.append("out_sha")
        emit({"phase": ph, "part": "slice", "shards": size,
              "devices": [str(d) for d in mesh.devices],
              "launches": got_s, "fixture_mismatch": bad,
              "one_device_mismatch": one_bad,
              "gate_levels": [r["gate_level"] for r in srecs],
              "mesh_ms_per_frame": ms(srecs), "one_device_ms_per_frame": ms(orecs),
              "parent_state_on_home_ms_per_frame":
                  parent_mesh_slice(parent, dev, frames, poses, size),
              "collective_us": demo.collective_us(mesh, sm.state, sm.cfg),
              **shard_bytes(sm.state), "one_device_bytes": shard_bytes(om.state),
              "nvidia_smi": smi})
        require(sharded_canvas(sm, size), ph, "the canvas is not x-sharded")
        require(not bad, ph, f"the mesh slice differs from the JAX mesh run in {bad}")
        require(not one_bad, ph, f"the mesh slice differs from one device in {one_bad}")
        require(all(got_s[k] > 0 for k in ("phase1", "envelope_packed", "envelope",
                                          "panorama", "carve"))
                and got_s["envelope_mid"] == 0, ph,
                f"the mesh slice must run the sharded EDT's kernels: {got_s}")
        add(got_s)
    mesh = make_mesh(devices=[dev] * n)

    # -- bench.py's replay -------------------------------------------------------
    cfg, bposes, clouds, n_online, chunk = bench_inputs()
    nb = len(bposes) - n_online

    def bench(m, runs):
        pts, val = m.stage_pointcloud_batch(clouds)
        sha, levels = [], []
        for i in range(n_online):
            o = m.process_pointcloud(bposes[i], pts[i], val[i])
            sha.append(output_digest(o.glb_type, o.dist_sq, o.coc))
            levels.append(int(o.gate_level))
        with recorded_runs(runs):
            out, t, _ = timed(lambda: m.process_pointcloud_batch(
                bposes[n_online:], pts[n_online:], val[n_online:], chunk=chunk))
        return sha, levels, out.fetch(), t / nb

    mm, mruns = VolumetricMapper(cfg, mesh=mesh), []
    (sha, levels, out, ms_m), got_b = _counted(wrappers, lambda: bench(mm, mruns))
    rec, _ = replay_end(mm, out, mruns)
    bad = [k for k, v in rec.items()
           if not np.array_equal(np.asarray(v), ref[f"bench_{k}"])]
    bad += [k for k, v in (("online_out_sha", sha), ("online_gate_level", levels))
            if v != ref[f"bench_{k}"].tolist()]
    m1, oruns = VolumetricMapper(cfg, device=dev), []
    osha, _, oout, ms_1 = bench(m1, oruns)
    one_bad = same_fields(mm, m1)
    if osha != sha or output_digest(oout.glb_type, oout.dist_sq, oout.coc) \
            != rec["out_sha"]:
        one_bad.append("out_sha")
    emit({"phase": ph, "part": "bench", "shards": n, "frames": nb, "chunk": chunk,
          "launches": got_b, "fixture_mismatch": bad, "one_device_mismatch": one_bad,
          "gate_levels": rec["pf_gate_level"].tolist(),
          "scanned_frames": rec["scanned_frames"],
          "scanned_scrolls": rec["scanned_scrolls"],
          "mesh_replay_ms_per_frame": ms_m, "one_device_replay_ms_per_frame": ms_1,
          **shard_bytes(mm.state), "nvidia_smi": smi})
    require(sharded_canvas(mm, n), ph, "the replay's canvas is not x-sharded")
    require(not bad, ph, f"the mesh replay differs from the JAX mesh run in {bad}")
    require(not one_bad, ph, f"the mesh replay differs from one device in {one_bad}")
    require(all(got_b[k] > 0 for k in ("phase1", "envelope_packed", "envelope",
                                      "panorama", "carve", "shift_canvas"))
            and got_b["envelope_mid"] == 0, ph,
            f"the mesh replay must run the sharded EDT's kernels: {got_b}")
    add(got_b)

    # -- the scroll path: streaming, the archive, teleports --------------------------
    scfg, sframes, sposes = scroll_inputs()
    sc, screcs, caught = run_scroll(dev, scfg, sframes, sposes, wrappers.values(),
                                    mesh=mesh)
    got_c = {k: w.launches for k, w in wrappers.items()}
    one_sc, one_recs, _ = run_scroll(dev, scfg, sframes, sposes)
    bad = [k for k in ("origin", "gate_level", "out_sha", "exits", "enters",
                       "n_arch", "leftover")
           if [r[k] for r in screcs] != ref[f"scroll_{k}"].tolist()]
    if state_digest(state_to_numpy(sc.state)) != str(ref["scroll_state_sha"]):
        bad.append("state_sha")
    if sc.mirror.digest() != str(ref["scroll_mirror_sha"]):
        bad.append("mirror_sha")
    one_bad = same_fields(sc, one_sc)
    if [r["out_sha"] for r in screcs] != [r["out_sha"] for r in one_recs]:
        one_bad.append("out_sha")
    if sc.mirror.digest() != one_sc.mirror.digest():
        one_bad.append("mirror_sha")
    emit({"phase": ph, "part": "scroll", "shards": n, "frames": len(screcs),
          "scrolls": sum(r["scrolled"] for r in screcs[1:]),
          "launches": got_c, "fixture_mismatch": bad, "one_device_mismatch": one_bad,
          "mesh_ms_per_frame": ms(screcs), "one_device_ms_per_frame": ms(one_recs),
          "mirror_blocks": len(sc.mirror), "capacity": sc.capacity_report(),
          **shard_bytes(sc.state), "nvidia_smi": smi})
    require(sharded_canvas(sc, n), ph, "the scroll path's canvas is not x-sharded")
    require(not bad, ph, f"the mesh scroll path differs from the JAX mesh run in {bad}")
    require(not one_bad, ph,
            f"the mesh scroll path differs from one device in {one_bad}")
    require(all(got_c[k] > 0 for k in SCROLL_KERNELS), ph,
            f"the mesh scroll path must run the scroll kernels: {got_c}")
    add(got_c)

    # -- distinct cards ------------------------------------------------------------
    cards = torch.cuda.device_count()
    nd = next((k for k in MESH_SIZES[::-1] if k <= cards), 0)
    if nd < 2:
        emit({"phase": ph, "part": "distinct_cards",
              "not_run": f"{cards} CUDA device: a mesh of distinct cards needs two"})
    else:
        dm, drecs = run_slice(dev, frames, poses, mesh=make_mesh(nd))
        dbad = [k for k in ("out_sha", "gate_level")
                if [r[k] for r in drecs] != ref[f"slice_{k}"].tolist()]
        if state_digest(state_to_numpy(dm.state)) != str(ref["slice_state_sha"]):
            dbad.append("state_sha")
        emit({"phase": ph, "part": "distinct_cards", "devices": nd,
              "fixture_mismatch": dbad, "mesh_ms_per_frame": ms(drecs),
              **shard_bytes(dm.state)})
        require(not dbad, ph, f"the slice over {nd} cards differs in {dbad}")
    emit({"phase": ph, "ok": True, "launches": launches})
    return launches


def phase_multiproc(dev, smi):
    """The multi-process mesh: one NCCL process per card
    (parallel/multihost_demo.py --slice, from torchrun's environment), the
    cow-lady slice at the preset's width, against the single-device run
    and the one-process run over the same shards (both in this process).
    With one card: a world of one process driving two shards on the card
    (every collective still goes through NCCL); with two or more: two
    processes, one card each.  Returns the launch counts of the NCCL ranks'
    frames."""
    import socket
    import tempfile

    import numpy as np
    import torch

    from gie_mapping_tpu_torch.parallel import multihost_demo as demo
    from gie_mapping_tpu_torch.parallel.mesh import make_mesh

    ph = "multiproc"
    require(torch.distributed.is_nccl_available(), ph, "NCCL is not available")
    cards = torch.cuda.device_count()
    world, per = (2, 1) if cards >= 2 else (1, 2)
    if world == 1:
        emit({"phase": ph, "part": "distinct_cards",
              "not_run": f"{cards} CUDA device: the two-process run over two "
                         "cards waits for a machine with two"})
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multiproc_")
    out = os.path.join(tmp, "group.npz")
    argv = [sys.executable, "-u", "-m", "gie_mapping_tpu_torch.parallel.multihost_demo",
            "--slice", "--frames", str(MULTIPROC_FRAMES),
            "--devices-per-proc", str(per), "--out", out]
    if world == 1:
        argv.append("--share-card")
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    t0 = time.time()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.time() - t0
    require(all(p.returncode == 0 for p in procs), ph,
            f"a rank failed: {[l[-2000:] for l in logs]}")
    got = dict(np.load(out))
    one = demo.run_slice(MULTIPROC_FRAMES, None, dev)
    shards = ([dev] * per if world == 1
              else [torch.device("cuda", i) for i in range(world)])
    ctl = demo.run_slice(MULTIPROC_FRAMES, make_mesh(devices=shards), None)
    same = lambda a, b, keys: [k for k in keys
                               if not np.array_equal(a[f"slice/{k}"], b[f"slice/{k}"])]
    ctl_bad = same(got, ctl, ("out_sha", "gate_level", "state_sha"))
    one_bad = same(got, one, ("out_sha", "ckpt_sha"))
    launch = {k.split("/")[-1]: int(v) for k, v in got.items()
              if k.startswith("slice/launches/")}
    coll = lambda r: {k.split("/")[-1]: round(float(v), 3) for k, v in r.items()
                      if k.startswith("slice/collective_us/")}
    ms = lambda r: float(np.mean(r["slice/ms"][1:]))
    emit({"phase": ph, "world": world, "devices_per_rank": per,
          "shards": world * per, "frames": MULTIPROC_FRAMES,
          "launches_rank0": launch, "controller_mismatch": ctl_bad,
          "one_device_mismatch": one_bad,
          "nccl_ms_per_frame": ms(got), "controller_ms_per_frame": ms(ctl),
          "one_device_ms_per_frame": ms(one), "wall_s": round(wall, 3),
          "nccl_collective_us": coll(got), "controller_collective_us": coll(ctl),
          "nvidia_smi": smi})
    require(not ctl_bad, ph, f"the NCCL run differs from one process over the "
            f"same shards in {ctl_bad}")
    require(not one_bad, ph, f"the NCCL run differs from one device in {one_bad}")
    require(all(launch[k] > 0 for k in ("phase1", "envelope_packed", "envelope",
                                       "panorama", "carve"))
            and launch["envelope_mid"] == 0, ph,
            f"the NCCL ranks must run the sharded EDT's kernels: {launch}")
    emit({"phase": ph, "ok": True})
    return launch


def timed(fn):
    """(fn(), CUDA-event ms, host wall ms) of one call, from an idle card."""
    import torch

    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    r = fn()
    e.record()
    torch.cuda.synchronize()
    return r, s.elapsed_time(e), (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def recorded_runs(runs):
    """Append the per_frame scalars (numpy) of every run that the mapper
    dispatches through pipeline.replay_frames to `runs`."""
    from gie_mapping_tpu_torch.models import mapper as mm

    orig = mm.replay_frames

    def recorded(*args, **kw):
        res = orig(*args, **kw)
        runs.append({k: v.cpu().numpy() for k, v in res[3].items()})
        return res

    mm.replay_frames = recorded
    try:
        yield
    finally:
        mm.replay_frames = orig


def replay_end(mapper, out, runs):
    """A replay's end as the fixture records it
    (make_torch_port_ref._last): state, last outputs, payload8, counters and
    every run's per_frame.  Returns (record, state as numpy)."""
    import hashlib

    import numpy as np

    from gie_mapping_tpu_torch.map_state import (output_digest, state_digest,
                                                 state_to_numpy)

    st = state_to_numpy(mapper.state)
    msg = out.cost_map_msg(mapper.cfg.voxel_width)
    rec = {
        "state_sha": state_digest(st),
        "out_sha": output_digest(out.glb_type, out.dist_sq, out.coc),
        "payload8_sha": hashlib.sha256(msg["payload8"]).hexdigest(),
        "map_ct": mapper.map_ct, "origin": np.asarray(mapper._origin, np.int32),
        "scanned_frames": mapper.replay_scanned_frames,
        "scanned_scrolls": mapper.replay_scanned_scrolls,
        "run_lengths": [len(r["gate_level"]) for r in runs]}
    for k in runs[0]:
        rec["pf_" + k] = np.concatenate([r[k] for r in runs])
    return rec, st


def bench_inputs():
    """(config, poses, clouds, n_online, chunk) of bench.py's replay
    (datasets.cow_lady_bench)."""
    from gie_mapping_tpu_torch.runtime.datasets import (COW_SLICE_RAYS,
                                                        cow_lady_bench)
    from gie_mapping_tpu_torch.utils.config import cow_lady_config

    overrides, world, poses, n_online, chunk = cow_lady_bench()
    clouds = [world.pointcloud(p, n_rays=COW_SLICE_RAYS, max_range=8.0, seed=i)
              for i, p in enumerate(poses)]
    return cow_lady_config(**overrides), poses, clouds, n_online, chunk


def run_bench(dev, inputs, replay, loop_ctx=None):
    """bench.py's frames on a fresh mapper: the first n_online through
    process_pointcloud, then the rest through one process_pointcloud_batch
    call (`replay`) or through process_pointcloud, inside `loop_ctx`.
    Returns a record per frame of the rest (wall_ms; a replay's wall time
    split evenly)."""
    import torch

    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    cfg, poses, clouds, n_online, chunk = inputs
    m = VolumetricMapper(cfg, device=dev)
    pts, val = m.stage_pointcloud_batch(clouds)
    for i in range(n_online):
        m.process_pointcloud(poses[i], pts[i], val[i])
    torch.cuda.synchronize()
    n = len(poses) - n_online
    with loop_ctx or contextlib.nullcontext():
        t0 = time.perf_counter()
        if replay:
            m.process_pointcloud_batch(poses[n_online:], pts[n_online:],
                                       val[n_online:], chunk=chunk)
        else:
            for i in range(n_online, len(poses)):
                m.process_pointcloud(poses[i], pts[i], val[i])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return [{"wall_ms": wall / n}] * n


def online_run(dev, cfg, poses, clouds):
    """The same frames through process_pointcloud on a fresh mapper:
    (mapper, last output, CUDA-event ms of each frame)."""
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    m = VolumetricMapper(cfg, device=dev)
    pts, val = m.stage_pointcloud_batch(clouds)
    out, ms = None, []
    for i, p in enumerate(poses):
        out, t, _ = timed(lambda: m.process_pointcloud(p, pts[i], val[i]))
        ms.append(t)
    return m, out, ms


def phase_replay(dev, wrappers):
    """The replay mapper at bench.py's settings and on the scroll path,
    against the JAX fixture and the port's own per-frame runs; returns the
    launch counts of its two runs."""
    import warnings

    import numpy as np

    from gie_mapping_tpu_torch.map_state import (output_digest, state_digest,
                                                 state_to_numpy)
    from gie_mapping_tpu_torch.models.mapper import (CapacityWarning,
                                                     VolumetricMapper)
    from gie_mapping_tpu_torch.runtime.datasets import (COW_SLICE_RAYS,
                                                        cow_lady_scroll)
    from gie_mapping_tpu_torch.utils import geometry as geo
    from gie_mapping_tpu_torch.utils.config import cow_lady_config

    ph = "replay"
    ref = np.load(REF_REPLAY)
    launches = dict.fromkeys(wrappers, 0)

    def counted(run):
        r, got = _counted(wrappers, run)
        for k, v in got.items():
            launches[k] += v
        return r, got

    def check(prefix, rec):
        """The fields of `rec` that differ from the fixture's."""
        return [k for k, v in rec.items()
                if not np.array_equal(np.asarray(v), ref[f"{prefix}_{k}"])]

    # -- bench.py's replay ---------------------------------------------------
    cfg, poses, clouds, n_online, chunk = bench_inputs()
    m = VolumetricMapper(cfg, device=dev)
    pts, val = m.stage_pointcloud_batch(clouds)
    runs = []

    def bench():
        sha = []
        for i in range(n_online):
            o = m.process_pointcloud(poses[i], pts[i], val[i])
            sha.append(output_digest(o.glb_type, o.dist_sq, o.coc))
        with recorded_runs(runs):
            out, ms, wall = timed(lambda: m.process_pointcloud_batch(
                poses[n_online:], pts[n_online:], val[n_online:], chunk=chunk))
        return sha, out.fetch(), ms, wall

    (online_sha, out, ms_b, wall_b), got_b = counted(bench)
    rec, st = replay_end(m, out, runs)
    bad = check("bench", rec)
    online_ok = online_sha == ref["bench_online_out_sha"].tolist()
    edt_bad, kept = edt_mismatch(st)
    n = len(poses) - n_online
    # bench.py's timed pass: the same 40 frames again on the same mapper
    _, ms_b2, wall_b2 = timed(lambda: m.process_pointcloud_batch(
        poses[n_online:], pts[n_online:], val[n_online:], chunk=chunk))
    lm, lo, online_ms = online_run(dev, cfg, poses, clouds)
    loop_ok = (state_digest(state_to_numpy(lm.state)) == rec["state_sha"]
               and output_digest(lo.glb_type, lo.dist_sq, lo.coc) == rec["out_sha"])
    emit({"phase": ph, "part": "bench", "frames": n, "chunk": chunk,
          "launches": got_b, "fixture_mismatch": bad,
          "online_frames_match": online_ok, "frame_loop_match": loop_ok,
          "scipy_mismatch": edt_bad, "kept_outside_canvas": kept,
          "scanned_frames": rec["scanned_frames"],
          "scanned_scrolls": rec["scanned_scrolls"],
          "run_lengths": rec["run_lengths"],
          "gate_levels": rec["pf_gate_level"].tolist(),
          "replay_ms_per_frame": ms_b / n, "replay_wall_ms_per_frame": wall_b / n,
          "replay_again_ms_per_frame": ms_b2 / n,
          "replay_again_wall_ms_per_frame": wall_b2 / n,
          "online_ms_per_frame": float(np.mean(online_ms[n_online:])),
          "online_ms_per_frame_median": float(np.median(online_ms[n_online:]))})
    require(not bad, ph, f"bench replay differs from the JAX reference in {bad}")
    require(online_ok, ph, "bench online frames differ from the JAX reference")
    require(loop_ok, ph, "bench replay differs from the port's per-frame run")
    require(edt_bad == 0, ph, f"canvas dist_sq differs from scipy at {edt_bad} voxels")
    require(rec["scanned_frames"] == n and rec["scanned_scrolls"] > 0, ph,
            "the bench replay must run all its frames in runs with scrolls")
    need = ("phase1", "envelope_packed", "envelope_mid", "panorama", "carve",
            "shift_canvas")
    require(all(got_b[k] > 0 for k in need), ph,
            f"a kernel of the bench replay never launched: {got_b}")

    # -- the scroll path, replayed (streaming on) -----------------------------
    overrides, world, sposes = cow_lady_scroll()
    cfg = cow_lady_config(**overrides, fuse_raycast=True)
    require(cfg.display_glb_edt and cfg.display_glb_ogm, ph, "streaming is off")
    projs = [geo.Projection.from_pose(*p) for p in sposes]
    clouds = [world.pointcloud(p, n_rays=COW_SLICE_RAYS, max_range=8.0, seed=i)
              for i, p in enumerate(projs)]
    m = VolumetricMapper(cfg, device=dev)
    pts, val = m.stage_pointcloud_batch(clouds)
    runs = []

    def scroll():
        with recorded_runs(runs), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, ms, wall = timed(lambda: m.process_pointcloud_batch(
                projs, pts, val, chunk=SCROLL_CHUNK))
            m.flush_stream()
            m.check_capacity()
        return out.fetch(), ms, wall, caught

    (out, ms_s, wall_s, caught), got_s = counted(scroll)
    cap_warn = [str(w.message) for w in caught
                if issubclass(w.category, CapacityWarning)]
    rec, st = replay_end(m, out, runs)
    rec["mirror_sha"] = m.mirror.digest()
    bad = check("scroll", rec)
    lm, lo, online_ms = online_run(dev, cfg, projs, clouds)
    loop_ok = (state_digest(state_to_numpy(lm.state)) == rec["state_sha"]
               and output_digest(lo.glb_type, lo.dist_sq, lo.coc) == rec["out_sha"])
    emit({"phase": ph, "part": "scroll", "frames": len(projs),
          "chunk": SCROLL_CHUNK, "launches": got_s, "fixture_mismatch": bad,
          "frame_loop_match": loop_ok, "capacity": m.capacity_report(),
          "capacity_warnings": cap_warn, "mirror_blocks": len(m.mirror),
          "scanned_frames": rec["scanned_frames"],
          "scanned_scrolls": rec["scanned_scrolls"],
          "run_lengths": rec["run_lengths"],
          "replay_ms_per_frame": ms_s / len(projs),
          "replay_wall_ms_per_frame": wall_s / len(projs),
          "online_ms_per_frame": float(np.mean(online_ms[1:])),
          "online_ms_per_frame_median": float(np.median(online_ms[1:]))})
    require(not bad, ph, f"scroll replay differs from the JAX reference in {bad}")
    require(loop_ok, ph, "scroll replay differs from the port's per-frame run")
    require(not cap_warn, ph, f"CapacityWarning fired: {cap_warn}")
    require(rec["scanned_scrolls"] > 0 and rec["scanned_frames"] < len(projs), ph,
            "the scroll replay must scroll inside runs and fall back around "
            "the teleport")
    require(all(v > 0 for k, v in got_s.items() if k != "envelope"), ph,
            f"a kernel of the scroll replay never launched: {got_s}")
    emit({"phase": ph, "ok": True, "launches": launches})
    return launches


def sensor_inputs(kind):
    """(config, poses, measurements [K, ...], scalars, n_online, chunk) of
    a projection sensor's path (datasets.depthcam_bench or laser3d_bench)."""
    from gie_mapping_tpu_torch.runtime import datasets as ds
    from gie_mapping_tpu_torch.utils import config as tcfg

    if kind == "depth":
        overrides, world, poses, n_online, chunk = ds.depthcam_bench()
        data, sc = ds.depth_frames(world, poses)
        return (tcfg.depthcam_config(**overrides), poses, data, sc, n_online,
                chunk)
    overrides, world, poses, n_online, chunk = ds.laser3d_bench()
    data, sc = ds.ring_frames(world, poses)
    return (tcfg.uav_laser3d_config(**overrides), poses, data, sc, n_online,
            chunk)


def _sensor_calls(m, kind):
    if kind == "depth":
        return m.process_depth, m.process_depth_batch
    return m.process_multiscan, m.process_multiscan_batch


def run_sensor(dev, inputs, kind, replay, loop_ctx=None):
    """A sensor path's frames on a fresh mapper: the first n_online through
    the online call, then the rest through one batch call (`replay`) or one
    by one, inside `loop_ctx`; then the stream is flushed and the capacity
    checked.  Returns (mapper, last output, the online frames' output
    digests, a record per frame of the rest: ms (CUDA events) and wall_ms,
    a replay's times split evenly, and the canvas origin after each frame
    run one by one)."""
    import torch

    from gie_mapping_tpu_torch.map_state import output_digest
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    cfg, poses, data, sc, n_online, chunk = inputs
    m = VolumetricMapper(cfg, device=dev)
    one, batch = _sensor_calls(m, kind)
    dd = torch.from_numpy(data).to(dev)
    head, origins = [], []
    for i in range(n_online):
        o = one(poses[i], dd[i], *sc)
        head.append(output_digest(o.glb_type, o.dist_sq, o.coc))
        origins.append(tuple(int(v) for v in m._origin))
    torch.cuda.synchronize()
    n = len(poses) - n_online
    recs = []
    with loop_ctx or contextlib.nullcontext():
        if replay:
            out, ms, wall = timed(lambda: batch(poses[n_online:], dd[n_online:],
                                                *sc, chunk=chunk))
            recs = [{"ms": ms / n, "wall_ms": wall / n}] * n
        else:
            for i in range(n_online, len(poses)):
                out, ms, wall = timed(lambda: one(poses[i], dd[i], *sc))
                recs.append({"ms": ms, "wall_ms": wall})
                origins.append(tuple(int(v) for v in m._origin))
    if cfg.display_glb_edt or cfg.display_glb_ogm:
        m.flush_stream()
    m.check_capacity()
    return m, out, head, recs, origins


def _counted(wrappers, run):
    """run() with every wrapper's launch count set to 0 just before it;
    returns (its result, {kernel: launches during it})."""
    for w in wrappers.values():
        w.launches = 0
    r = run()
    return r, {k: w.launches for k, w in wrappers.items()}


def _window_slices(mapper, cfg):
    """The last frame's window in canvas coordinates."""
    off = mapper.last_output.pvt - mapper._origin * 8
    return tuple(slice(int(o), int(o) + n) for o, n in zip(off, cfg.local_size))


def phase_sensor(dev, wrappers, kind):
    """A projection sensor's path (`depthcam` or `laser3D`): the replay
    against its JAX fixture and the port's own per-frame run; returns the
    launch counts of the replay."""
    import warnings

    import numpy as np
    import torch

    from gie_mapping_tpu_torch.map_state import (output_digest, state_digest,
                                                 state_to_numpy)
    from gie_mapping_tpu_torch.models.mapper import CapacityWarning

    ph = "depthcam" if kind == "depth" else "laser3D"
    ref = np.load(REF_SENSOR[kind])
    cfg, poses, data, sc, n_online, chunk = inputs = sensor_inputs(kind)
    streaming = cfg.display_glb_edt or cfg.display_glb_ogm
    runs = []

    def run():
        with recorded_runs(runs), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            return run_sensor(dev, inputs, kind, True), caught

    ((m, out, online_sha, replayed, _), caught), got = _counted(wrappers, run)
    out = out.fetch()
    cap_warn = [str(w.message) for w in caught
                if issubclass(w.category, CapacityWarning)]
    rec, st = replay_end(m, out, runs)
    bad = [k for k, v in rec.items()
           if not np.array_equal(np.asarray(v), ref["batch_" + k])]
    if streaming:
        if m.mirror.digest() != str(ref["mirror_sha"]):
            bad.append("mirror_sha")
    online_ok = online_sha == ref["online_out_sha"].tolist()
    edt_bad, kept = edt_mismatch(
        st, _window_slices(m, cfg) if cfg.fast_mode else None)
    n = len(poses) - n_online
    capacity, mirror_blocks = m.capacity_report(), len(m.mirror) if streaming else None
    # the timed pass, as bench.py's: the same frames again on the same mapper
    dd = torch.from_numpy(data[n_online:]).to(dev)
    _, ms_again, wall_again = timed(lambda: _sensor_calls(m, kind)[1](
        poses[n_online:], dd, *sc, chunk=chunk))
    # the port's own per-frame run of the same frames, on a fresh mapper
    lm, lo, _, frames, origins = run_sensor(dev, inputs, kind, False)
    # the per-frame program rounds the sensor's height offset unlike the
    # replay's scan loop (pipeline._in_scan_loop): the frame loop is held
    # against JAX's frame loop, the replay against JAX's replay, and the
    # two equal exactly where JAX's are
    loop_sha = state_digest(state_to_numpy(lm.state))
    loop_ok = (loop_sha == str(ref["loop_state_sha"])
               and output_digest(lo.glb_type, lo.dist_sq, lo.coc)
               == str(ref["loop_out_sha"]))
    loop_is_replay = loop_sha == rec["state_sha"]
    jax_loop_is_replay = str(ref["loop_state_sha"]) == str(ref["batch_state_sha"])
    replay_is_jax_replay = rec["state_sha"] == str(ref["batch_state_sha"])
    ms = [r["ms"] for r in frames]
    scrolls = sum(a != b for a, b in zip(origins, origins[1:]))
    emit({"phase": ph, "frames": len(poses), "online_frames": n_online,
          "chunk": chunk, "canvas": list(cfg.canvas_size),
          "window": list(cfg.local_size), "launches": got,
          "fixture_mismatch": bad, "online_frames_match": online_ok,
          "frame_loop_match": loop_ok, "loop_equals_replay": loop_is_replay,
          "jax_loop_equals_replay": jax_loop_is_replay,
          "replay_equals_jax_replay": replay_is_jax_replay,
          "edt_mismatch": edt_bad,
          "kept_outside_canvas": kept, "scrolls": scrolls,
          "scanned_frames": rec["scanned_frames"],
          "scanned_scrolls": rec["scanned_scrolls"],
          "run_lengths": rec["run_lengths"],
          "gate_levels": rec["pf_gate_level"].tolist(),
          "capacity": capacity, "capacity_warnings": cap_warn,
          "mirror_blocks": mirror_blocks,
          "replay_ms_per_frame": replayed[0]["ms"],
          "replay_wall_ms_per_frame": replayed[0]["wall_ms"],
          "replay_again_ms_per_frame": ms_again / n,
          "replay_again_wall_ms_per_frame": wall_again / n,
          "online_ms_per_frame": float(np.mean(ms)),
          "online_ms_per_frame_median": float(np.median(ms))})
    require(not bad, ph, f"the replay differs from the JAX reference in {bad}")
    require(online_ok, ph, "the online frames differ from the JAX reference")
    require(loop_ok, ph, "the per-frame run differs from the JAX reference's")
    require(loop_is_replay == jax_loop_is_replay, ph,
            "the replay against the per-frame run differs from the JAX relation")
    require(replay_is_jax_replay, ph, "the replay differs from JAX's replay")
    require(edt_bad == 0, ph, f"canvas dist_sq is wrong at {edt_bad} voxels")
    require(not cap_warn, ph, f"CapacityWarning fired: {cap_warn}")
    require(scrolls > 0 and rec["scanned_scrolls"] > 0, ph,
            "the path must scroll, also inside a run")
    need = ("phase1", "envelope_packed", "envelope_mid") + SCROLL_KERNELS
    require(all(got[k] > 0 for k in need), ph,
            f"a kernel of the path never launched: {got}")
    emit({"phase": ph, "ok": True, "launches": got})
    return got


class _CudaClock:
    """One frame's CUDA events, from an idle card: `ms` after the block."""

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self.s = torch.cuda.Event(enable_timing=True)
        self.e = torch.cuda.Event(enable_timing=True)
        self.s.record()
        return self

    def __exit__(self, *exc):
        import torch

        self.e.record()
        torch.cuda.synchronize()
        self.ms = self.s.elapsed_time(self.e)


def _scroll_ms_per_frame():
    """The scroll path's mean ms per frame after the first, from this
    call's emitted lines."""
    ms = [r["ms"] for r in map(json.loads, LOG)
          if r.get("phase") == "scroll" and "frame" in r and r["frame"] > 0]
    return sum(ms) / len(ms) if ms else None


def phase_scenarios(dev, wrappers, smi):
    """The JAX package's scenario tests that carry state through frames
    (tests/test_torch_scenario_cases.py's CHIP) at their test sizes, then
    the cow_lady preset's far-pivot run at full width, each against
    tests/fixtures/torch_port_scenarios_ref.npz; returns the launch counts
    of both."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_scenario_cases as sc

    ph = "scenarios"
    ref = np.load(REF_SCENARIOS)
    api = sc.port_api(dev)

    def mismatch(name, rec):
        got = sc.digest(rec)
        bad = [k for k, v in got.items()
               if (ref[f"{name}/{k}"].tolist() != v if k == "frames"
                   else str(ref[f"{name}/{k}"]) != v)]
        return bad

    total = {k: 0 for k in wrappers}
    per = {}
    t0 = time.perf_counter()
    for name in sc.CHIP:
        (cfg, m, rec), got = _counted(wrappers, lambda: sc.run_chip(api, name))
        bad = mismatch(name, rec)
        edt_bad = None
        if name in ("extent_teleport", "horizon_canvas", "soak_gate"):
            # the canvas engine's final EDT against scipy (the scroll
            # phase's rules; fast_mode: the last window only)
            edt_bad, _ = edt_mismatch(rec["state"], _window_slices(m, cfg)
                                      if cfg.fast_mode else None)
        per[name] = {k: v for k, v in got.items() if v}
        total = {k: total[k] + got[k] for k in total}
        emit({"phase": ph, "scenario": name, "frames": len(rec["frames"]),
              "fixture_mismatch": bad, "scipy_mismatch": edt_bad,
              "capacity": rec["capacity"], "warnings": rec["warnings"],
              "raised": rec["raised"], "launches": per[name]})
        require(not bad, ph, f"{name} differs from the JAX reference in {bad}")
        require(not edt_bad, ph, f"{name}: canvas dist_sq differs from scipy "
                f"at {edt_bad} voxels")
    small_s = time.perf_counter() - t0
    scan_need = ("phase1", "envelope_packed", "envelope_mid") + SCROLL_KERNELS
    require(all(total[k] > 0 for k in scan_need), ph,
            f"a kernel of the scan2D scenarios never launched: {total}")
    require(per["true_2d_relax"].get("envelope", 0) > 0, ph,
            "the generic envelope never launched on the 2-D relax map")

    # the cow_lady preset at full width, far out and back
    frames = sc.cow_far_frames()
    (cfg, m, rec), far = _counted(
        wrappers, lambda: sc.cow_far(api, frames, clock=_CudaClock))
    bad = mismatch("cow_far", rec)
    far_x = sc.mirror_max_global_x(m.mirror)
    edt_bad, kept = edt_mismatch(rec["state"])
    ms = rec["ms"][1:]
    scroll_ms = _scroll_ms_per_frame()
    emit({"phase": ph, "scenario": "cow_far", "frames": len(rec["frames"]),
          "canvas": list(cfg.canvas_size), "points": int(len(frames[0][3])),
          "origins": rec["origins"], "fixture_mismatch": bad,
          "scipy_mismatch": edt_bad, "kept_outside_canvas": kept,
          "capacity": rec["capacity"], "warnings": rec["warnings"],
          "mirror_blocks": len(m.mirror), "mirror_max_global_x": far_x,
          "launches": far, "ms_per_frame": float(np.mean(ms)),
          "ms_frames": [round(v, 4) for v in rec["ms"]],
          "scroll_path_ms_per_frame": scroll_ms, "nvidia_smi": smi,
          "small_scenarios_s": round(small_s, 3)})
    require(not bad, ph, f"cow_far differs from the JAX reference in {bad}")
    require(far_x > 32767 and far_x == int(ref["cow_far/mirror_max_x"]), ph,
            f"the mirror's largest global x coc is {far_x}")
    require(edt_bad == 0, ph, f"cow_far: canvas dist_sq differs from scipy "
            f"at {edt_bad} voxels")
    require(not rec["warnings"], ph, f"cow_far warned: {rec['warnings']}")
    require(all(v > 0 for k, v in far.items() if k != "envelope"), ph,
            f"a kernel of the far-pivot run never launched: {far}")
    emit({"phase": ph, "ok": True, "launches": {k: total[k] + far[k]
                                                for k in total}})
    return {k: total[k] + far[k] for k in total}


def dryrun_checked(ref, n, devices, wrappers):
    """graft_entry.dryrun_multichip(n, devices) with every call recorded,
    against the JAX dry run's records of the same n in `ref`.  Returns
    (its numbers, the mismatches, the launches of the canvas-engine steps
    (every call but the last), the launches of the relax-engine frame)."""
    import io

    import numpy as np

    from gie_mapping_tpu_torch import graft_entry as ge

    calls, marks = [], []
    record = ge.recorder(calls)

    def on_call(*a, **kw):
        marks.append({k: w.launches for k, w in wrappers.items()})
        record(*a, **kw)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, got = _counted(wrappers, lambda: ge.dryrun_multichip(
            n, devices=devices, on_call=on_call))
    pre = f"dry{n}/"
    bad = [] if buf.getvalue().strip() == str(ref[pre + "line"]) else ["line"]
    if len(calls) != int(ref[pre + "calls"]):
        bad.append(f"calls {len(calls)}")
    for i, rec in enumerate(calls):
        p = f"{pre}{i}/"
        want = {k[len(p):]: ref[k] for k in ref.files if k.startswith(p)}
        bad += [f"{i}/{k}" for k in sorted(set(rec) | set(want))
                if k not in rec or k not in want
                or np.asarray(rec[k]).tolist() != want[k].tolist()]
    canvas = marks[-2] if len(marks) > 1 else got
    relax = {k: got[k] - canvas[k] for k in got}
    return res, bad, canvas, relax


def phase_entry(dev, wrappers, smi):
    """The driver's entry points (gie_mapping_tpu_torch/graft_entry.py), on
    the card, against the JAX package's (tests/fixtures/torch_port_entry_ref.npz):
    entry()'s fn(*args) at the cow_lady preset's full width (a scroll to
    the pivot-0 origin, then one merge), bitwise, then timed with CUDA
    events (1 warm call, ENTRY_REPS timed); dryrun_multichip over
    [card] * ENTRY_DRYRUN, every merge and the replay bitwise, its line and
    assertions, then timed again without the recording; with two or more
    cards the dry run over distinct cards.  Returns the launch counts of
    the entry call and the recorded dry run."""
    import io

    import numpy as np
    import torch

    from gie_mapping_tpu_torch import graft_entry as ge
    from gie_mapping_tpu_torch.map_state import (output_digest, state_digest,
                                                 state_to_numpy)
    from gie_mapping_tpu_torch.models.pipeline import _slab_menu

    ph = "entry"
    ref = np.load(REF_ENTRY)
    sub = lambda p: {k[len(p):]: ref[k] for k in ref.files if k.startswith(p)}
    t0 = time.perf_counter()

    # -- entry() -----------------------------------------------------------------
    fn, args = ge.entry(dev)
    inst, cnt, pvt, origin_blk, off, (ll, ur, act, nf) = args[1:]
    want_in = sub("entry/in/")
    bad = [k for k, v in (("inst_sha", inst), ("ray_count_sha", cnt),
                          ("ll_sha", ll), ("ur_sha", ur), ("active_sha", act))
           if ge.array_sha(v.cpu().numpy()) != str(want_in[k])]
    bad += [k for k, v in (("pvt", pvt), ("origin_blk", origin_blk), ("off", off))
            if not _same(v, want_in[k])]
    if nf != int(want_in["n"]):
        bad.append("n")
    before = state_digest(state_to_numpy(args[0]))

    def check(st, out):
        o = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
             for k, v in out.items()}
        miss = [] if state_digest(state_to_numpy(st)) == str(ref["entry/state_sha"]) \
            else ["state_sha"]
        if output_digest(o["glb_type"], o["dist_sq"], o["coc"]) != str(ref["entry/out_sha"]):
            miss.append("out_sha")
        if ge.output_shapes(out) != {k: tuple(v.tolist())
                                     for k, v in sub("entry/shape/").items()}:
            miss.append("shapes")
        miss += [k for k, v in sub("entry/value/").items() if o[k].item() != v.item()]
        miss += [k for k, v in sub("entry/sha/").items()
                 if ge.array_sha(o[k]) != str(v)]
        return miss

    (st, out), got_e = _counted(wrappers, lambda: fn(*args))
    bad += check(st, out)
    entry_ms = cuda_ms(lambda: fn(*args), reps=ENTRY_REPS, warm=1)
    bad += [f"repeat/{k}" for k in check(*fn(*args))]
    if state_digest(state_to_numpy(args[0])) != before:
        bad.append("args_changed")
    emit({"phase": ph, "part": "entry", "canvas": list(st.vox_type.shape),
          "shapes": {k: list(v) for k, v in ge.output_shapes(out).items()},
          "gate_level": int(out["gate_level"]), "launches": got_e,
          "fixture_mismatch": bad, "ms": entry_ms, "reps": ENTRY_REPS,
          "nvidia_smi": smi})
    require(not bad, ph, f"entry() differs from the JAX entry in {bad}")
    need = ("phase1", "envelope_packed", "envelope_mid", "shift_canvas")
    require(all(got_e[k] > 0 for k in need), ph,
            f"a kernel of entry() never launched: {got_e}")

    # -- dryrun_multichip over this card ---------------------------------------
    n = ENTRY_DRYRUN
    res, bad, canvas, relax = dryrun_checked(ref, n, [dev] * n, wrappers)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, wall_s = timed_wall(lambda: ge.dryrun_multichip(n, devices=[dev] * n))
    torch.cuda.synchronize()
    levels = res["gate_levels"]
    n_menu = len(_slab_menu(ge.dryrun_config(n).canvas_size))
    asserted = {"raise_rises": res["raise_after"] > res["raise_probe"],
                "slab_level": any(0 <= g < n_menu for g in levels),
                "intermediate_level": any(0 < g < n_menu for g in levels),
                "relax_iterates": res["relax_iters"] > 0}
    emit({"phase": ph, "part": "dryrun", "shards": n,
          "devices": [str(dev)] * n, **res, "fixture_mismatch": bad,
          "asserted": asserted, "launches_canvas_engine": canvas,
          "launches_relax_frame": relax,
          "ms_per_frame": wall_s * 1e3 / res["merges"],
          "wall_s_unrecorded": round(wall_s, 4), "nvidia_smi": smi})
    require(not bad, ph, f"the dry run differs from the JAX dry run in {bad}")
    require(all(asserted.values()), ph, f"a dry-run assertion failed: {asserted}")
    require(all(canvas[k] > 0 for k in ("phase1", "envelope_packed", "envelope",
                                        "shift_canvas"))
            and canvas["envelope_mid"] == 0, ph,
            f"the sharded canvas EDT's kernels must run: {canvas}")
    require(relax["envelope_mid"] > 0, ph,
            f"the relax frame's window EDT must run phase 3: {relax}")

    # -- distinct cards --------------------------------------------------------------
    cards = torch.cuda.device_count()
    nd = next((k for k in MESH_SIZES[::-1] if k <= cards), 0)
    if nd < 2:
        emit({"phase": ph, "part": "distinct_cards",
              "not_run": f"{cards} CUDA device: a dry run over distinct cards "
                         "needs two"})
    else:
        dres, dbad, _, _ = dryrun_checked(ref, nd, None, wrappers)
        emit({"phase": ph, "part": "distinct_cards", "devices": nd, **dres,
              "fixture_mismatch": dbad})
        require(not dbad, ph, f"the dry run over {nd} cards differs in {dbad}")
    got = {k: got_e[k] + canvas[k] + relax[k] for k in wrappers}
    emit({"phase": ph, "ok": True, "launches": got,
          "seconds": round(time.perf_counter() - t0, 3)})
    return got


def phase_bench(dev, wrappers, smi):
    """The port's harnesses (gie_mapping_tpu_torch/bench/) at full size,
    each through its plain function as `python -m` runs it: the headline
    (its state after warm-up and the first batch call against
    tests/fixtures/torch_port_replay_ref.npz's bench run), the six suite
    cases, the scaling point(s), and
    the 500-frame RMSE soak under the JAX test's assertions.  Prints each
    harness's JSON line, then a line with the step's wall time and
    launches; returns the launch counts of all four.  A suite case fails
    on a stage cost that is not positive or on a tail order that is
    "inverted" (suite.tail_order: out of order beyond the scroll chains'
    spread); p95 above worst within that spread is printed, not failed:
    the two chains run the same host operations, and on a host-paced card
    their costs can come out equal."""
    import numpy as np

    from gie_mapping_tpu_torch.bench import headline, scaling, suite

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_scenario_cases as sc

    ph = "bench"
    ref = np.load(REF_REPLAY)
    total = dict.fromkeys(wrappers, 0)

    def step(run):
        (r, got), wall_s = timed_wall(lambda: _counted(wrappers, run))
        for k, v in got.items():
            total[k] += v
        return r, got, wall_s

    # -- the headline: bench.py's run, the fixture's own sequence -----------
    runs, warm = [], {}

    def after_warmup(m, out):
        rec, _ = replay_end(m, out.fetch(), runs)
        warm["bad"] = [k for k, v in rec.items()
                       if not np.array_equal(np.asarray(v), ref[f"bench_{k}"])]

    def run_headline():
        with recorded_runs(runs):
            return headline.run(dev, after_warmup=after_warmup)

    line, got, wall_s = step(run_headline)
    emit(line)
    e = line["extra"]
    emit({"phase": ph, "part": "headline", "wall_s": wall_s, "launches": got,
          "fixture_mismatch": warm.get("bad")})
    require(warm.get("bad") == [], ph, "the headline's state after warm-up "
            f"differs from the JAX bench run in {warm.get('bad')}")
    require(line["value"] > 0 and e["passes"] == headline.N_PASSES
            and e["device"] == smi, ph, f"bad headline line: {line}")
    need = ("phase1", "envelope_packed", "envelope_mid", "panorama", "carve",
            "shift_canvas")
    require(all(got[k] > 0 for k in need), ph,
            f"a kernel of the headline never launched: {got}")

    # -- the suite's six cases, then its summary ------------------------------
    lines = []
    for case in suite.CASES:
        line, got, wall_s = step(lambda: suite.bench_case(case, dev))
        lines.append(line)
        emit(line)
        e = line["extra"]
        emit({"phase": ph, "part": "suite", "case": case, "wall_s": wall_s,
              "launches": got, "tail_order": e["tail_order"]})
        stages = [e[k] for k in ("edt_ms", "steady_ms", "scroll_ms",
                                 "teleport_ms")]
        require(all(v > 0 for v in stages), ph, f"{case}: stage costs {stages}")
        require(e["tail_order"] != "inverted", ph,
                f"{case}: p50 {e['p50_ms']}, p95 {e['p95_ms']}, worst "
                f"{e['worst_ms']} are out of order beyond the stages' spread")
        need = ("phase1", "envelope_packed", "envelope_mid") + SCROLL_KERNELS
        if e["sensor"] == "pointcloud":
            need += ("panorama", "carve")
        require(all(got[k] > 0 for k in need), ph,
                f"{case}: a kernel of the case never launched: {got}")
    emit(suite.summary(lines, smi))

    # -- the scaling point(s): one card, every visible card where more --------
    (line, _), got, wall_s = step(lambda: scaling.run(dev))
    emit(line)
    emit({"phase": ph, "part": "scaling", "wall_s": wall_s, "launches": got,
          "cards": line["extra"]["devices"]})
    require(line["extra"]["points_ms"]["1"] > 0, ph, f"bad scaling line: {line}")

    # -- the 500-frame RMSE soak ---------------------------------------------
    rec, got, wall_s = step(lambda: sc.soak_rmse(sc.port_api(dev)))
    faults = sc.soak_rmse_faults(rec)
    curve = rec["curve"]
    emit({"phase": ph, "part": "soak", "frames": rec["frames"],
          "checked": len(curve), "wall_s": wall_s, "launches": got,
          "rmse_max_m": max(r["rmse_m"] for r in curve),
          "max_err_max_m": max(r["max_err_m"] for r in curve),
          "n_arch_last": curve[-1]["n_arch"], "capacity": rec["capacity"],
          "faults": faults[:10]})
    require(not faults, ph, f"the soak broke the JAX test's assertions: "
            f"{faults[:5]}")
    emit({"phase": ph, "ok": True, "launches": total})
    return total


# parts of a frame, the teleport bench, the A/Bs and the synthetic bag ------
PARTS_FRAME_CASES = ("scan2D", "depthcam", "laser3D")
# the kernels each stage must launch on the card (bench/parts.py's names)
PARTS_EDT = ("phase1", "envelope_packed", "envelope_mid")
PARTS_NEED = {
    ("frame", "edt_only"): PARTS_EDT, ("merge", "edt_only"): PARTS_EDT,
    ("edt", "batch_edt"): PARTS_EDT, ("edt", "phase1"): ("phase1",),
    ("edt", "phase2"): ("envelope_packed",), ("edt", "phase3"): ("envelope_mid",),
    ("frame", "scroll_step"): ("shift_canvas",),
    ("frame", "scroll_teleport"): ("shift_canvas",),
    ("scroll", "shift"): ("shift_canvas",), ("scroll", "compact"): ("shift_canvas",),
    ("scroll", "full"): ("shift_canvas",),
}


@contextlib.contextmanager
def plain_edt():
    """batch_edt with its three kernels' plain versions (the plain chain)."""
    from gie_mapping_tpu_torch.ops import edt_batch as eb
    from gie_mapping_tpu_torch.ops.kernels import envelope as ke
    from gie_mapping_tpu_torch.ops.kernels import phase1 as kp

    saved = (eb.phase1_packed, eb.envelope_packed, eb.envelope_mid)
    eb.phase1_packed, eb.envelope_packed, eb.envelope_mid = (
        kp.phase1_packed_plain, ke.envelope_packed_plain, ke.envelope_mid_plain)
    try:
        yield
    finally:
        eb.phase1_packed, eb.envelope_packed, eb.envelope_mid = saved


def phase_parts(dev, wrappers, smi):
    """bench/parts.py, bench/teleport.py, bench/ab.py and
    runtime/synthetic_bag.py through their plain functions: every parts
    group at cow_lady and the frame group at scan2D, depthcam and laser3D
    (each stage's ms > 0 and busy_ms <= 1.05 ms; the kernels each stage
    must launch); the composition checks (the sensor stage then merge_full
    equal one process_* frame on a copy of the frozen state, every field;
    the scroll steps compose to _do_scroll, compact and full; the edt
    group's batch_edt equals the plain chain); the teleport bench at
    depthcam (40 frames, 2 reps; every arm timed, the jump frames found);
    the gate and p1c A/Bs at cow_lady, rung at depthcam and engine (both
    arms timed; the arms' state differences printed); the synthetic bag of
    10 frames converted and replayed through the CLI.  Prints each line,
    each step's wall time and launches; returns the launch counts."""
    import tempfile

    import numpy as np
    import torch

    from gie_mapping_tpu_torch.bench import ab, parts, teleport
    from gie_mapping_tpu_torch.ops.edt_batch import batch_edt
    from gie_mapping_tpu_torch.runtime import synthetic_bag

    ph = "parts"
    total = dict.fromkeys(wrappers, 0)

    def step(part, run):
        (r, got), wall_s = timed_wall(lambda: _counted(wrappers, run))
        for k, v in got.items():
            total[k] += v
        emit({"phase": ph, "part": part, "wall_s": wall_s, "launches": got})
        return r

    # -- the stages: every group at cow_lady, the frame group elsewhere -------
    lines = step("parts_cow_lady", lambda: parts.run(dev, ("cow_lady",),
                                                     emit=False))
    lines += step("parts_frame", lambda: parts.run(dev, PARTS_FRAME_CASES,
                                                   ("frame",), emit=False))
    seen = set()
    for line in lines:
        emit(line)
        g = line["group"]
        require(line["device"] == smi, ph, f"{g}: device {line['device']}")
        for name, rec in line["stages"].items():
            seen.add((g, name))
            require(rec["ms"] > 0 and rec["busy_ms"] is not None
                    and rec["busy_ms"] <= 1.05 * rec["ms"], ph,
                    f"{line['case']} {g}.{name}: ms {rec['ms']}, busy_ms "
                    f"{rec['busy_ms']}")
            need = PARTS_NEED.get((g, name), ())
            if g == "sensor" and name == "sensor" and \
                    line["sensor"] == "pointcloud":
                need = ("panorama", "carve")
            require(all(rec["launches"].get(k, 0) > 0 for k in need), ph,
                    f"{line['case']} {g}.{name} launched {rec['launches']}, "
                    f"not all of {need}")
        if g == "scroll":
            moved = set().union(*(r["launches"] for r in line["stages"].values()))
            require(set(SCROLL_KERNELS) <= moved, ph,
                    f"the scroll group launched only {sorted(moved)}")
    require(set(PARTS_NEED) <= seen, ph,
            f"stages not run: {sorted(set(PARTS_NEED) - seen)}")

    # -- composition ----------------------------------------------------------
    def compose():
        bad = {}
        for case in ("cow_lady",) + PARTS_FRAME_CASES:
            fz = parts.freeze(case, dev)
            inst, cnt = fz.sensor()
            got, _ = fz.merge(fz.state, inst, cnt)
            bad[case] = parts.state_mismatch(got, fz.mapper_frame(fz.state))
        cfg, st = parts.scroll_state("cow_lady", dev)
        origin = st.origin_blk.cpu().numpy()
        for cols in (32, None):
            bad[f"scroll_cols_{cols}"] = parts.scroll_composition(
                st, cfg, origin, cols)
        for name, shape, zlo, zhi, frac in parts.EDT_CASES:
            g = parts.edt_canvas(shape, zlo, zhi, frac, dev)
            got = batch_edt(g, sum(shape))
            with plain_edt():
                want = batch_edt(g, sum(shape))
            bad[f"edt_{name}"] = [k for k in want
                                  if not torch.equal(got[k], want[k])]
        return bad

    bad = step("compose", compose)
    emit({"phase": ph, "part": "compose_mismatch", "mismatch": bad})
    require(not any(bad.values()), ph, f"stages do not compose: {bad}")

    # -- the teleport bench ---------------------------------------------------
    line = step("teleport", lambda: teleport.run(dev, "depthcam", frames=40,
                                                 reps=2))
    emit(line)
    require(len(line["best_ms"]) == 3 and all(
        len(v) == 2 and min(v) > 0 for v in line["passes"].values()), ph,
        f"teleport arms not all timed: {line['passes']}")
    # at 40 frames the every-40 arm stays home; the every-10 arm jumps 4 times
    want = {f"teleport_every_{p}": int(teleport.jump_frames(
        (np.arange(40) // p) % 2 == 1).sum()) for p in teleport.PERIODS}
    got = {n: o["jump_frames"] for n, o in line["online"].items()}
    require(got == want and all(o["jump_frame_ms"] is not None
                                for n, o in line["online"].items() if want[n]),
            ph, f"teleport: jump frames {got}, want {want}: {line['online']}")

    # -- the A/Bs --------------------------------------------------------------
    for what, cases in (("gate", ("cow_lady",)), ("p1c", ("cow_lady",)),
                        ("rung", ("depthcam",)), ("engine", ("cow_lady",))):
        for line in step(f"ab_{what}", lambda w=what, c=cases: ab.run(
                dev, w, c, reps=2, emit=False)):
            emit(line)
            require(len(line["best_ms"]) == 2 and all(
                len(v) == 2 and min(v) > 0 for v in line["passes"].values()),
                ph, f"ab {what}: arms not timed: {line['passes']}")

    # -- the synthetic bag, converted and replayed -----------------------------
    with tempfile.TemporaryDirectory() as d:
        rc = step("synthetic_bag", lambda: synthetic_bag.main(
            [os.path.join(d, "synth.bag"), "--frames", "10", "--run"]))
    require(rc == 0, ph, f"synthetic_bag --run returned {rc}")
    emit({"phase": ph, "ok": True, "launches": total})
    return total


def dda_inputs():
    """(config, poses, clouds) of the DDA path (datasets.dda_path)."""
    from gie_mapping_tpu_torch.runtime import datasets as ds
    from gie_mapping_tpu_torch.utils import config as tcfg

    overrides, world, poses = ds.dda_path()
    clouds = [world.pointcloud(p, n_rays=ds.SUITE_RAYS, max_range=8.0, seed=i)
              for i, p in enumerate(poses)]
    return tcfg.uav_laser3d_fine_config(**overrides), poses, clouds


def run_dda(dev, inputs, loop_ctx=None):
    """The DDA path's frames through process_pointcloud on a fresh mapper,
    inside `loop_ctx`; returns (mapper, per-frame records)."""
    import numpy as np
    import torch

    from gie_mapping_tpu_torch.map_state import output_digest
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    cfg, poses, clouds = inputs
    m = VolumetricMapper(cfg, device=dev)
    staged = [m.stage_pointcloud(c) for c in clouds]
    torch.cuda.synchronize()
    recs = []
    with loop_ctx or contextlib.nullcontext():
        for i, (p, (pts, val)) in enumerate(zip(poses, staged)):
            before = None if m._origin is None else m._origin.copy()
            t0 = time.perf_counter()
            out, t, _ = timed(lambda: m.process_pointcloud(p, pts, val))
            wall = (time.perf_counter() - t0) * 1e3
            gt = out.glb_type
            recs.append(dict(
                frame=i, ms=t, wall_ms=wall, gate_level=int(out.gate_level),
                origin=[int(v) for v in m._origin],
                scrolled=before is None or not np.array_equal(before, m._origin),
                type_counts=np.bincount(gt.astype(np.int64).ravel(),
                                        minlength=4)[:4].tolist(),
                out_sha=output_digest(gt, out.dist_sq, out.coc)))
        m.flush_stream()
        m.check_capacity()
    return m, recs


def phase_dda(dev, wrappers):
    """The DDA path against its JAX fixture; returns its launch counts."""
    import warnings

    import numpy as np

    from gie_mapping_tpu_torch.map_state import state_digest, state_to_numpy
    from gie_mapping_tpu_torch.models.mapper import CapacityWarning
    from gie_mapping_tpu_torch.ops.raycast import max_dda_steps

    ph = "dda"
    ref = np.load(REF_SENSOR["dda"])
    inputs = dda_inputs()
    cfg = inputs[0]

    def run():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            return run_dda(dev, inputs), caught

    ((m, recs), caught), got = _counted(wrappers, run)
    cap_warn = [str(w.message) for w in caught
                if issubclass(w.category, CapacityWarning)]
    st = state_to_numpy(m.state)
    edt_bad, kept = edt_mismatch(st, _window_slices(m, cfg))
    col = lambda k: [r[k] for r in recs]
    origins_ok = col("origin") == ref["origin"].tolist()
    steps_ok = (col("scrolled") == ref["scrolled"].tolist()
                and col("gate_level") == ref["gate_level"].tolist())
    out_match = sum(r["out_sha"] == str(ref["out_sha"][i])
                    for i, r in enumerate(recs))
    sha_ok = state_digest(st) == str(ref["state_sha"])
    mirror_ok = m.mirror.digest() == str(ref["mirror_sha"])
    scroll_ms = [r["ms"] for r in recs[1:] if r["scrolled"]]
    other_ms = [r["ms"] for r in recs[1:] if not r["scrolled"]]
    emit({"phase": ph, "frames": len(recs), "points": cfg.max_raycast_points,
          "dda_steps": max_dda_steps(cfg.local_size),
          "canvas": list(cfg.canvas_size), "launches": got,
          "edt_mismatch": edt_bad, "kept_outside_canvas": kept,
          "origins_match": origins_ok, "scroll_gate_match": steps_ok,
          "frames_bitwise": out_match, "state_sha_match": sha_ok,
          "mirror_match": mirror_ok, "mirror_blocks": len(m.mirror),
          "capacity": m.capacity_report(), "capacity_warnings": cap_warn,
          "ms_per_frame_mean_after_first": float(np.mean(col("ms")[1:])),
          "ms_per_frame_median_after_first": float(np.median(col("ms")[1:])),
          "ms_scroll_frames_mean": float(np.mean(scroll_ms)) if scroll_ms else None,
          "ms_other_frames_mean": float(np.mean(other_ms)),
          "n_scroll_frames": len(scroll_ms)})
    require(origins_ok, ph, "canvas origins differ from the JAX reference")
    require(steps_ok, ph, "scrolls or gate levels differ from the JAX reference")
    require(out_match == len(recs), ph,
            f"only {out_match} of {len(recs)} frames match the JAX reference")
    require(sha_ok, ph, "final state differs from the JAX reference")
    require(mirror_ok, ph, "the host mirror differs from the JAX reference")
    require(edt_bad == 0, ph, f"canvas dist_sq is wrong at {edt_bad} voxels")
    require(not cap_warn, ph, f"CapacityWarning fired: {cap_warn}")
    require(scroll_ms, ph, "the path must scroll")
    need = ("phase1", "envelope_packed", "envelope_mid") + SCROLL_KERNELS
    require(all(got[k] > 0 for k in need), ph,
            f"a kernel of the path never launched: {got}")
    emit({"phase": ph, "ok": True, "launches": got})
    return got


def _same(a, b) -> bool:
    """Bitwise equality of two arrays (dtype, shape and bytes)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def cli_runs(wrappers, smi):
    """Every run of CLI_RUNS through cli.main on the card; returns
    ({tag: (summary, checkpoint digests, CSV rows)}, {tag: launches})."""
    import tempfile

    from gie_mapping_tpu_torch import cli as tcli

    res, launches = {}, {}
    for tag, case, extra in CLI_RUNS:
        with tempfile.TemporaryDirectory() as d:
            argv = cli_argv(case, extra, d)
            (summary, wall), launches[tag] = _counted(
                wrappers, lambda: timed_wall(lambda: tcli.main(argv)))
            res[tag] = (summary, checkpoint_digests(os.path.join(d, "map.npz")),
                        csv_rows(os.path.join(d, "log.csv")))
        emit({"phase": "cli", "run": tag, "argv": argv[:3] + list(extra),
              "ms_per_frame": summary["ms_per_frame"],
              "wall_s_with_setup": round(wall, 3), "nvidia_smi": smi})
    return res, launches


def timed_wall(fn):
    """(fn(), host seconds)."""
    t0 = time.perf_counter()
    r = fn()
    return r, time.perf_counter() - t0


def phase_cli(dev, wrappers, smi):
    """The entry points a user runs, on the card, against the JAX package's
    results (tests/fixtures/torch_port_cli_ref.npz): the committed bags
    through the port's reader; every preset through cli.main at its own
    defaults (CLI_FRAMES frames, checkpoint and CSV), cow_lady also with
    --batch 4 and scan2D also with --profile; a resume from a checkpoint
    against the uninterrupted run; process_multiscan_cloud at the laser3D
    preset against the port's own replay of its ring images;
    process_ext_cloud between two replay calls at the cow_lady preset's
    width against the port's own frame loop.  Returns the launch counts of
    all of it."""
    import tempfile

    import numpy as np

    from gie_mapping_tpu_torch import cli as tcli
    from gie_mapping_tpu_torch.map_state import (output_digest, state_digest,
                                                 state_to_numpy)
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.runtime import datasets as ds
    from gie_mapping_tpu_torch.runtime import rosbag as trosbag
    from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest
    from gie_mapping_tpu_torch.runtime.rings import cloud_to_rings
    from gie_mapping_tpu_torch.utils import config as tcfg

    ph = "cli"
    ref = np.load(REF_CLI)
    t_phase = time.perf_counter()
    sha = lambda out: output_digest(out.glb_type, out.dist_sq, out.coc)
    state_sha = lambda m: state_digest(state_to_numpy(m.state))

    # (a) the committed bags
    bag_bad, n_arrays = [], 0
    for name, sensor, odom in BAGS:
        got = bag_frames(trosbag, os.path.join(ROOT, "tests", "fixtures", name),
                         sensor, odom)
        pre = f"bag/{name}/"
        want = {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}
        n_arrays += len(want)
        if set(got) != set(want):
            bag_bad.append(f"{name}: fields {sorted(set(got) ^ set(want))}")
            continue
        bag_bad += [f"{name}/{k}" for k in want if not _same(got[k], want[k])]
    emit({"phase": ph, "part": "bags", "arrays": n_arrays, "mismatch": bag_bad})
    require(n_arrays > 0 and not bag_bad, ph, f"bag frames differ: {bag_bad}")

    # (b) every preset through the CLI, (e) the profiled run
    runs, launches = cli_runs(wrappers, smi)
    bad = []
    for tag, (summary, digests, rows) in runs.items():
        pre = f"cli/{tag}/"
        bad += [f"{tag}.{k}" for k in CLI_COUNTS
                if summary[k] != int(ref[pre + k])]
        want = {k[len(pre) + 4:]: str(ref[k]) for k in ref.files
                if k.startswith(pre + "sha/")}
        if digests != want:
            bad.append(f"{tag}.checkpoint: " + ", ".join(
                sorted(k for k in set(want) | set(digests)
                       if digests.get(k) != want.get(k))))
        if len(rows) != summary["frames"] or len(rows) != int(ref[pre + "csv_rows"]):
            bad.append(f"{tag}.csv_rows")
        if pre + "rmse" in ref.files:
            if [r[2] for r in rows] != ref[pre + "rmse"].tolist():
                bad.append(f"{tag}.rmse: {[r[2] for r in rows]}")
    emit({"phase": ph, "part": "runs", "runs": len(runs),
          "summaries": {t: r[0] for t, r in runs.items()},
          "rmse": [r[2] for r in runs["scan2D_profile"][2]],
          "launches": launches, "mismatch": bad})
    require(not bad, ph, f"CLI runs differ from the JAX reference: {bad}")
    for tag, got in launches.items():
        need = ("phase1", "envelope_packed", "envelope_mid")
        if runs[tag][0]["case"] in ("cow_lady", "ugv_corridor",
                                    "uav_raycast_fine"):
            need += ("panorama", "carve")
        require(all(got[k] > 0 for k in need), ph,
                f"{tag}: a kernel of its path never launched: {got}")

    # (c) resume: save after RESUME_SPLIT frames, load into a fresh mapper
    cfg = tcfg.cow_lady_config()
    frames = list(tcli.synthetic_frames(cfg, RESUME_FRAMES))

    def resume():
        full = VolumetricMapper(cfg, device=dev)
        full_sha = [sha(tcli.dispatch(full, p, k, pl).fetch())
                    for p, (k, pl) in frames]
        full.flush_stream()
        first = VolumetricMapper(cfg, device=dev)
        for p, (k, pl) in frames[:RESUME_SPLIT]:
            tcli.dispatch(first, p, k, pl)
        with tempfile.TemporaryDirectory() as d:
            ckpt = os.path.join(d, "map.npz")
            first.save(ckpt)
            digests = checkpoint_digests(ckpt)
            second = VolumetricMapper(cfg, device=dev).load(ckpt)
        out_sha = [sha(tcli.dispatch(second, p, k, pl).fetch())
                   for p, (k, pl) in frames[RESUME_SPLIT:]]
        return full_sha, state_sha(full), digests, out_sha, second

    (full_sha, full_state, digests, out_sha, second), got = _counted(wrappers, resume)
    launches["resume"] = got
    rec = {"full_out_sha": full_sha == ref["resume/full_out_sha"].tolist(),
           "full_state_sha": full_state == str(ref["resume/full_state_sha"]),
           "ckpt_sha": [list(kv) for kv in sorted(digests.items())]
           == ref["resume/ckpt_sha"].tolist(),
           "out_sha": out_sha == ref["resume/out_sha"].tolist(),
           "state_sha": state_sha(second) == str(ref["resume/state_sha"]),
           "map_ct": second.map_ct == int(ref["resume/map_ct"])}
    vs_full = {"outputs": out_sha == full_sha[RESUME_SPLIT:],
               "state": state_sha(second) == full_state}
    ref_vs_full = {
        "outputs": ref["resume/out_sha"].tolist()
        == ref["resume/full_out_sha"].tolist()[RESUME_SPLIT:],
        "state": str(ref["resume/state_sha"]) == str(ref["resume/full_state_sha"])}
    emit({"phase": ph, "part": "resume", "frames": RESUME_FRAMES,
          "saved_after": RESUME_SPLIT, "match_jax": rec,
          "equal_to_uninterrupted": vs_full,
          "jax_equal_to_uninterrupted": ref_vs_full, "launches": got})
    require(all(rec.values()), ph, f"the resume differs from the JAX reference: {rec}")
    require(vs_full == ref_vs_full, ph,
            f"resume against the uninterrupted run: {vs_full}, JAX {ref_vs_full}")

    # (d) the raw ring cloud at the laser3D preset
    cfg = tcfg.uav_laser3d_config()
    world, poses = ds.multiscan_cloud_path()
    clouds = [ds.ring_cloud(world, p) for p in poses]

    def multiscan():
        m = VolumetricMapper(cfg, device=dev)
        outs, origins = [], []
        for p, (pts, ring, pmin, pinc) in zip(poses, clouds):
            outs.append(m.process_multiscan_cloud(p, pts, ring, phi_min=pmin,
                                                  phi_inc=pinc).fetch())
            origins.append(m._origin.tolist())
        m.flush_stream()
        return m, outs, origins

    (m, outs, origins), got = _counted(wrappers, multiscan)
    launches["multiscan_cloud"] = got
    rings = [cloud_to_rings(pts, ring) for pts, ring, _, _ in clouds]
    ring_bad = [int((r[0].view(np.uint32) != w.view(np.uint32)).sum())
                for r, w in zip(rings, ref["multiscan/rings"])]
    rec = {"out_sha": [sha(o) for o in outs] == ref["multiscan/out_sha"].tolist(),
           "origin": origins == ref["multiscan/origin"].tolist(),
           "state_sha": state_sha(m) == str(ref["multiscan/state_sha"]),
           "mirror_sha": m.mirror.digest() == str(ref["multiscan/mirror_sha"])}
    own = VolumetricMapper(cfg, device=dev)
    _, tmin, tinc = rings[0]
    own.process_multiscan_batch(poses, np.stack([r[0] for r in rings]), tmin,
                                tinc, clouds[0][2], clouds[0][3],
                                chunk=len(poses))
    own.flush_stream()
    own_ok = state_sha(own) == state_sha(m) and own.mirror.digest() == m.mirror.digest()
    emit({"phase": ph, "part": "multiscan_cloud", "frames": len(poses),
          "points": [len(c[0]) for c in clouds], "ring_bins_differing": ring_bad,
          "match_jax": rec, "replay_of_the_rings_matches": own_ok,
          "launches": got})
    require(not any(ring_bad), ph, f"ring images differ from the JAX host's "
            f"in {ring_bad} bins")
    require(all(rec.values()), ph, f"process_multiscan_cloud differs from JAX: {rec}")
    require(own_ok, ph, "process_multiscan_cloud differs from the port's replay")

    # (d) the external-observer cloud between two replay calls (fence churn)
    overrides, world, poses, boxes, ext_cloud, split, chunk = ds.ext_churn_path()
    cfg = tcfg.cow_lady_config(**overrides)
    pcs = [world.pointcloud(p, n_rays=ds.EXT_CHURN_RAYS, max_range=8.0, seed=i)
           for i, p in enumerate(poses)]

    def ext(replay):
        m = VolumetricMapper(cfg, device=dev)
        for ll, ur in boxes:
            m.ext_obs.append(ll, ur)
        if replay:
            pts, val = m.stage_pointcloud_batch(pcs)
            m.process_pointcloud_batch(poses[:split], pts[:split], val[:split],
                                       chunk=chunk)
            n = m.process_ext_cloud(ext_cloud)
            out = m.process_pointcloud_batch(poses[split:], pts[split:],
                                             val[split:], chunk=chunk).fetch()
            return m, n, [sha(out)]
        outs = []
        for i, (p, c) in enumerate(zip(poses, pcs)):
            if i == split:
                n = m.process_ext_cloud(ext_cloud)
            outs.append(sha(m.process_pointcloud(p, c).fetch()))
        return m, n, outs

    (mr, nr, rsha), got = _counted(wrappers, lambda: ext(True))
    launches["ext_cloud"] = got
    ml, nl, lsha = ext(False)
    want = ref["ext/out_sha"].tolist()
    rec = {"replay_state": state_sha(mr) == str(ref["ext/state_sha"]),
           "replay_last_out": rsha[-1] == want[-1],
           "loop_frames": sum(a == b for a, b in zip(lsha, want)),
           "loop_state": state_sha(ml) == str(ref["ext/state_sha"]),
           "boxes": [nr, nl, int(ref["ext/n_boxes"])],
           "scanned_frames": mr.replay_scanned_frames}
    emit({"phase": ph, "part": "ext_cloud", "frames": len(poses),
          "split": split, "chunk": chunk, "match_jax": rec,
          "fence_on": ref["ext/fence_on"].tolist(), "launches": got})
    require(rec["replay_state"] and rec["replay_last_out"], ph,
            f"the replay with the ext cloud differs from JAX: {rec}")
    require(rec["loop_frames"] == len(poses) and rec["loop_state"], ph,
            f"the frame loop with the ext cloud differs from JAX: {rec}")
    require(nr == nl == int(ref["ext/n_boxes"]), ph, f"box counts {rec['boxes']}")
    require(mr.replay_scanned_frames > 0, ph, "no frame ran in a replay run")

    total = {k: sum(v[k] for v in launches.values()) for k in wrappers}
    need = [k for k in wrappers if k != "envelope"]
    require(all(total[k] > 0 for k in need), ph,
            f"a kernel of the path never launched: {total}")
    emit({"phase": ph, "ok": True, "launches": total,
          "seconds": round(time.perf_counter() - t_phase, 3)})
    return total


def phase_profile(dev, frames, poses, out_dir=None):
    """torch.profiler over the frame loop of a second run of each path:
    device time by kernel, launches, and the device's idle share of the
    loop."""
    from torch.profiler import ProfilerActivity, profile

    runs = {"slice": lambda ctx: run_slice(dev, frames, poses, loop_ctx=ctx)[1]}
    sc = scroll_inputs()
    runs["scroll"] = lambda ctx: run_scroll(dev, *sc, loop_ctx=ctx)[1]
    for name, flat in (("scan2d", False), ("scan2d_flat", True)):
        si = scan_inputs(flat)
        runs[name] = lambda ctx, si=si: run_scan(dev, *si, loop_ctx=ctx)[1]
    bi = bench_inputs()
    for name, replay in (("bench_online", False), ("bench_replay", True)):
        runs[name] = lambda ctx, r=replay: run_bench(dev, bi, r, loop_ctx=ctx)
    for kind, label in (("depth", "depthcam"), ("multiscan", "laser3D")):
        si = sensor_inputs(kind)
        for suffix, replay in (("online", False), ("replay", True)):
            runs[f"{label}_{suffix}"] = (
                lambda ctx, si=si, kind=kind, r=replay:
                run_sensor(dev, si, kind, r, loop_ctx=ctx)[3])
    di = dda_inputs()
    runs["dda"] = lambda ctx: run_dda(dev, di, loop_ctx=ctx)[1]
    for name, run in runs.items():
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        recs = run(prof)
        loop_ms = sum(r["wall_ms"] for r in recs)
        rows, dev_total, launches = [], 0.0, 0
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", 0.0)
            if t > 0 and ev.device_type.name == "CUDA":
                rows.append((t / 1e3, ev.key, ev.count))
                dev_total += t / 1e3
                launches += ev.count
        rows.sort(reverse=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
        emit({"phase": "profile", "path": name, "frames": len(recs),
              "loop_wall_ms": round(loop_ms, 3),
              "device_busy_ms": round(dev_total, 3),
              "device_idle_share": round(1 - dev_total / loop_ms, 4) if loop_ms else None,
              "device_launches": launches,
              "host_ingest_ms": round(sum(r.get("ingest_ms", 0.0) for r in recs), 3),
              "top": [{"name": k[:70], "ms": round(t, 3), "count": c}
                      for t, k, c in rows[:30]]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines and the build log here")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass over a second run of each path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from gie_mapping_tpu_torch.ops.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "ok": True, "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.time()
    try:
        from concurrent.futures import ThreadPoolExecutor

        from gie_mapping_tpu_torch.runtime import native

        # the host library (g++) builds beside the kernels (nvcc), so the
        # CLI runs below do not time its first build
        with ThreadPoolExecutor(1) as pool:
            host = pool.submit(timed_wall, native.build)
            finish_parent = start_parent_build()
            try:
                so, build_s = _build.build()
            finally:
                parent = finish_parent()
            host_so, host_s = host.result()
        _build.library()
        native.get_lib()
        emit({"phase": "build", "ok": True, "seconds": round(build_s, 3),
              "library": os.path.relpath(so, ROOT), "parent": parent is not None,
              "host_library": os.path.relpath(host_so, ROOT),
              "host_seconds": round(host_s, 3)})
        results: dict = {}
        phase_kernels(dev, results, parent)
        launches, frames, poses = phase_slice(dev)
        for path_launches in (phase_scroll(dev, all_wrappers()),
                              phase_scan(dev, all_wrappers(), flat=False),
                              phase_scan(dev, all_wrappers(), flat=True),
                              phase_replay(dev, all_wrappers()),
                              phase_sensor(dev, all_wrappers(), "depth"),
                              phase_sensor(dev, all_wrappers(), "multiscan"),
                              phase_dda(dev, all_wrappers()),
                              phase_cli(dev, all_wrappers(), smi),
                              phase_mesh(dev, all_wrappers(), smi, frames, poses,
                                         parent),
                              phase_multiproc(dev, smi),
                              phase_scenarios(dev, all_wrappers(), smi),
                              phase_entry(dev, all_wrappers(), smi),
                              phase_bench(dev, all_wrappers(), smi),
                              phase_parts(dev, all_wrappers(), smi)):
            launches = {k: launches.get(k, 0) + v for k, v in path_launches.items()}
        if args.profile:
            phase_profile(dev, frames, poses, args.out)
        meta = {
            "phase1": ("csrc/phase1.cu", "gie_mapping_tpu/ops/pallas/phase1.py:90"),
            "envelope_packed": ("csrc/envelope.cu",
                                "gie_mapping_tpu/ops/pallas/envelope.py:739"),
            "envelope_mid": ("csrc/envelope.cu",
                             "gie_mapping_tpu/ops/pallas/envelope.py:719"),
            "panorama": ("csrc/carve.cu", "gie_mapping_tpu/ops/raycast.py:96-110"),
            "carve": ("csrc/carve.cu", "gie_mapping_tpu/ops/pallas/carve.py:89"),
            "envelope": ("csrc/envelope.cu",
                         "gie_mapping_tpu/ops/pallas/envelope.py:759"),
            "shift_canvas": ("csrc/shift.cu",
                             "gie_mapping_tpu/ops/pallas/blockrows.py:326"),
            "gather_block_rows": ("csrc/blockrows.cu",
                                  "gie_mapping_tpu/ops/pallas/blockrows.py:59"),
            "scatter_block_rows": ("csrc/blockrows.cu",
                                   "gie_mapping_tpu/ops/pallas/blockrows.py:101"),
            "gather_archive_rows": ("csrc/blockrows.cu",
                                    "gie_mapping_tpu/ops/pallas/blockrows.py:179"),
            "scatter_archive_rows": ("csrc/blockrows.cu",
                                     "gie_mapping_tpu/ops/pallas/blockrows.py:230"),
        }
        emit({"kernels": [
            {"name": k, "route": "cuda", "source": "gie_mapping_tpu_torch/" + src,
             "replaces": rep, "launches": launches[k],
             **results[k]} for k, (src, rep) in meta.items()]})
        emit({"phase": "done", "seconds": round(time.time() - t0, 3)})
    except PhaseError as exc:
        emit({"ok": False, "error": str(exc)})
        return 1
    finally:
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke.jsonl"), "w") as f:
                f.write("\n".join(LOG) + "\n")
            log = _build.library_path().with_suffix(".log")
            if log.exists():
                with open(os.path.join(args.out, "nvcc_build.log"), "w") as f:
                    f.write(log.read_text())
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
