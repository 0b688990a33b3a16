"""Write the JAX package's results on the paths that chip_smoke.py drives
through the PyTorch port on a GPU (the machine with the GPU has no JAX, so
these files are the port's only link to the reference there):

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_port_ref.py \
        [--only slice|scroll|scan2d|flat|replay|depthcam|laser3d|dda|cli|mesh|
                scenarios|entry]

tests/fixtures/torch_port_cow_ref.npz, the slice
(gie_mapping_tpu_torch.runtime.datasets.cow_lady_slice: cow_lady preset,
131072 points per frame, streaming off, 12 poses), in about a minute on the
CPU.  The script asserts the two properties the slice relies on: the
canvas never moves after frame 0, and the frames take both a gated slab
branch and the full EDT branch.  Per frame the file holds the canvas
origin, the gate level, the count of each voxel type in the window output,
the sum of valid dist_sq, the number of changed blocks and a sha256 of the
window outputs; plus a sha256 of the final state (every MapState field).

tests/fixtures/torch_port_cow_scroll_ref.npz, the scroll path
(datasets.cow_lady_scroll: the cow_lady preset at its own defaults,
streaming on, 26 poses that scroll in x both ways, in z and by a teleport
beyond the canvas and back), in a few minutes.  Per frame it adds whether
the canvas scrolled, the exiting and re-entering block counts, n_arch and
the streaming leftover (block-columns); at the end the state sha256 and
the digest of the host mirror after flush_stream (sorted keys, every
field).  It asserts: at least 6 scrolls, one with both exits and archive
re-entries, one in z, one teleport of at least the canvas, no archive drop,
both gate branches, and a nonzero streaming leftover.

tests/fixtures/torch_port_scan2d_ref.npz and torch_port_scan2d_flat_ref.npz,
the two 2-D LiDAR paths (datasets.scan2d_world, the Hokuyo geometry of
datasets.hokuyo_scan, the sensor 1 m up): `scan2d`, the scan2D preset at
its own defaults over datasets.scan2d_path (16 poses), and `flat`, the
preset with a one-voxel-deep window on the relax engine over
datasets.scan2d_flat_path (10 poses), in about a minute each.  Per frame
they hold the canvas origin, whether the canvas scrolled, the gate level,
relax_iters, the voxel type counts, the sum of valid dist_sq and the sha256
of the window outputs; then the final state sha256.  The script asserts:
for scan2d at least 3 scrolls and gate levels that include a slab level and
the full level; for flat relax_iters > 0 on every frame and a scroll; for
both, occupied voxels on every frame after the first and no archive drop.

tests/fixtures/torch_port_replay_ref.npz, the replay mapper
(process_pointcloud_batch), in about ten minutes.  `bench_*`: bench.py's
own run (datasets.cow_lady_bench: fuse_raycast on, 3 frames through
process_pointcloud, then the 40-frame closed circle in one call with
chunk 40); `scroll_*`: the scroll path's 26 poses with fuse_raycast on,
streaming on, in one call with chunk 10.  Each holds the sha256 of the
final state, of the last FrameOutput's window outputs and of its
cost_map_msg payload8, every run's per_frame scalars and length, map_ct, the
canvas origin and the replay counters (scanned frames and scrolls); the
bench part also the window-output sha256 of its 3 online frames, the
scroll part the host mirror's digest after flush_stream.  The script
asserts: the bench batch runs as one scanned run of 40 frames; the scroll
replay scans runs with scrolls, falls back around the teleport, and drops
nothing from the archive.

tests/fixtures/torch_port_depthcam_ref.npz and torch_port_laser3d_ref.npz,
the two projection sensors at bench_suite.py's settings
(datasets.depthcam_bench: the depthcam preset with streaming off, 96 x 128
depth images; datasets.laser3d_bench: the laser3D preset at its own
defaults, streaming on, 16 x 360 ring images), each 2 frames through
process_depth / process_multiscan, then the closed 40-pose circle in one
batch call with chunk 40.  Each holds the window-output sha256, origin and
gate level of the 2 online frames and, under `batch_`, what the replay
part holds (state, last outputs, payload8, counters, every run's
per_frame); laser3d also the host mirror's digest; both the final state
and last outputs of the same frames one by one on a fresh mapper
(`loop_state_sha`, `loop_out_sha`: the per-frame program rounds the
sensor's height offset unlike the replay's scan, so at depthcam's pose 22
the two end apart).  The script asserts
that the batch scrolls inside a run and drops nothing from the archive.
tests/fixtures/torch_port_dda_ref.npz, the DDA path (datasets.dda_path:
the uav_raycast_fine preset with raycast_mode "dda", streaming on, 16384
points, 12 frames through process_pointcloud): per frame the canvas
origin, whether it scrolled, the gate level, the voxel type counts and
the window-output sha256; the final state sha256, map_ct and the host
mirror's digest.  It asserts a scroll and no archive drop.  depthcam takes
about ten minutes on the CPU, the other two a few.

tests/fixtures/torch_port_cli_ref.npz, chip_smoke.py's cli phase
(run_cli): the committed bags' converted frames, every preset through the
JAX package's CLI at chip_smoke's argv (four frames, a checkpoint, a CSV;
cow_lady again with --batch 4, scan2D again with --profile), a resume
from a checkpoint, the raw ring-cloud channel at the laser3D preset and
the external-observer channel in the fence-churn scenario at the
cow_lady preset's width.

tests/fixtures/torch_port_mesh_ref.npz, chip_smoke.py's mesh phase: the
JAX package's mesh path (parallel.mesh.make_mesh(4) over four virtual CPU
devices; the canvas EDT through batch_edt_sharded / _slab), in about two
minutes on the CPU.  `slice_*`: the cow-lady slice (as torch_port_cow_ref:
warmup, 12 frames through process_pointcloud), per frame the canvas origin,
the gate level and the window-output sha256, then the final state sha256.
`bench_*`: bench.py's replay (as torch_port_replay_ref's bench part: 3
frames through process_pointcloud, then the 40-frame circle in one call
with chunk 40): the 3 online frames' window-output sha256 and gate levels,
then what the replay fixture holds for it (state, last outputs, payload8,
counters, every run's per_frame).  `scroll_*`: the scroll path (as
torch_port_cow_scroll_ref: the preset's defaults, streaming on, x, z and
teleport scrolls), what that fixture holds for it.  The script asserts that
the slice takes a y-slab level and the full level, that the replay runs its
40 frames as one run with scrolls, and the scroll path's own properties.

tests/fixtures/torch_port_scenarios_ref.npz, chip_smoke.py's scenarios
phase: the JAX package's scenario tests that carry state through frames
(tests/test_torch_scenario_cases.py's CHIP: world extent out and back at
+40,000 voxels, the streamed mirror there, a true 2-D map on both
engines, an empty frame, fence box 0 inactive, archive exhaustion warned
and strict, a stream stall, the relax sweep cap, fast-mode staleness on
both engines, an archived block stale until re-entry, the adversarial
horizon on both engines, the stream soak with the gate on) at their test
sizes, each as test_torch_scenario_cases.digest gives it under
`<name>/<key>` (every frame's output sha256, origins, capacity report,
warning texts, a strict mapper's error text, state sha256, mirror
digest); and `cow_far/...`, the cow_lady preset at its own defaults
(131,072 points a frame, streaming on) over 3 frames near the origin, 3
at x = +40,000 voxels and 2 back (cow_far_frames), with the mirror's
largest global x coc.  It asserts the scenarios' own properties (the
warnings fire where they must, nothing drops where nothing may, the far
run archives and re-enters and its mirror holds global cocs past
32,767).  About three minutes on the CPU.

tests/fixtures/torch_port_entry_ref.npz, the driver's entry points (the
root __graft_entry__.py, ported as gie_mapping_tpu_torch/graft_entry.py):
`entry/...`, entry() jitted as the file's __main__ runs it (the cow_lady
preset at full width): the input digests of _frame_inputs, the state and
window-output digests, and every output's shape, its value (scalars) or
its sha256 (arrays); `dry{n}/...` for n = 2, 4 and 8 over ENTRY_DEVICES
virtual CPU devices, dryrun_multichip(n) with the JAX pipeline's
merge_frame and replay_frames recording every call (graft_entry.call_record:
state, window outputs, changed blocks, gate level, relax sweeps, the
replay's per_frame) and the printed line with its numbers.  Digests and
scalars only; a few minutes on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_port_cow_ref.npz")
OUT_SCROLL = os.path.join(HERE, "torch_port_cow_scroll_ref.npz")
OUT_SCAN2D = os.path.join(HERE, "torch_port_scan2d_ref.npz")
OUT_FLAT = os.path.join(HERE, "torch_port_scan2d_flat_ref.npz")
OUT_REPLAY = os.path.join(HERE, "torch_port_replay_ref.npz")
OUT_DEPTHCAM = os.path.join(HERE, "torch_port_depthcam_ref.npz")
OUT_LASER3D = os.path.join(HERE, "torch_port_laser3d_ref.npz")
OUT_DDA = os.path.join(HERE, "torch_port_dda_ref.npz")
OUT_CLI = os.path.join(HERE, "torch_port_cli_ref.npz")
OUT_MESH = os.path.join(HERE, "torch_port_mesh_ref.npz")
OUT_SCENARIOS = os.path.join(HERE, "torch_port_scenarios_ref.npz")
OUT_ENTRY = os.path.join(HERE, "torch_port_entry_ref.npz")
MESH_DEVICES = 4  # the mesh phase's mesh (virtual CPU devices here)
ENTRY_DEVICES = 8  # the dry runs' virtual CPU devices (the largest mesh)
DRYRUN_SIZES = (2, 4, 8)
SCROLL_CHUNK = 10  # the scroll path's replay: frames per scanned run
# the true 2-D map: the scan2D preset with a one-voxel-deep window on the
# relax engine
FLAT = dict(local_size_m=(10.0, 10.0, 0.1), merge_mode="relax")


def _state(mapper):
    return {f.name: np.asarray(getattr(mapper.state, f.name))
            for f in dataclasses.fields(mapper.state)}


def run(path, overrides, world, poses, scroll, mesh=None):
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.models.pipeline import _slab_menu
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils.config import cow_lady_config
    from gie_mapping_tpu_torch.map_state import (np_scroll_counts,
                                                 output_digest, state_digest)
    from gie_mapping_tpu_torch.runtime.datasets import COW_SLICE_RAYS
    from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest

    cfg = cow_lady_config(**overrides)
    n_menu = len(_slab_menu(cfg.canvas_size))
    mapper = VolumetricMapper(cfg, mesh=mesh)
    mapper.warmup(robot_pos=poses[0][0])
    keys = ["origin", "gate_level", "type_counts", "dist_sum",
            "changed_blocks", "out_sha"]
    if scroll:
        keys += ["scrolled", "exits", "enters", "n_arch", "leftover"]
    rec = {k: [] for k in keys}
    for i, (pos, quat) in enumerate(poses):
        t0 = time.time()
        before = None if mapper._origin is None else mapper._origin.copy()
        present = np.asarray(mapper.state.present)
        proj = geo.Projection.from_pose(pos, quat)
        pts = world.pointcloud(proj, n_rays=COW_SLICE_RAYS, max_range=8.0,
                               seed=i)
        out = mapper.process_pointcloud(proj, pts).fetch()
        d = np.asarray(out.dist_sq)
        rec["origin"].append(np.asarray(mapper._origin, np.int32))
        rec["gate_level"].append(int(out.gate_level))
        rec["type_counts"].append(np.bincount(
            np.asarray(out.glb_type, np.int64).ravel(), minlength=4)[:4])
        rec["dist_sum"].append(int(d[d != 999_999].astype(np.int64).sum()))
        rec["changed_blocks"].append(
            int(np.asarray(out.device("changed_blk")).sum()))
        rec["out_sha"].append(output_digest(out.glb_type, out.dist_sq, out.coc))
        msg = ""
        if scroll:
            scrolled = before is None or not np.array_equal(before, mapper._origin)
            old = np.zeros(3, np.int64) if before is None else before
            st = _state(mapper)
            ex, en = np_scroll_counts(present, mapper._origin - old,
                                      st["arch_keys"], st["n_arch"],
                                      mapper._origin) if scrolled else (0, 0)
            rec["scrolled"].append(scrolled)
            rec["exits"].append(ex)
            rec["enters"].append(en)
            rec["n_arch"].append(int(st["n_arch"]))
            rec["leftover"].append(int(np.asarray(mapper._stream_pending[5])))
            msg = (f" scrolled {scrolled} exits {ex} enters {en} n_arch "
                   f"{rec['n_arch'][-1]} leftover {rec['leftover'][-1]}")
        print(f"frame {i}: gate {out.gate_level} types "
              f"{rec['type_counts'][-1].tolist()} origin "
              f"{rec['origin'][-1].tolist()}{msg} ({time.time() - t0:.1f} s)",
              flush=True)
    origins = np.stack(rec["origin"])
    levels = np.asarray(rec["gate_level"])
    assert (levels < n_menu).any() and (levels == n_menu).any(), levels
    arrays = dict(
        origin=origins, gate_level=levels,
        type_counts=np.stack(rec["type_counts"]).astype(np.int64),
        dist_sum=np.asarray(rec["dist_sum"], np.int64),
        changed_blocks=np.asarray(rec["changed_blocks"], np.int64),
        out_sha=np.asarray(rec["out_sha"]),
        state_sha=np.asarray(state_digest(_state(mapper))),
        n_rays=np.asarray(COW_SLICE_RAYS))
    if not scroll:
        assert (origins == origins[0]).all(), "the canvas moved after frame 0"
    else:
        mapper.flush_stream()
        mapper.check_capacity()
        scrolled = np.asarray(rec["scrolled"])
        exits, enters = np.asarray(rec["exits"]), np.asarray(rec["enters"])
        shifts = np.abs(np.diff(origins, axis=0))
        assert scrolled[1:].sum() >= 6, scrolled
        assert ((exits > 0) & (enters > 0)).any(), (exits, enters)
        assert (shifts[:, 2] > 0).any(), shifts
        assert (shifts >= np.asarray(cfg.canvas_blocks)).any(), shifts
        assert mapper.capacity_report()["arch_dropped"] == 0
        assert max(rec["leftover"]) > 0
        for k in ("scrolled", "exits", "enters", "n_arch", "leftover"):
            arrays[k] = np.asarray(rec[k], bool if k == "scrolled" else np.int64)
        arrays["mirror_sha"] = np.asarray(mirror_digest(mapper.mirror.blocks))
        arrays["mirror_blocks"] = np.asarray(len(mapper.mirror))
        print("capacity:", mapper.capacity_report(), "mirror blocks:",
              len(mapper.mirror))
    if path is None:
        return arrays
    np.savez_compressed(path, **arrays)
    print("written:", path, os.path.getsize(path), "bytes")


def run_scan(path, overrides, poses, flat):
    """The JAX mapper's process_scan2d over `poses` (scan2D preset with
    `overrides`); writes `path`."""
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.models.pipeline import _slab_menu
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils.config import scan2d_config
    from gie_mapping_tpu_torch.map_state import output_digest, state_digest
    from gie_mapping_tpu_torch.runtime.datasets import (hokuyo_scan,
                                                        scan2d_world)

    cfg = scan2d_config(**overrides)
    world = scan2d_world()
    mapper = VolumetricMapper(cfg)
    mapper.warmup(robot_pos=poses[0][0])
    keys = ["origin", "scrolled", "gate_level", "relax_iters", "type_counts",
            "dist_sum", "out_sha"]
    rec = {k: [] for k in keys}
    for i, pose in enumerate(poses):
        t0 = time.time()
        before = None if mapper._origin is None else mapper._origin.copy()
        ranges, tmin, tinc = hokuyo_scan(world, pose)
        out = mapper.process_scan2d(geo.Projection.from_pose(*pose), ranges,
                                    tmin, tinc).fetch()
        d = np.asarray(out.dist_sq)
        rec["origin"].append(np.asarray(mapper._origin, np.int32))
        rec["scrolled"].append(before is None
                               or not np.array_equal(before, mapper._origin))
        rec["gate_level"].append(int(out.gate_level))
        rec["relax_iters"].append(int(out.relax_iters))
        rec["type_counts"].append(np.bincount(
            np.asarray(out.glb_type, np.int64).ravel(), minlength=4)[:4])
        rec["dist_sum"].append(int(d[d != 999_999].astype(np.int64).sum()))
        rec["out_sha"].append(output_digest(out.glb_type, out.dist_sq, out.coc))
        print(f"frame {i}: origin {rec['origin'][-1].tolist()} scrolled "
              f"{rec['scrolled'][-1]} gate {out.gate_level} relax_iters "
              f"{out.relax_iters} types {rec['type_counts'][-1].tolist()} "
              f"({time.time() - t0:.1f} s)", flush=True)
    mapper.check_capacity()
    types = np.stack(rec["type_counts"]).astype(np.int64)
    scrolled = np.asarray(rec["scrolled"], bool)
    levels = np.asarray(rec["gate_level"])
    iters = np.asarray(rec["relax_iters"])
    assert (types[1:, 2] > 0).all(), types
    assert mapper.capacity_report()["arch_dropped"] == 0
    if flat:
        assert cfg.is_2d and (iters > 0).all(), iters
        assert scrolled[1:].sum() >= 1, scrolled
    else:
        n_menu = len(_slab_menu(cfg.canvas_size))
        assert scrolled[1:].sum() >= 3, scrolled
        assert (levels < n_menu).any() and (levels == n_menu).any(), levels
    np.savez_compressed(
        path, origin=np.stack(rec["origin"]), scrolled=scrolled,
        gate_level=levels, relax_iters=iters, type_counts=types,
        dist_sum=np.asarray(rec["dist_sum"], np.int64),
        out_sha=np.asarray(rec["out_sha"]),
        state_sha=np.asarray(state_digest(_state(mapper))))
    print("written:", path, os.path.getsize(path), "bytes")


def _last(prefix, mapper, out, cfg, runs):
    """The replay's end under `prefix`: state, last FrameOutput, counters,
    and `runs`, the per_frame scalars of every run (concatenated, with the
    run lengths)."""
    import hashlib

    from gie_mapping_tpu_torch.map_state import output_digest, state_digest

    msg = out.cost_map_msg(cfg.voxel_width)
    rec = {
        "state_sha": state_digest(_state(mapper)),
        "out_sha": output_digest(out.glb_type, out.dist_sq, out.coc),
        "payload8_sha": hashlib.sha256(msg["payload8"]).hexdigest(),
        "map_ct": mapper.map_ct, "origin": np.asarray(mapper._origin, np.int32),
        "scanned_frames": mapper.replay_scanned_frames,
        "scanned_scrolls": mapper.replay_scanned_scrolls,
        "run_lengths": [len(r["gate_level"]) for r in runs]}
    for k in runs[0]:
        rec["pf_" + k] = np.concatenate([np.asarray(r[k]) for r in runs])
    print(prefix, {k: (v if np.ndim(v) == 0 else np.asarray(v).tolist())
                   for k, v in rec.items()}, flush=True)
    return {f"{prefix}_{k}": np.asarray(v) for k, v in rec.items()}


def _recording_runs():
    """Make the JAX pipeline's replay_frames append each run's per_frame
    (as numpy) to the returned list."""
    from gie_mapping_tpu.models import pipeline

    runs, orig = [], pipeline.replay_frames

    def recorded(*args, **kw):
        res = orig(*args, **kw)
        runs.append({k: np.asarray(v) for k, v in res[3].items()})
        return res

    pipeline.replay_frames = recorded
    return runs


def run_replay(path):
    """bench.py's replay and the scroll path's replay through the JAX
    package's process_pointcloud_batch; writes `path`."""
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils.config import cow_lady_config
    from gie_mapping_tpu_torch.map_state import output_digest
    from gie_mapping_tpu_torch.runtime.datasets import (COW_SLICE_RAYS,
                                                        cow_lady_bench,
                                                        cow_lady_scroll)
    from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest

    t0 = time.time()
    runs = _recording_runs()
    overrides, world, poses, n_online, chunk = cow_lady_bench()
    projs = [geo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
             for p in poses]
    clouds = [world.pointcloud(p, n_rays=COW_SLICE_RAYS, max_range=8.0, seed=i)
              for i, p in enumerate(projs)]
    cfg = cow_lady_config(**overrides)
    mapper = VolumetricMapper(cfg)
    pts, val = mapper.stage_pointcloud_batch(clouds)
    online = []
    for i in range(n_online):
        out = mapper.process_pointcloud(projs[i], pts[i], val[i]).fetch()
        online.append(output_digest(out.glb_type, out.dist_sq, out.coc))
    out = mapper.process_pointcloud_batch(
        projs[n_online:], pts[n_online:], val[n_online:], chunk=chunk).fetch()
    arrays = _last("bench", mapper, out, cfg, runs)
    arrays["bench_online_out_sha"] = np.asarray(online)
    assert mapper.replay_scanned_frames == len(projs) - n_online == chunk
    assert mapper.capacity_report()["arch_dropped"] == 0
    print(f"bench replay: {time.time() - t0:.1f} s", flush=True)

    overrides, world, poses = cow_lady_scroll()
    cfg = cow_lady_config(**overrides, fuse_raycast=True)
    projs = [geo.Projection.from_pose(*p) for p in poses]
    clouds = [world.pointcloud(p, n_rays=COW_SLICE_RAYS, max_range=8.0, seed=i)
              for i, p in enumerate(projs)]
    mapper = VolumetricMapper(cfg)
    pts, val = mapper.stage_pointcloud_batch(clouds)
    runs.clear()
    out = mapper.process_pointcloud_batch(projs, pts, val,
                                          chunk=SCROLL_CHUNK).fetch()
    mapper.flush_stream()
    mapper.check_capacity()
    arrays.update(_last("scroll", mapper, out, cfg, runs))
    arrays["scroll_mirror_sha"] = np.asarray(mirror_digest(mapper.mirror.blocks))
    assert mapper.replay_scanned_scrolls >= 3, mapper.replay_scanned_scrolls
    assert 0 < mapper.replay_scanned_frames < len(projs)
    assert mapper.capacity_report()["arch_dropped"] == 0
    np.savez_compressed(path, **arrays)
    print("written:", path, os.path.getsize(path), "bytes",
          f"({time.time() - t0:.1f} s)")


def run_sensor(path, kind):
    """A projection sensor's bench_suite.py run (2 online frames, then the
    40-frame circle in one batch call) through the JAX mapper; writes
    `path`."""
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils import config as jcfg
    from gie_mapping_tpu_torch.map_state import output_digest, state_digest
    from gie_mapping_tpu_torch.runtime import datasets as ds
    from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest

    t0 = time.time()
    runs = _recording_runs()
    runs.clear()
    if kind == "depth":
        overrides, world, poses, n_online, chunk = ds.depthcam_bench()
        cfg = jcfg.depthcam_config(**overrides)
        data, sc = ds.depth_frames(world, poses)
    else:
        overrides, world, poses, n_online, chunk = ds.laser3d_bench()
        cfg = jcfg.uav_laser3d_config(**overrides)
        data, sc = ds.ring_frames(world, poses)
    projs = [geo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
             for p in poses]
    mapper = VolumetricMapper(cfg)
    one = mapper.process_depth if kind == "depth" else mapper.process_multiscan
    batch = (mapper.process_depth_batch if kind == "depth"
             else mapper.process_multiscan_batch)
    online = {"out_sha": [], "origin": [], "gate_level": []}
    for i in range(n_online):
        out = one(projs[i], data[i], *sc).fetch()
        online["out_sha"].append(output_digest(out.glb_type, out.dist_sq,
                                               out.coc))
        online["origin"].append(np.asarray(mapper._origin, np.int32))
        online["gate_level"].append(int(out.gate_level))
        print(f"online frame {i}: gate {out.gate_level} origin "
              f"{mapper._origin.tolist()} ({time.time() - t0:.1f} s)",
              flush=True)
    out = batch(projs[n_online:], data[n_online:], *sc, chunk=chunk).fetch()
    if cfg.display_glb_edt or cfg.display_glb_ogm:
        mapper.flush_stream()
    mapper.check_capacity()
    arrays = _last("batch", mapper, out, cfg, runs)
    for k, v in online.items():
        arrays["online_" + k] = np.asarray(v)
    if mapper.mirror is not None:
        arrays["mirror_sha"] = np.asarray(mirror_digest(mapper.mirror.blocks))
        arrays["mirror_blocks"] = np.asarray(len(mapper.mirror))
    assert mapper.replay_scanned_scrolls >= 1, mapper.replay_scanned_scrolls
    assert mapper.capacity_report()["arch_dropped"] == 0
    # the same frames one by one on a fresh mapper: the per-frame program
    # rounds the sensor's height offset unlike the replay's scan program
    # (ROADMAP C), so the two may end apart
    loop = VolumetricMapper(cfg)
    one = loop.process_depth if kind == "depth" else loop.process_multiscan
    for i in range(len(projs)):
        lo = one(projs[i], data[i], *sc)
    lo = lo.fetch()
    if loop.mirror is not None:
        loop.flush_stream()
    arrays["loop_state_sha"] = np.asarray(state_digest(_state(loop)))
    arrays["loop_out_sha"] = np.asarray(output_digest(lo.glb_type, lo.dist_sq,
                                                      lo.coc))
    print("frame loop equals the replay:",
          str(arrays["loop_state_sha"]) == str(arrays["batch_state_sha"]),
          f"({time.time() - t0:.1f} s)", flush=True)
    np.savez_compressed(path, **arrays)
    print("written:", path, os.path.getsize(path), "bytes",
          f"({time.time() - t0:.1f} s)")


def run_dda(path):
    """The DDA path through the JAX mapper's process_pointcloud; writes
    `path`."""
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils.config import uav_laser3d_fine_config
    from gie_mapping_tpu_torch.map_state import output_digest, state_digest
    from gie_mapping_tpu_torch.runtime.datasets import SUITE_RAYS, dda_path
    from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest

    t0 = time.time()
    overrides, world, poses = dda_path()
    cfg = uav_laser3d_fine_config(**overrides)
    mapper = VolumetricMapper(cfg)
    rec = {k: [] for k in ("origin", "scrolled", "gate_level", "type_counts",
                           "out_sha")}
    for i, p in enumerate(poses):
        proj = geo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
        pts = world.pointcloud(p, n_rays=SUITE_RAYS, max_range=8.0, seed=i)
        before = None if mapper._origin is None else mapper._origin.copy()
        out = mapper.process_pointcloud(proj, pts).fetch()
        rec["origin"].append(np.asarray(mapper._origin, np.int32))
        rec["scrolled"].append(before is None
                               or not np.array_equal(before, mapper._origin))
        rec["gate_level"].append(int(out.gate_level))
        rec["type_counts"].append(np.bincount(
            np.asarray(out.glb_type, np.int64).ravel(), minlength=4)[:4])
        rec["out_sha"].append(output_digest(out.glb_type, out.dist_sq, out.coc))
        print(f"frame {i}: origin {rec['origin'][-1].tolist()} types "
              f"{rec['type_counts'][-1].tolist()} ({time.time() - t0:.1f} s)",
              flush=True)
    mapper.flush_stream()
    mapper.check_capacity()
    scrolled = np.asarray(rec["scrolled"], bool)
    assert scrolled[1:].sum() >= 1, scrolled
    assert mapper.capacity_report()["arch_dropped"] == 0
    np.savez_compressed(
        path, origin=np.stack(rec["origin"]), scrolled=scrolled,
        gate_level=np.asarray(rec["gate_level"]),
        type_counts=np.stack(rec["type_counts"]).astype(np.int64),
        out_sha=np.asarray(rec["out_sha"]),
        state_sha=np.asarray(state_digest(_state(mapper))),
        map_ct=np.asarray(mapper.map_ct),
        mirror_sha=np.asarray(mirror_digest(mapper.mirror.blocks)),
        mirror_blocks=np.asarray(len(mapper.mirror)))
    print("written:", path, os.path.getsize(path), "bytes",
          f"({time.time() - t0:.1f} s)")


def run_mesh(path):
    """The cow-lady slice and bench.py's replay through the JAX mapper over
    a MESH_DEVICES-device mesh; writes `path`."""
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.models.pipeline import _slab_menu
    from gie_mapping_tpu.parallel.mesh import make_mesh
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils.config import cow_lady_config
    from gie_mapping_tpu_torch.map_state import output_digest, state_digest
    from gie_mapping_tpu_torch.runtime.datasets import (COW_SLICE_RAYS,
                                                        cow_lady_bench,
                                                        cow_lady_slice)

    t0 = time.time()
    mesh = make_mesh(MESH_DEVICES)
    assert mesh.size == MESH_DEVICES, mesh
    overrides, world, poses = cow_lady_slice()
    cfg = cow_lady_config(**overrides)
    mapper = VolumetricMapper(cfg, mesh=mesh)
    mapper.warmup(robot_pos=poses[0][0])
    rec = {k: [] for k in ("origin", "gate_level", "out_sha")}
    for i, (pos, quat) in enumerate(poses):
        proj = geo.Projection.from_pose(pos, quat)
        pts = world.pointcloud(proj, n_rays=COW_SLICE_RAYS, max_range=8.0,
                               seed=i)
        out = mapper.process_pointcloud(proj, pts).fetch()
        rec["origin"].append(np.asarray(mapper._origin, np.int32))
        rec["gate_level"].append(int(out.gate_level))
        rec["out_sha"].append(output_digest(out.glb_type, out.dist_sq, out.coc))
        print(f"slice frame {i}: gate {out.gate_level} "
              f"({time.time() - t0:.1f} s)", flush=True)
    levels = np.asarray(rec["gate_level"])
    n_menu = len(_slab_menu(cfg.canvas_size))
    assert (levels < n_menu).any() and (levels == n_menu).any(), levels
    arrays = {"slice_origin": np.stack(rec["origin"]),
              "slice_gate_level": levels,
              "slice_out_sha": np.asarray(rec["out_sha"]),
              "slice_state_sha": np.asarray(state_digest(_state(mapper))),
              "devices": np.asarray(MESH_DEVICES)}

    runs = _recording_runs()
    overrides, world, poses, n_online, chunk = cow_lady_bench()
    projs = [geo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
             for p in poses]
    clouds = [world.pointcloud(p, n_rays=COW_SLICE_RAYS, max_range=8.0, seed=i)
              for i, p in enumerate(projs)]
    cfg = cow_lady_config(**overrides)
    mapper = VolumetricMapper(cfg, mesh=mesh)
    pts, val = mapper.stage_pointcloud_batch(clouds)
    online, online_levels = [], []
    for i in range(n_online):
        out = mapper.process_pointcloud(projs[i], pts[i], val[i]).fetch()
        online.append(output_digest(out.glb_type, out.dist_sq, out.coc))
        online_levels.append(int(out.gate_level))
    out = mapper.process_pointcloud_batch(
        projs[n_online:], pts[n_online:], val[n_online:], chunk=chunk).fetch()
    arrays.update(_last("bench", mapper, out, cfg, runs))
    arrays["bench_online_out_sha"] = np.asarray(online)
    arrays["bench_online_gate_level"] = np.asarray(online_levels)
    assert mapper.replay_scanned_frames == len(projs) - n_online == chunk
    assert mapper.replay_scanned_scrolls > 0
    assert mapper.capacity_report()["arch_dropped"] == 0

    # the scroll path (as torch_port_cow_scroll_ref: streaming on; x, z and
    # teleport scrolls) over the mesh
    from gie_mapping_tpu_torch.runtime.datasets import cow_lady_scroll

    scroll = run(None, *cow_lady_scroll(), scroll=True, mesh=mesh)
    arrays.update({f"scroll_{k}": v for k, v in scroll.items()})
    np.savez_compressed(path, **arrays)
    print("written:", path, os.path.getsize(path), "bytes",
          f"({time.time() - t0:.1f} s)")


def _jax_cli():
    """The JAX package's CLI module, with the persistent compilation cache
    it turns on at import turned off again (nothing is written outside the
    checkout)."""
    import jax

    import gie_mapping_tpu.cli as jcli

    jax.config.update("jax_compilation_cache_dir", None)
    return jcli


def _jax_dispatch(mapper, proj, kind, payload):
    if kind == "pointcloud":
        return mapper.process_pointcloud(proj, payload)
    return {"scan": mapper.process_scan2d, "depth": mapper.process_depth,
            "multiscan": mapper.process_multiscan}[kind](proj, *payload)


def run_cli(path):
    """chip_smoke.py's cli phase through the JAX package; writes `path`:

    bag/<bag>/<i>/<field>: the committed bags' frames (bag_to_frames);
    cli/<tag>/<count>, cli/<tag>/sha/<key>, cli/<tag>/csv_rows and, for the
    profiled run, cli/<tag>/rmse: each run of chip_smoke.CLI_RUNS through
    gie_mapping_tpu.cli.main at the same argv (plus --cpu): the summary's
    counts, the sha256 of each checkpoint array, the CSV's row count and
    RMSE column;
    resume/*: cow_lady's synthetic_frames(cfg, 6) uninterrupted and with a
    save after frame 3 and a load into a fresh mapper (per-frame window
    output sha256 of frames 4-5, the final state sha256);
    multiscan/*: datasets.multiscan_cloud_path through
    process_multiscan_cloud at the laser3D preset (each frame's ring
    image, output sha256 and origin; the final state and mirror);
    ext/*: datasets.ext_churn_path through the per-frame loop, the ext cloud
    given before frame `split` (each frame's output sha256, the final state
    sha256, the box count)."""
    import contextlib
    import io
    import tempfile

    import jax

    import chip_smoke as cs
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.runtime import rosbag as jrosbag
    from gie_mapping_tpu.runtime.rings import cloud_to_rings
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils import config as jcfg
    from gie_mapping_tpu_torch.map_state import output_digest, state_digest
    from gie_mapping_tpu_torch.runtime import datasets as ds
    from gie_mapping_tpu_torch.runtime.host_mirror import mirror_digest

    t0 = time.time()
    arrays = {}
    for name, sensor, odom in cs.BAGS:
        got = cs.bag_frames(jrosbag, os.path.join(HERE, name), sensor, odom)
        assert got, name
        for k, v in got.items():
            arrays[f"bag/{name}/{k}"] = v
    jcli = _jax_cli()
    for tag, case, extra in cs.CLI_RUNS:
        with tempfile.TemporaryDirectory() as d:
            argv = cs.cli_argv(case, extra, d)
            buf = io.StringIO()
            old = sys.argv
            sys.argv = ["gie-tpu-run", *argv, "--cpu"]
            try:
                with contextlib.redirect_stdout(buf):
                    jcli.main()
            finally:
                sys.argv = old
            summary = json.loads(buf.getvalue().strip().splitlines()[-1])
            for k in cs.CLI_COUNTS:
                arrays[f"cli/{tag}/{k}"] = np.asarray(summary[k])
            for k, v in cs.checkpoint_digests(argv[argv.index("--save") + 1]).items():
                arrays[f"cli/{tag}/sha/{k}"] = np.asarray(v)
            rows = cs.csv_rows(argv[argv.index("--log") + 1])
            arrays[f"cli/{tag}/csv_rows"] = np.asarray(len(rows))
            if "--profile" in extra:
                arrays[f"cli/{tag}/rmse"] = np.asarray([r[2] for r in rows])
                assert any(float(r[2]) >= 0 for r in rows), rows
            assert summary["frames"] == len(rows) == cs.CLI_FRAMES, summary
            print(f"cli {tag}: {summary} ({time.time() - t0:.1f} s)", flush=True)

    # resume: save after RESUME_SPLIT frames, load into a fresh mapper
    cfg = jcfg.cow_lady_config()
    frames = list(jcli.synthetic_frames(cfg, cs.RESUME_FRAMES))
    full = VolumetricMapper(cfg)
    full_sha = []
    for proj, (kind, payload) in frames:
        out = _jax_dispatch(full, proj, kind, payload).fetch()
        full_sha.append(output_digest(out.glb_type, out.dist_sq, out.coc))
    full.flush_stream()
    first = VolumetricMapper(cfg)
    for proj, (kind, payload) in frames[:cs.RESUME_SPLIT]:
        _jax_dispatch(first, proj, kind, payload)
    resumed_sha = []
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "map.npz")
        first.save(ckpt)
        arrays["resume/ckpt_sha"] = np.asarray(
            sorted(cs.checkpoint_digests(ckpt).items()))
        second = VolumetricMapper(cfg).load(ckpt)
    for proj, (kind, payload) in frames[cs.RESUME_SPLIT:]:
        out = _jax_dispatch(second, proj, kind, payload).fetch()
        resumed_sha.append(output_digest(out.glb_type, out.dist_sq, out.coc))
    arrays["resume/full_out_sha"] = np.asarray(full_sha)
    arrays["resume/full_state_sha"] = np.asarray(state_digest(_state(full)))
    arrays["resume/out_sha"] = np.asarray(resumed_sha)
    arrays["resume/state_sha"] = np.asarray(state_digest(_state(second)))
    arrays["resume/map_ct"] = np.asarray(second.map_ct)
    print(f"resume: outputs equal to the uninterrupted run: "
          f"{resumed_sha == full_sha[cs.RESUME_SPLIT:]}, state: "
          f"{arrays['resume/state_sha'] == arrays['resume/full_state_sha']} "
          f"({time.time() - t0:.1f} s)", flush=True)

    # the raw ring cloud at the laser3D preset
    cfg = jcfg.uav_laser3d_config()
    world, poses = ds.multiscan_cloud_path()
    m = VolumetricMapper(cfg)
    rec = {"rings": [], "out_sha": [], "origin": []}
    for p in poses:
        proj = geo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
        pts, ring, pmin, pinc = ds.ring_cloud(world, p)
        rec["rings"].append(cloud_to_rings(pts, ring)[0])
        out = m.process_multiscan_cloud(proj, pts, ring, phi_min=pmin,
                                        phi_inc=pinc).fetch()
        rec["out_sha"].append(output_digest(out.glb_type, out.dist_sq, out.coc))
        rec["origin"].append(np.asarray(m._origin, np.int32))
    m.flush_stream()
    for k, v in rec.items():
        arrays[f"multiscan/{k}"] = np.asarray(v)
    arrays["multiscan/state_sha"] = np.asarray(state_digest(_state(m)))
    arrays["multiscan/mirror_sha"] = np.asarray(mirror_digest(m.mirror.blocks))
    print(f"multiscan cloud: {len(poses)} frames ({time.time() - t0:.1f} s)",
          flush=True)

    # the fence churn with an ext cloud, per frame (the reference for both
    # of the port's forms: its replay and its frame loop)
    overrides, world, poses, boxes, ext_cloud, split, _ = ds.ext_churn_path()
    cfg = jcfg.cow_lady_config(**overrides)
    m = VolumetricMapper(cfg)
    for ll, ur in boxes:
        m.ext_obs.append(ll, ur)
    sha, sigs = [], []
    for i, p in enumerate(poses):
        if i == split:
            # the JAX mapper's cached fence arrays may alias ext_obs's
            # buffers, which process_ext_cloud rewrites in place: let the
            # frames in flight finish first (ROADMAP C)
            jax.block_until_ready(m.state)
            n_boxes = m.process_ext_cloud(ext_cloud)
        proj = geo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
        pts = world.pointcloud(p, n_rays=ds.EXT_CHURN_RAYS, max_range=8.0,
                               seed=i)
        pvt = geo.calculate_pivot(np.asarray(proj.trans), cfg.voxel_width,
                                  cfg.local_size)
        sigs.append(m._fence_args(pvt)[1])
        out = m.process_pointcloud(proj, pts).fetch()
        sha.append(output_digest(out.glb_type, out.dist_sq, out.coc))
    assert n_boxes == 2, n_boxes
    arrays["ext/out_sha"] = np.asarray(sha)
    arrays["ext/state_sha"] = np.asarray(state_digest(_state(m)))
    arrays["ext/n_boxes"] = np.asarray(n_boxes)
    arrays["ext/fence_on"] = np.asarray(sigs)
    print(f"ext churn: fence on per frame {sigs} ({time.time() - t0:.1f} s)",
          flush=True)
    np.savez_compressed(path, **arrays)
    print("written:", path, os.path.getsize(path), "bytes",
          f"({time.time() - t0:.1f} s)")


def run_scenarios(path):
    """The scenarios of chip_smoke.py's scenarios phase through the JAX
    package; writes `path`."""
    sys.path.insert(0, os.path.join(HERE, ".."))
    import test_torch_scenario_cases as sc
    from test_torch_scenario_jax import jax_api

    t0 = time.time()
    api = jax_api()
    arrays = {}
    for name in sc.CHIP:
        _, m, rec = sc.run_chip(api, name)
        for k, v in sc.digest(rec).items():
            arrays[f"{name}/{k}"] = np.asarray(v)
        cap, warned = rec["capacity"], [t for _, t in rec["warnings"]]
        if name in ("archive_warn", "archive_strict"):
            assert cap["arch_dropped"] > 0 or rec["raised"], name
            assert (warned if name == "archive_warn" else [rec["raised"]]), name
        elif name == "stream_stall":
            assert cap["stream_stall_ticks"] >= 2 and warned, name
        elif name == "relax_cap":
            assert any("sweep cap" in t for t in warned), name
        else:
            assert not warned and rec["raised"] is None, (name, warned)
            if cap is not None:
                assert cap["arch_dropped"] == 0, name
        print(f"{name}: {len(rec['frames'])} frames, capacity {cap} "
              f"({time.time() - t0:.1f} s)", flush=True)
    cfg, m, rec = sc.cow_far(api)
    for k, v in sc.digest(rec).items():
        arrays[f"cow_far/{k}"] = np.asarray(v)
    far_x = sc.mirror_max_global_x(m.mirror)
    arrays["cow_far/mirror_max_x"] = np.asarray(far_x)
    arrays["cow_far/mirror_blocks"] = np.asarray(len(m.mirror))
    assert far_x > 32767, far_x
    assert rec["capacity"]["arch_dropped"] == 0 and rec["capacity"]["n_arch"] > 0
    assert not rec["warnings"], rec["warnings"]
    print(f"cow_far: origins {rec['origins']}, capacity {rec['capacity']}, "
          f"mirror {len(m.mirror)} blocks, max global x coc {far_x} "
          f"({time.time() - t0:.1f} s)", flush=True)
    np.savez_compressed(path, **arrays)
    print("written:", path, os.path.getsize(path), "bytes",
          f"({time.time() - t0:.1f} s)")


def _np_tree(d):
    return {k: np.asarray(v) for k, v in d.items()}


def run_entry(path):
    """The root __graft_entry__.py's entry() and dryrun_multichip(n); writes
    `path`."""
    import contextlib
    import io
    import re

    import jax

    import __graft_entry__ as ge

    # the file turns on a persistent compilation cache at import: off again
    # (nothing is written outside the checkout)
    jax.config.update("jax_compilation_cache_dir", None)
    from gie_mapping_tpu.models import pipeline
    from gie_mapping_tpu.utils.config import cow_lady_config
    from gie_mapping_tpu_torch.graft_entry import array_sha, call_record
    from gie_mapping_tpu_torch.map_state import output_digest, state_digest

    t0 = time.time()
    assert len(jax.devices()) == ENTRY_DEVICES, jax.devices()
    arrays = {}
    inst, cnt, pvt, origin_blk, off, ll, ur, act, n = (
        np.asarray(v) for v in ge._frame_inputs(cow_lady_config()))
    arrays.update({"entry/in/inst_sha": array_sha(inst),
                   "entry/in/ray_count_sha": array_sha(cnt),
                   "entry/in/pvt": pvt, "entry/in/origin_blk": origin_blk,
                   "entry/in/off": off, "entry/in/ll_sha": array_sha(ll),
                   "entry/in/ur_sha": array_sha(ur),
                   "entry/in/active_sha": array_sha(act), "entry/in/n": n})
    fn, args = ge.entry()
    st, out = jax.jit(fn)(*args)
    out = _np_tree(out)
    arrays["entry/state_sha"] = state_digest(_np_tree(
        {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}))
    arrays["entry/out_sha"] = output_digest(out["glb_type"], out["dist_sq"],
                                            out["coc"])
    for k, v in out.items():
        arrays[f"entry/shape/{k}"] = np.asarray(v.shape, np.int64)
        if v.ndim:
            arrays[f"entry/sha/{k}"] = array_sha(v)
        else:
            arrays[f"entry/value/{k}"] = v
    print("entry:", {k: v.shape for k, v in out.items()},
          f"gate_level {int(out['gate_level'])} ({time.time() - t0:.1f} s)",
          flush=True)

    orig = pipeline.merge_frame, pipeline.replay_frames
    for nd in DRYRUN_SIZES:
        calls = []

        def merge(*a, **kw):
            st, out = orig[0](*a, **kw)
            calls.append(call_record(
                _np_tree({f.name: getattr(st, f.name)
                          for f in dataclasses.fields(st)}),
                _np_tree(out), np.asarray(out["changed_blk"])))
            return st, out

        def replay(*a, **kw):
            st, out, union, per_frame = orig[1](*a, **kw)
            calls.append(call_record(
                _np_tree({f.name: getattr(st, f.name)
                          for f in dataclasses.fields(st)}),
                _np_tree(out), np.asarray(union), _np_tree(per_frame)))
            return st, out, union, per_frame

        pipeline.merge_frame, pipeline.replay_frames = merge, replay
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                ge.dryrun_multichip(nd)
        finally:
            pipeline.merge_frame, pipeline.replay_frames = orig
        line = buf.getvalue().strip()
        m = re.fullmatch(
            r"dryrun_multichip\((\d+)\): ok — relax_iters=(\d+), "
            r"present=(\d+), replay_frames=(\d+), scrolls=(\d+), "
            r"gate_levels=\[([\d, ]*)\], raise_dist (\S+)->(\S+)", line)
        assert m and int(m[1]) == nd, line
        pre = f"dry{nd}/"
        arrays.update({
            pre + "line": line, pre + "calls": len(calls),
            pre + "relax_iters": int(m[2]), pre + "present": int(m[3]),
            pre + "replay_frames": int(m[4]), pre + "scrolls": int(m[5]),
            pre + "gate_levels": np.asarray([int(g) for g in m[6].split(",")]),
            pre + "raise_probe": float(m[7]), pre + "raise_after": float(m[8])})
        for i, rec in enumerate(calls):
            arrays.update({f"{pre}{i}/{k}": np.asarray(v)
                           for k, v in rec.items()})
        print(line, f"{len(calls)} calls ({time.time() - t0:.1f} s)",
              flush=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    print("written:", path, os.path.getsize(path), "bytes",
          f"({time.time() - t0:.1f} s)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("slice", "scroll", "scan2d", "flat",
                                       "replay", "depthcam", "laser3d",
                                       "dda", "cli", "mesh", "scenarios",
                                       "entry"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.only in (None, "entry"):
        jax.config.update("jax_num_cpu_devices", ENTRY_DEVICES)
    elif args.only == "mesh":
        jax.config.update("jax_num_cpu_devices", MESH_DEVICES)
    from gie_mapping_tpu_torch.runtime.datasets import (cow_lady_scroll,
                                                        cow_lady_slice,
                                                        scan2d_flat_path,
                                                        scan2d_path)

    if args.only in (None, "slice"):
        run(OUT, *cow_lady_slice(), scroll=False)
    if args.only in (None, "scroll"):
        run(OUT_SCROLL, *cow_lady_scroll(), scroll=True)
    if args.only in (None, "scan2d"):
        run_scan(OUT_SCAN2D, {}, scan2d_path(), flat=False)
    if args.only in (None, "flat"):
        run_scan(OUT_FLAT, FLAT, scan2d_flat_path(), flat=True)
    if args.only in (None, "replay"):
        run_replay(OUT_REPLAY)
    if args.only in (None, "depthcam"):
        run_sensor(OUT_DEPTHCAM, "depth")
    if args.only in (None, "laser3d"):
        run_sensor(OUT_LASER3D, "multiscan")
    if args.only in (None, "dda"):
        run_dda(OUT_DDA)
    if args.only in (None, "cli"):
        run_cli(OUT_CLI)
    if args.only in (None, "mesh"):
        run_mesh(OUT_MESH)
    if args.only in (None, "scenarios"):
        run_scenarios(OUT_SCENARIOS)
    if args.only in (None, "entry"):
        run_entry(OUT_ENTRY)


if __name__ == "__main__":
    main()
