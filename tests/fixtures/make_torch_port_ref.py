"""Write tests/fixtures/torch_port_cow_ref.npz: the JAX package's results on
the cow-lady point-cloud slice that chip_smoke.py drives through the PyTorch
port on a GPU (the machine with the GPU has no JAX, so this file is the
port's only link to the reference there).

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_port_ref.py

Runs on the CPU in about a minute.  The slice is
gie_mapping_tpu_torch.runtime.datasets.cow_lady_slice (cow_lady preset,
131072 points per frame, streaming off, 12 poses).  The script asserts the
two properties the slice relies on: the canvas never moves after frame 0,
and the frames take both a gated slab branch and the full EDT branch.

Per frame the file holds the canvas origin, the gate level, the count of
each voxel type in the window output, the sum of valid dist_sq, the number
of changed blocks and a sha256 of the window outputs; plus a sha256 of the
final state (every MapState field).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_port_cow_ref.npz")


def main():
    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gie_mapping_tpu.models.mapper import VolumetricMapper
    from gie_mapping_tpu.models.pipeline import _slab_menu
    from gie_mapping_tpu.utils import geometry as geo
    from gie_mapping_tpu.utils.config import cow_lady_config
    from gie_mapping_tpu_torch.map_state import output_digest, state_digest
    from gie_mapping_tpu_torch.runtime.datasets import (COW_SLICE_RAYS,
                                                        cow_lady_slice)

    overrides, world, poses = cow_lady_slice()
    cfg = cow_lady_config(**overrides)
    n_menu = len(_slab_menu(cfg.canvas_size))
    mapper = VolumetricMapper(cfg)
    mapper.warmup(robot_pos=poses[0][0])
    rec = {k: [] for k in ("origin", "gate_level", "type_counts",
                           "dist_sum", "changed_blocks", "out_sha")}
    for i, (pos, quat) in enumerate(poses):
        t0 = time.time()
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
        print(f"frame {i}: gate {out.gate_level} types "
              f"{rec['type_counts'][-1].tolist()} origin "
              f"{rec['origin'][-1].tolist()} ({time.time() - t0:.1f} s)",
              flush=True)
    origins = np.stack(rec["origin"])
    assert (origins == origins[0]).all(), "the canvas moved after frame 0"
    levels = np.asarray(rec["gate_level"])
    assert (levels < n_menu).any() and (levels == n_menu).any(), levels
    state = {f.name: np.asarray(getattr(mapper.state, f.name))
             for f in dataclasses.fields(mapper.state)}
    np.savez_compressed(
        OUT, origin=origins, gate_level=levels,
        type_counts=np.stack(rec["type_counts"]).astype(np.int64),
        dist_sum=np.asarray(rec["dist_sum"], np.int64),
        changed_blocks=np.asarray(rec["changed_blocks"], np.int64),
        out_sha=np.asarray(rec["out_sha"]),
        state_sha=np.asarray(state_digest(state)),
        n_rays=np.asarray(COW_SLICE_RAYS))
    print("written:", OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
