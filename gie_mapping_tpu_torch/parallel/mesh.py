"""The device mesh of the PyTorch port: one process over a list of devices.

Counterpart of gie_mapping_tpu/parallel/mesh.py.  As in the JAX package, one
process drives every device of the mesh (a single controller), so
`VolumetricMapper(cfg, mesh=make_mesh(4))` means the same in both packages.
The mesh is 1-D, along the canvas x axis.

What runs across it: the exact canvas EDT
(ops/edt_batch.py::batch_edt_sharded / batch_edt_sharded_slab), the stage
that the JAX package shards explicitly (shard_map with its own all_to_all).
Each shard's phase runs on its own device, and the two phase boundaries are
`all_to_all` reshards: per-pair device copies (peer to peer between two
cards, device to device on one card).

What does not: the JAX package also keeps the canvas x-sharded and the
archive block-sharded between frames, and lets GSPMD partition the rest of
the frame.  PyTorch has no partitioner for this pipeline's kernels, and the
whole MapState of every preset fits one card, so `shard_state` places every
field whole on the mesh's first device ("home"), where the fusion, the
gate, frontiers, the scroll, the archive and streaming run unchanged.

A device may appear more than once: `make_mesh(devices=["cpu"] * 8)` is the
counterpart of the JAX tests' eight virtual CPU devices, and
`make_mesh(devices=["cuda:0"] * 4)` runs the sharded path on one card.
"""
from __future__ import annotations

import dataclasses

import torch

MESH_AXIS = "gx"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh (axis MESH_AXIS, the canvas x) over `devices`."""

    devices: tuple  # of torch.device; devices[0] is home

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the canvas-x axis.

    With `devices` None: the first `n_devices` CUDA devices (all of them
    when None); raises when the machine has fewer (the JAX package makes a
    smaller mesh; the port refuses rather than hide a smaller run).  Else
    the given devices (names or torch.device, all CPU or all CUDA, repeats
    allowed); `n_devices`, if given, must equal their count."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, "
                               f"{have} available")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    if n_devices is not None and n_devices != len(devices):
        raise ValueError(f"make_mesh: n_devices={n_devices} but "
                         f"{len(devices)} devices given")
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"make_mesh: devices must be all CPU or all CUDA, "
                         f"got {[str(d) for d in devices]}")
    if "cuda" in kinds:
        devices = tuple(torch.device("cuda", torch.cuda.current_device()
                                     if d.index is None else d.index)
                        for d in devices)
    return Mesh(devices)


def all_to_all(shards, split_dim: int, concat_dim: int) -> list:
    """`jax.lax.all_to_all(a, MESH_AXIS, split_dim, concat_dim, tiled=True)`
    inside shard_map, over shards[i] on mesh device i: chunk j of shard i
    along split_dim goes to shards[j]'s device, which concatenates what it
    receives along concat_dim in source order i."""
    n = len(shards)
    size = shards[0].shape[split_dim]
    if size % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {size} does not "
                         f"split into {n}")
    chunks = [s.split(size // n, dim=split_dim) for s in shards]
    return [torch.cat([chunks[i][j].to(dst.device, non_blocking=True)
                       for i in range(n)], dim=concat_dim)
            for j, dst in enumerate(shards)]


def split_x(t: torch.Tensor, mesh: Mesh) -> list:
    """A canvas array -> its x-shards, shard i on mesh device i."""
    if t.shape[0] % mesh.size:
        raise ValueError(f"split_x: x extent {t.shape[0]} does not split "
                         f"into {mesh.size}")
    return [c.to(d, non_blocking=True)
            for c, d in zip(t.split(t.shape[0] // mesh.size), mesh.devices)]


def gather_x(shards, mesh: Mesh) -> torch.Tensor:
    """x-shards -> one canvas array on home."""
    home = mesh.devices[0]
    return torch.cat([s.to(home, non_blocking=True) for s in shards])


def shard_state(state, mesh: Mesh):
    """Place a MapState on the mesh: every field whole on home
    (mesh.devices[0]), where every stage but the sharded EDT runs (see the
    module docstring; the JAX package shards the canvas along x and the
    archive along blocks)."""
    home = mesh.devices[0]
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(home)
        for f in dataclasses.fields(state)})


# the JAX package's name for it
shard_global_map = shard_state
