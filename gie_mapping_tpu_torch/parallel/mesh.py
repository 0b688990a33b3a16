"""The device mesh of the PyTorch port: the map state sharded between frames.

Counterpart of gie_mapping_tpu/parallel/mesh.py.  The mesh is 1-D, along
the canvas x axis, and `VolumetricMapper(cfg, mesh=...)` means what it means
in the JAX package: each shard holds its x-range of the canvas fields and,
where the archive divides, its range of archive rows, between frames.

Placement (JAX's `shard_state` rule, decided per field):
  - occ_val, vox_type, dist_sq, coc and p1c are sharded along x
    (`canvas_sharding`) when their leading extent divides the mesh size;
  - arch_keys and a_packed are sharded along rows (`pool_sharding`) when
    max_blocks divides the mesh size;
  - everything else, and every field whose leading extent does not divide,
    is replicated (`replicated`).

A sharded field is a `Sharded`: the parts this process drives, part i being
global shard `mesh.first + i`, which covers the contiguous dim-0 range
[g * s, (g + 1) * s) with s = extent / mesh.size, on `mesh.devices[i]`.
Each part is an ordinary contiguous tensor of the field's own dtype and
layout (a canvas part is [X/n, Y, Z] or [X/n, Y, Z, 3]): every kernel then
runs on a part exactly as on a whole canvas, and a part gathers back by
plain concatenation.  An x-shard need not hold whole 8-voxel blocks (152 / 4
= 38), so the block operations of the scroll and of streaming pad a part to
its block range with zeros and sum the shards' rows (ops below; map_state).

A replicated field is one plain tensor per process, on its home device
`mesh.devices[0]`.  The window, the sensor model and every block-level grid
are replicated: every process feeds the same observation (the JAX package's
plan), and the stages that read the canvas (the window crop, the block
masks, the gate's scalars, the archive directory) reduce over the shards
with the collectives below, so every process takes the same branch.

Two drivers serve one set of stages:
  - single controller (`make_mesh(n)`, `make_mesh(devices=[...])`): one
    process drives every shard; devices may repeat (`["cpu"] * 8` is the
    counterpart of the JAX tests' virtual devices, `["cuda:0"] * 4` runs the
    sharded path on one card).  The collectives are per-pair device copies
    and reductions on home.
  - process group (`make_mesh(group=..., local_devices=[...])`): one process
    per rank of a torch.distributed group (NCCL on cards, gloo on the CPU),
    each driving its local devices.  The collectives are
    `dist.all_to_all_single` (equal byte chunks, padded: gloo refuses
    unequal ones) and `dist.all_reduce`.

Every exchange is planned on the host from the shard bounds alone, so each
process knows every piece's shape without a size exchange.
"""
from __future__ import annotations

import dataclasses

import torch

MESH_AXIS = "gx"
_ALIGN = 16  # byte alignment of the pieces inside an exchange buffer


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh (axis MESH_AXIS, the canvas x).  `devices`: the devices
    this process drives, devices[0] its home; `group`: the
    torch.distributed process group, or None for a single controller;
    `rank` / `world`: this process's rank and the group's size."""

    devices: tuple
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """Global shard count."""
        return len(self.devices) * self.world

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def _cuda_devices(devices):
    return tuple(torch.device("cuda", torch.cuda.current_device()
                              if d.index is None else d.index)
                 if d.type == "cuda" else d for d in devices)


def _check_kinds(devices):
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"make_mesh: devices must be all CPU or all CUDA, "
                         f"got {[str(d) for d in devices]}")
    return kinds.pop()


def make_mesh(n_devices: int | None = None, devices=None, *, group=None,
              local_devices=None) -> Mesh:
    """1-D mesh over the canvas-x axis.

    Single controller (group None): with `devices` None, the first
    `n_devices` CUDA devices (all of them when None); raises when the
    machine has fewer (the JAX package makes a smaller mesh; the port
    refuses rather than hide a smaller run).  Else the given devices (names
    or torch.device, all CPU or all CUDA, repeats allowed); `n_devices`, if
    given, must equal their count.

    Process group: `group` is an initialised torch.distributed group
    (dist.group.WORLD or a new_group); `local_devices` the devices this
    rank drives (default: the current CUDA device on NCCL, the CPU on
    gloo).  Every rank must pass the same number; NCCL needs CUDA devices,
    gloo CPU ones."""
    if group is not None:
        import torch.distributed as dist

        backend = dist.get_backend(group)
        if local_devices is None:
            local_devices = (["cuda"] if backend == "nccl" else ["cpu"])
        devs = _cuda_devices(tuple(torch.device(d) for d in local_devices))
        if not devs:
            raise ValueError("make_mesh: no local devices")
        kind = _check_kinds(devs)
        if (backend == "nccl") != (kind == "cuda"):
            raise ValueError(f"make_mesh: backend {backend} with {kind} "
                             f"devices (NCCL drives cards, gloo the CPU)")
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA devices asked for, none available")
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        cnt = torch.tensor([len(devs), -len(devs)], dtype=torch.int32,
                           device=devs[0])
        dist.all_reduce(cnt, op=dist.ReduceOp.MAX, group=group)
        if int(cnt[0]) != len(devs) or int(cnt[1]) != -len(devs):
            raise ValueError("make_mesh: every rank must drive the same "
                             "number of local devices")
        return Mesh(devs, group, rank, world)
    if local_devices is not None:
        raise ValueError("make_mesh: local_devices needs a group")
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
    _check_kinds(devices)
    return Mesh(_cuda_devices(devices))


# ---------------------------------------------------------------------------
# the sharded field and the placements
# ---------------------------------------------------------------------------

class Sharded:
    """A field split along dim 0 over a mesh (module docstring): `parts[i]`
    is global shard mesh.first + i, covering dim-0 range `bounds(i)`."""

    __slots__ = ("mesh", "parts", "extent")

    def __init__(self, mesh: Mesh, parts, extent: int):
        self.mesh, self.parts, self.extent = mesh, list(parts), int(extent)

    @property
    def step(self) -> int:
        return self.extent // self.mesh.size

    def bounds(self, i: int):
        g = self.mesh.first + i
        return g * self.step, (g + 1) * self.step

    @property
    def shape(self):
        return (self.extent,) + tuple(self.parts[0].shape[1:])

    @property
    def dtype(self):
        return self.parts[0].dtype

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, "
                f"{self.mesh.size} shards)")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a field goes on a mesh: along dim 0 (`axis` MESH_AXIS) or
    replicated (`axis` None)."""

    mesh: Mesh
    axis: str | None


def canvas_sharding(mesh: Mesh) -> Sharding:
    """Dense canvas arrays: sharded along x (dim 0)."""
    return Sharding(mesh, MESH_AXIS)


def pool_sharding(mesh: Mesh) -> Sharding:
    """Archive arrays: sharded along the row (block) axis (dim 0)."""
    return Sharding(mesh, MESH_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def put(t, sh: Sharding):
    """Place a whole tensor (or numpy array) by `sh`: its dim-0 shards (each
    process takes only its own) or, where sh is replicated or the leading
    extent does not divide the mesh, one copy on home."""
    mesh = sh.mesh
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(t)
    n = mesh.size
    if sh.axis is None or t.dim() == 0 or t.shape[0] % n:
        return t.to(mesh.home).clone() if t.device == mesh.home else t.to(mesh.home)
    s = t.shape[0] // n
    return Sharded(mesh, [t[(mesh.first + i) * s:(mesh.first + i + 1) * s]
                          .to(d).clone() for i, d in enumerate(mesh.devices)],
                   t.shape[0])


# MapState fields by placement (the JAX package's shard_state)
CANVAS_FIELDS = ("occ_val", "vox_type", "dist_sq", "coc", "p1c")
POOL_FIELDS = ("arch_keys", "a_packed")


def field_sharding(name: str, mesh: Mesh) -> Sharding:
    if name in CANVAS_FIELDS:
        return canvas_sharding(mesh)
    if name in POOL_FIELDS:
        return pool_sharding(mesh)
    return replicated(mesh)


def shard_state(state, mesh: Mesh):
    """Place a MapState on the mesh: the canvas sharded along x, the archive
    along blocks, the rest replicated; a field whose leading dimension does
    not divide the mesh is replicated (odd max_blocks, every preset's).  A
    field already sharded is gathered first."""
    return dataclasses.replace(state, **{
        f.name: put(gather(getattr(state, f.name)),
                    field_sharding(f.name, mesh))
        for f in dataclasses.fields(state)})


# the JAX package's name for it
shard_global_map = shard_state


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _nbytes(shape, dtype) -> int:
    n = 1
    for v in shape:
        n *= int(v)
    return n * torch.empty((), dtype=dtype).element_size()


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _exchange(mesh: Mesh, send: dict, shape_of, dtype) -> dict:
    """Point-to-point transfer between global shards.  send: {(i, d):
    tensor} from this process's local shard i to global shard d;
    shape_of(s, d): the shape of the piece from global shard s to global
    shard d, or None (the same answer on every process).  Returns {(s, k):
    tensor on mesh.devices[k]}: what local shard k received from global
    shard s."""
    L = len(mesh.devices)
    if mesh.group is None:
        return {(i, d): t.to(mesh.devices[d], non_blocking=True)
                for (i, d), t in send.items()}
    import torch.distributed as dist

    W, r = mesh.world, mesh.rank

    def sizes(p, q):
        out = []
        for d in range(q * L, (q + 1) * L):
            for s in range(p * L, (p + 1) * L):
                shp = shape_of(s, d)
                if shp is not None:
                    out.append((s, d, shp, _aligned(_nbytes(shp, dtype))))
        return out

    chunk = max(sum(e[3] for e in sizes(p, q))
                for p in range(W) for q in range(W))
    if chunk == 0:
        return {}
    home = mesh.home
    sbuf = torch.zeros(W * chunk, dtype=torch.uint8, device=home)
    for q in range(W):
        off = q * chunk
        for s, d, shp, nb in sizes(r, q):
            t = send[(s - mesh.first, d)].to(home).contiguous().reshape(-1)
            b = t.view(torch.uint8)
            sbuf[off:off + b.numel()] = b
            off += nb
    rbuf = torch.empty_like(sbuf)
    dist.all_to_all_single(rbuf, sbuf, group=mesh.group)
    got = {}
    for p in range(W):
        off = p * chunk
        for s, d, shp, nb in sizes(p, r):
            n = _nbytes(shp, dtype)
            got[(s, d - mesh.first)] = (rbuf[off:off + n].view(dtype)
                                        .reshape(shp)
                                        .to(mesh.devices[d - mesh.first]))
            off += nb
    return got


def all_to_all(shards, split_dim: int, concat_dim: int, mesh: Mesh = None) -> list:
    """`jax.lax.all_to_all(a, MESH_AXIS, split_dim, concat_dim, tiled=True)`
    inside shard_map: chunk j of global shard i along split_dim goes to
    global shard j, which concatenates what it receives along concat_dim in
    source order i.  `shards`: the local shards (all of them when `mesh` is
    None: shards[i] on its own device)."""
    n = len(shards) if mesh is None else mesh.size
    size = shards[0].shape[split_dim]
    if size % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {size} does not "
                         f"split into {n}")
    c = size // n
    if mesh is None:
        mesh = Mesh(tuple(s.device for s in shards))
    shp = list(shards[0].shape)
    shp[split_dim] = c
    shp = tuple(shp)
    send = {(i, d): s.narrow(split_dim, d * c, c)
            for i, s in enumerate(shards) for d in range(n)}
    got = _exchange(mesh, send, lambda s, d: shp, shards[0].dtype)
    return [torch.cat([got[(s, k)] for s in range(n)], dim=concat_dim)
            for k in range(len(shards))]


def fetch_rows(mesh: Mesh, parts, extent: int, requests) -> list:
    """Each shard fetches a dim-0 range of a field split over the mesh.
    parts: the local shards (dim-0 split, trailing dims alike); requests: a
    list over GLOBAL shards of (lo, hi) or None.  Returns, per local shard,
    the rows [max(lo, 0), min(hi, extent)) gathered from their owners (None
    where it asked nothing)."""
    n = mesh.size
    step = extent // n
    trail = tuple(parts[0].shape[1:])
    dtype = parts[0].dtype

    def piece(s, d):
        r = requests[d]
        if r is None:
            return None
        a, b = max(r[0], s * step, 0), min(r[1], (s + 1) * step, extent)
        return (a - s * step, b - s * step) if a < b else None

    def shape_of(s, d):
        p = piece(s, d)
        return None if p is None else (p[1] - p[0],) + trail

    send = {}
    for i, t in enumerate(parts):
        for d in range(n):
            p = piece(mesh.first + i, d)
            if p is not None:
                send[(i, d)] = t[p[0]:p[1]]
    got = _exchange(mesh, send, shape_of, dtype)
    out = []
    for k, dev in enumerate(mesh.devices):
        if requests[mesh.first + k] is None:
            out.append(None)
            continue
        pieces = [got[(s, k)] for s in range(n) if (s, k) in got]
        out.append(torch.cat(pieces) if pieces else
                   torch.empty((0,) + trail, dtype=dtype, device=dev))
    return out


_OPS = {"max": torch.maximum, "min": torch.minimum, "sum": torch.add}


def all_reduce(mesh: Mesh, parts, op: str = "max") -> torch.Tensor:
    """Elementwise reduction (max, min, sum) of one tensor per local shard
    over every shard of the mesh; the result lies on home, the same on every
    process.  bool reduces as any (max) or all (min)."""
    home = mesh.home
    acc = None
    for p in parts:
        p = p.to(home)
        acc = p if acc is None else (
            (acc | p if op == "max" else acc & p) if p.dtype == torch.bool
            else _OPS[op](acc, p))
    if mesh.group is None:
        return acc
    import torch.distributed as dist

    dt = acc.dtype
    wide = acc.to(torch.int64 if dt == torch.int64 else torch.int32)
    dist.all_reduce(wide, op={"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
                              "sum": dist.ReduceOp.SUM}[op], group=mesh.group)
    return wide.to(dt)


# ---------------------------------------------------------------------------
# field operations: one code path for a whole tensor and for a Sharded
# ---------------------------------------------------------------------------

def parts_of(t) -> list:
    return t.parts if isinstance(t, Sharded) else [t]


def bounds_of(t) -> list:
    """[(lo, hi)] global dim-0 range of each local part."""
    if isinstance(t, Sharded):
        return [t.bounds(i) for i in range(len(t.parts))]
    return [(0, t.shape[0])]


def like(t, parts):
    """New parts in t's placement."""
    return Sharded(t.mesh, parts, t.extent) if isinstance(t, Sharded) else parts[0]


def smap(fn, *args):
    """fn over the parts of the Sharded arguments (other arguments pass as
    they are; a tuple result gives a tuple); on whole tensors, fn itself."""
    ref = next((a for a in args if isinstance(a, Sharded)), None)
    if ref is None:
        return fn(*args)
    res = [fn(*(a.parts[i] if isinstance(a, Sharded) else a for a in args))
           for i in range(len(ref.parts))]
    if isinstance(res[0], tuple):
        return tuple(Sharded(ref.mesh, [r[j] for r in res], ref.extent)
                     for j in range(len(res[0])))
    return Sharded(ref.mesh, res, ref.extent)


def sbuild(like_t, fn):
    """A field placed as `like_t`, part by part: fn(lo, hi, device) gives
    the part covering dim-0 range [lo, hi)."""
    if not isinstance(like_t, Sharded):
        return fn(0, like_t.shape[0], like_t.device)
    return Sharded(like_t.mesh, [fn(lo, hi, p.device) for p, (lo, hi)
                                 in zip(like_t.parts, bounds_of(like_t))],
                   like_t.extent)


def crop(t, box):
    """t[box] (a tuple of slices, one per leading axis) as one tensor on
    home; on a Sharded the x-range is gathered from its owners."""
    if not isinstance(t, Sharded):
        return t[box]
    lo, hi = box[0].start, box[0].stop
    rest = (slice(None),) + tuple(box[1:])
    mesh = t.mesh
    L = len(mesh.devices)
    req = [(lo, hi) if g % L == 0 else None for g in range(mesh.size)]
    return fetch_rows(mesh, [p[rest] for p in t.parts], t.extent, req)[0]


def splice(t, box, value, inplace: bool = False):
    """t with t[box] = value (value: a tensor of the box's shape on home);
    a copy unless `inplace`."""
    out = []
    x0 = box[0].start
    for p, (lo, hi) in zip(parts_of(t), bounds_of(t)):
        q = p if inplace else p.clone()
        a, b = max(box[0].start, lo), min(box[0].stop, hi)
        if a < b:
            q[(slice(a - lo, b - lo),) + tuple(box[1:])] = \
                value[a - x0:b - x0].to(q.device, non_blocking=True)
        out.append(q)
    return like(t, out)


def block_reduce(t, g: int, op: str, fill):
    """Reduce [X, Y, Z] over g-cubes ("any" of a bool field, "max" of an
    int one) -> [X/g, Y/g, Z/g] on home, replicated.  A shard whose x-range
    cuts a cube pads it with `fill` (False / the max's identity) and the
    shards' cubes reduce across the mesh."""
    def red(m):
        X, Y, Z = m.shape
        m = m.reshape(X // g, g, Y // g, g, Z // g, g)
        return m.any(5).any(3).any(1) if op == "any" else m.amax(dim=(1, 3, 5))

    if not isinstance(t, Sharded):
        return red(t)
    X = t.extent
    grids = []
    for p, (lo, hi) in zip(t.parts, bounds_of(t)):
        b0, b1 = lo // g, -(-hi // g)
        if (lo, hi) != (b0 * g, b1 * g):
            q = torch.full(((b1 - b0) * g,) + tuple(p.shape[1:]), fill,
                           dtype=p.dtype, device=p.device)
            q[lo - b0 * g:hi - b0 * g] = p
            p = q
        r = red(p).to(t.mesh.home)
        grid = torch.full((X // g,) + tuple(r.shape[1:]), fill, dtype=r.dtype,
                          device=t.mesh.home)
        grid[b0:b1] = r
        grids.append(grid)
    return all_reduce(t.mesh, grids, "max")


def x_halo(t, fill) -> list:
    """Each part with one dim-0 plane of each neighbour attached ([h + 2,
    ...]; `fill` beyond the global edges)."""
    if not isinstance(t, Sharded):
        plane = torch.full((1,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                           device=t.device)
        return [torch.cat([plane, t, plane])]
    mesh = t.mesh
    s = t.step
    req = [(g * s - 1, (g + 1) * s + 1) for g in range(mesh.size)]
    got = fetch_rows(mesh, t.parts, t.extent, req)
    out = []
    for e, p, (lo, hi) in zip(got, t.parts, bounds_of(t)):
        plane = torch.full((1,) + tuple(p.shape[1:]), fill, dtype=p.dtype,
                           device=p.device)
        out.append(torch.cat(([plane] if lo == 0 else []) + [e]
                             + ([plane] if hi == t.extent else [])))
    return out


def any_flags(like_t, flags) -> bool:
    """One host read: whether any of `flags` (per-part lists of bool
    scalars) is set on any shard."""
    per_part = [torch.stack(f).any() for f in flags]
    if isinstance(like_t, Sharded):
        return bool(all_reduce(like_t.mesh, per_part, "max"))
    return bool(per_part[0])


def gather(t) -> torch.Tensor:
    """The whole field as one tensor on home (every process gets it):
    checkpoints, digests and tests only; a frame never gathers the canvas."""
    if not isinstance(t, Sharded):
        return t
    mesh = t.mesh
    L = len(mesh.devices)
    req = [(0, t.extent) if g % L == 0 else None for g in range(mesh.size)]
    return fetch_rows(mesh, t.parts, t.extent, req)[0]


def to_numpy(t):
    return gather(t).detach().cpu().numpy()
