"""Map state of the PyTorch port: the resident canvas + block archive.

Counterpart of gie_mapping_tpu/map_state.py.  The fields, dtypes and
meanings are the JAX package's (`MapState` there documents each), with one
representational change: the archive `a_packed` holds its uint32 words as
an int32 bit pattern, because PyTorch's uint32 arithmetic is thin;
`state_to_numpy` / `state_from_numpy` convert at the boundary.

The canvas scroll (`_do_scroll`) runs one design for every shift, the JAX
package's compacted block-column path: exiting block-columns are gathered
out of the packed canvas and written to the archive, the canvas shifts in
one pass with the coc re-anchor fused in, and entering blocks are gathered
from the archive and written into the shifted canvas.  The row copies and
the shift are the hand-written kernels of ops/kernels/blockrows.py and
ops/kernels/shift.py.  The JAX package's dense and XLA-row arms, its static
z-shift switch and its parking column are TPU workarounds and are not
carried; results do not depend on the arm.

Over a device mesh (parallel/mesh.py) the canvas fields are x-shards and
the archive rows are row-shards where max_blocks divides: the scroll's
block-row traffic pads each x-shard to its block hull and sums the shards'
rows, each shard fetches the planes its shift brings in from their owners,
archive rows are written and read by the shard that owns them, and the
archive directory reduces over the shards, so every shard computes the
same block ids and slots.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .ops.kernels.blockrows import (gather_archive_rows, gather_block_rows,
                                   scatter_archive_rows, scatter_block_rows)
from .ops.kernels.shift import shift_canvas
from .parallel.mesh import (Sharded, all_reduce, bounds_of, fetch_rows,
                            field_sharding, put, smap, to_numpy)
from .runtime import profiler
from .utils.config import MapConfig
from .utils.constants import EMPTY_VALUE, VB_WIDTH, VOX_UNKNOWN

EMPTY_KEY = np.int32(EMPTY_VALUE)
COC_INVALID16 = np.int16(32767)
VB_SIZE_ = VB_WIDTH ** 3
ROW_WORDS = VB_SIZE_ * 3

_PACKED_DEFAULT = np.asarray(
    [np.uint32(EMPTY_VALUE),  # dist=EMPTY, occ=0, type=UNKNOWN
     np.uint32(np.uint16(COC_INVALID16)) | (np.uint32(np.uint16(COC_INVALID16)) << 16),
     np.uint32(np.uint16(COC_INVALID16))],
    dtype=np.uint32,
)
_PACKED_DEFAULT_ROW = np.tile(_PACKED_DEFAULT, VB_SIZE_)


def _u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor holding uint32 values -> int32 with the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def pack_voxels(occ_val, vox_type, dist_sq, coc) -> torch.Tensor:
    """Dense fields -> packed words [..., 3] (int32 bit patterns of the JAX
    package's uint32 words):
      w0 = dist_sq | occ_val << 20 | (vox_type & 0xF) << 28
      w1 = coc_x (u16) | coc_y << 16;  w2 = coc_z (u16)."""
    w0 = (dist_sq.to(torch.int64) & 0xFFFFFFFF) \
        | (occ_val.to(torch.int64) << 20) \
        | ((vox_type.to(torch.int64) & 0xF) << 28)
    cu = coc.to(torch.int64) & 0xFFFF
    w1 = cu[..., 0] | (cu[..., 1] << 16)
    w2 = cu[..., 2]
    return torch.stack([_u32_to_i32(w0 & 0xFFFFFFFF), _u32_to_i32(w1), w2.to(torch.int32)],
                       dim=-1)


def unpack_voxels(packed: torch.Tensor):
    """Packed words [..., 3] -> (occ_val u8, vox_type i8, dist_sq i32,
    coc i16 [..., 3])."""
    w0 = packed[..., 0].to(torch.int64) & 0xFFFFFFFF
    dist = (w0 & 0xFFFFF).to(torch.int32)
    occ = ((w0 >> 20) & 0xFF).to(torch.uint8)
    typ = ((w0 >> 28) & 0xF).to(torch.int8)

    def s16(v):
        return ((v ^ 0x8000) - 0x8000).to(torch.int16)

    w1 = packed[..., 1].to(torch.int64) & 0xFFFFFFFF
    w2 = packed[..., 2].to(torch.int64) & 0xFFFFFFFF
    coc = torch.stack([s16(w1 & 0xFFFF), s16((w1 >> 16) & 0xFFFF),
                       s16(w2 & 0xFFFF)], dim=-1)
    return occ, typ, dist, coc


def resolve_device(device, who: str) -> torch.device:
    """`device`, or "cuda" when it is None; raises for a CUDA device when
    no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on a CUDA device and none is available; pass "
            "device=\"cpu\" to run the plain PyTorch versions of its "
            "kernels on the CPU")
    return dev


@dataclasses.dataclass
class MapState:
    """Scrolling resident canvas + block archive (see module doc)."""

    origin_blk: torch.Tensor  # int32 [3] canvas origin (block coords)
    occ_val: torch.Tensor     # uint8 [Xc, Yc, Zc]
    vox_type: torch.Tensor    # int8
    dist_sq: torch.Tensor     # int32
    coc: torch.Tensor         # int16 [Xc, Yc, Zc, 3], canvas-relative
    present: torch.Tensor     # bool [bx, by, bz]
    arch_keys: torch.Tensor   # int32 [B, 3]
    n_arch: torch.Tensor      # int32 scalar
    a_packed: torch.Tensor    # int32 [B, 1536] bit pattern of uint32 rows
    arch_dropped: torch.Tensor  # int32 scalar
    dmax_cell: torch.Tensor   # int32 [Xc/4, Yc/4, Zc/4]
    p1c: torch.Tensor         # int32 [Xc, Yc, Zc] (or [1, 1, 1])
    p1c_ok: torch.Tensor      # bool scalar

    @staticmethod
    def create(cfg: MapConfig, device=None, mesh=None) -> "MapState":
        """A fresh map on `device` ("cuda" by default; see resolve_device),
        or placed on `mesh` (parallel.mesh.shard_state's rule; each shard
        is made on its own device)."""
        from .models.pipeline import p1_cache_enabled

        if mesh is not None and device is not None:
            raise ValueError("MapState.create: device and mesh are exclusive")
        dev = mesh.home if mesh is not None else resolve_device(
            device, "MapState.create")
        cs = cfg.canvas_size
        B = cfg.max_blocks
        row = torch.from_numpy(_PACKED_DEFAULT_ROW.view(np.int32).copy())

        def full(name, shape, dtype, fill):
            sharded = (mesh is not None and field_sharding(name, mesh).axis
                       is not None and shape[0] % mesh.size == 0)
            devs, shp = ((mesh.devices, (shape[0] // mesh.size,) + shape[1:])
                         if sharded else ([dev], shape))
            parts = [(row.to(d).expand(shp).contiguous() if name == "a_packed"
                      else torch.full(shp, fill, dtype=dtype, device=d))
                     for d in devs]
            return Sharded(mesh, parts, shape[0]) if sharded else parts[0]

        return MapState(
            origin_blk=full("origin_blk", (3,), torch.int32, 0),
            occ_val=full("occ_val", cs, torch.uint8, 0),
            vox_type=full("vox_type", cs, torch.int8, VOX_UNKNOWN),
            dist_sq=full("dist_sq", cs, torch.int32, EMPTY_VALUE),
            coc=full("coc", cs + (3,), torch.int16, int(COC_INVALID16)),
            present=full("present", cfg.canvas_blocks, torch.bool, False),
            arch_keys=full("arch_keys", (B, 3), torch.int32, int(EMPTY_KEY)),
            n_arch=full("n_arch", (), torch.int32, 0),
            a_packed=full("a_packed", (B, ROW_WORDS), torch.int32, 0),
            arch_dropped=full("arch_dropped", (), torch.int32, 0),
            dmax_cell=full("dmax_cell", tuple(c // 4 for c in cs), torch.int32,
                           EMPTY_VALUE),
            p1c=full("p1c", cs if p1_cache_enabled(cfg) else (1, 1, 1),
                     torch.int32, 0),
            p1c_ok=full("p1c_ok", (), torch.bool, False),
        )


FIELDS = tuple(f.name for f in dataclasses.fields(MapState))


def state_to_numpy(state: MapState) -> dict:
    """{field: numpy array} with the JAX package's dtypes (a_packed uint32);
    a sharded field is gathered."""
    out = {}
    for name in FIELDS:
        a = to_numpy(getattr(state, name))
        out[name] = a.view(np.uint32) if name == "a_packed" else a
    return out


def state_from_numpy(arrays: dict, device=None, mesh=None) -> MapState:
    """MapState from {field: numpy array} as `state_to_numpy` gives them (or
    as the JAX package's MapState leaves convert with np.asarray), on
    `device` ("cuda" by default; see resolve_device), or placed on `mesh`
    (each process copies only its own shards to the devices)."""
    if mesh is not None and device is not None:
        raise ValueError("state_from_numpy: device and mesh are exclusive")
    dev = None if mesh is not None else resolve_device(device, "state_from_numpy")
    kw = {}
    for name in FIELDS:
        a = np.array(arrays[name], order="C")  # a copy; keeps 0-d arrays 0-d
        if name == "a_packed":
            a = a.astype(np.uint32, copy=False).view(np.int32)
        kw[name] = (torch.from_numpy(a).to(dev) if mesh is None
                    else put(a, field_sharding(name, mesh)))
    return MapState(**kw)


def state_digest(arrays: dict) -> str:
    """sha256 over every field (name, dtype, shape, bytes) of a state given
    as numpy arrays: one string that two runs agree on iff their states are
    bit-identical."""
    h = hashlib.sha256()
    for name in FIELDS:
        a = np.asarray(arrays[name], order="C")
        if name == "a_packed":
            a = a.astype(np.uint32, copy=False)
        h.update(f"{name}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def output_digest(glb_type, dist_sq, coc) -> str:
    """sha256 of a frame's window outputs (numpy arrays)."""
    h = hashlib.sha256()
    for a in (glb_type, dist_sq, coc):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def shift_fill(arr: torch.Tensor, shifts, fill) -> torch.Tensor:
    """out[i] = arr[i + shift] over the leading len(shifts) axes, `fill`
    where i + shift falls outside (the JAX package's scroll shift_nd)."""
    out = torch.full_like(arr, fill)
    src, dst = [], []
    for s, n in zip(shifts, arr.shape):
        s = int(s)
        lo, hi = max(0, -s), min(n, n - s)
        if hi <= lo:
            return out
        dst.append(slice(lo, hi))
        src.append(slice(lo + s, hi + s))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _dense_to_blocks(arr: torch.Tensor, canvas_blocks) -> torch.Tensor:
    """[X, Y, Z, ...] -> [bx, by, bz, 8, 8, 8, ...] (a view)."""
    bx, by, bz = canvas_blocks
    extra = tuple(arr.shape[3:])
    arr = arr.reshape((bx, VB_WIDTH, by, VB_WIDTH, bz, VB_WIDTH) + extra)
    return arr.permute((0, 2, 4, 1, 3, 5) + tuple(range(6, arr.dim())))


def _rows3(rows):
    """[..., 1536] flat word-rows -> [..., 512, 3] per-voxel view (a
    tensor or a numpy array)."""
    return rows.reshape(tuple(rows.shape[:-1]) + (VB_SIZE_, 3))


def shift_packed_coc(rows: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Re-anchor the packed coc fields of rows [..., 3] by adding delta
    [..., 3] (broadcastable); the COC_INVALID16 sentinel (read from coc_x)
    passes through.  Archive rows anchor cocs to their own block origin,
    canvas voxels to the canvas origin."""
    w1 = rows[..., 1].to(torch.int64) & 0xFFFFFFFF
    w2 = rows[..., 2].to(torch.int64) & 0xFFFFFFFF
    s16 = lambda v: (v ^ 0x8000) - 0x8000
    cx, cy, cz = s16(w1 & 0xFFFF), s16((w1 >> 16) & 0xFFFF), s16(w2 & 0xFFFF)
    valid = cx != int(COC_INVALID16)
    d = delta.to(torch.int64)
    inv = int(COC_INVALID16)
    nx = torch.where(valid, cx + d[..., 0], inv)
    ny = torch.where(valid, cy + d[..., 1], inv)
    nz = torch.where(valid, cz + d[..., 2], inv)
    n1 = (nx & 0xFFFF) | ((ny & 0xFFFF) << 16)
    return torch.stack([rows[..., 0], _u32_to_i32(n1), (nz & 0xFFFF).to(torch.int32)],
                       dim=-1)


def _block_pos_vox(linear_ids: torch.Tensor, canvas_blocks) -> torch.Tensor:
    """Canvas voxel position int32 [..., 3] of linear block ids
    (bx * cby * cbz + by * cbz + bz order)."""
    cby, cbz = canvas_blocks[1], canvas_blocks[2]
    ids = linear_ids.to(torch.int32)
    bx = ids // (cby * cbz)
    by = (ids // cbz) % cby
    bz = ids % cbz
    return torch.stack([bx, by, bz], dim=-1) * VB_WIDTH


def shift_block_mask(m: torch.Tensor, shift) -> torch.Tensor:
    """Move a [bx, by, bz] block mask with a canvas scroll by the block
    shift (host ints): new index i holds old index i + shift; exposed
    entries become False."""
    return shift_fill(m, shift, False)


def _arch_directory(keys, n_arch, origin_blk, canvas_blocks) -> torch.Tensor:
    """Archive-slot directory int32 [bx, by, bz] over the canvas at
    origin_blk (-1 where no active archive row holds the block).  Over a
    row-sharded archive each shard fills the entries of its own rows and
    the shards' directories reduce by max (active keys are unique)."""
    if not isinstance(keys, Sharded):
        return _arch_directory_rows(keys, 0, n_arch, origin_blk, canvas_blocks)
    home = keys.mesh.home
    return all_reduce(keys.mesh, [
        _arch_directory_rows(p, lo, n_arch.to(p.device),
                             origin_blk.to(p.device), canvas_blocks).to(home)
        for p, (lo, _) in zip(keys.parts, bounds_of(keys))], "max")


def _arch_directory_rows(keys, r0, n_arch, origin_blk, canvas_blocks):
    """_arch_directory over archive rows [r0, r0 + len(keys))."""
    B = keys.shape[0]
    dev = keys.device
    cbx, cby, cbz = canvas_blocks
    nb = cbx * cby * cbz
    rel = keys - origin_blk.to(torch.int32)[None, :]
    shape = torch.tensor(canvas_blocks, dtype=torch.int32, device=dev)
    row = torch.arange(r0, r0 + B, dtype=torch.int32, device=dev)
    inside = ((rel >= 0) & (rel < shape)).all(-1) & (row < n_arch)
    flat = (rel[:, 0] * cby + rel[:, 1]) * cbz + rel[:, 2]
    idx = torch.where(inside, flat, nb).to(torch.int64)
    directory = torch.full((nb + 1,), -1, dtype=torch.int32, device=dev)
    # active archive keys are unique; entries outside the canvas all land on
    # the dropped slot nb
    directory.scatter_(0, idx, row)
    return directory[:nb].reshape(canvas_blocks)


def _compact_ids(flags_flat: torch.Tensor, s_max: int):
    """Indices of the (at most s_max) set flags in ascending order, via one
    sort (no host sync).  Returns (ids int32 [s_max] (0 where invalid),
    valid bool [s_max])."""
    nb = flags_flat.shape[0]
    rank = torch.arange(nb, dtype=torch.int32, device=flags_flat.device)
    key = torch.where(flags_flat, rank, nb)
    ids = torch.sort(key).values[:s_max]
    valid = ids < nb
    return torch.where(valid, ids, 0), valid


def _packed_defaults(Z: int, device) -> torch.Tensor:
    """The packed default word pattern of one (x, y) canvas line, int32 [3Z]."""
    return torch.from_numpy(np.tile(_PACKED_DEFAULT, Z).view(np.int32)).to(device)


# ---- block-row traffic over a whole or an x-sharded canvas ----------------
# An x-shard [lo, hi) need not hold whole blocks: it is padded with zeros to
# its block hull [8 floor(lo / 8), 8 ceil(hi / 8)), where the kernels run on
# whole blocks; each voxel lies in exactly one shard, so the shards' rows sum
# to the canvas's rows (x + 0 == x on int32 words).

def _hull(p, lo, hi):
    """p (dim-0 range [lo, hi)) zero-padded to its block hull; returns
    (hull, first block, end block)."""
    b0, b1 = lo // VB_WIDTH, -(-hi // VB_WIDTH)
    if (lo, hi) == (b0 * VB_WIDTH, b1 * VB_WIDTH):
        return p, b0, b1
    q = p.new_zeros(((b1 - b0) * VB_WIDTH,) + tuple(p.shape[1:]))
    q[lo - b0 * VB_WIDTH:hi - b0 * VB_WIDTH] = p
    return q, b0, b1


def _local_cols(col_ids, b0, b1, cby):
    """Column ids of the block range [b0, b1) in x: (local ids, inside)."""
    inside = (col_ids >= b0 * cby) & (col_ids < b1 * cby)
    return torch.where(inside, col_ids - b0 * cby, 0), inside


def _gather_blocks(packed, col_ids, cb):
    """gather_block_rows of the packed canvas (whole or Sharded) -> rows
    [S * cbz, 512, 3] on home."""
    if not isinstance(packed, Sharded):
        return gather_block_rows(packed, col_ids, cb)
    rows = []
    for p, (lo, hi) in zip(packed.parts, bounds_of(packed)):
        q, b0, b1 = _hull(p, lo, hi)
        ids, inside = _local_cols(col_ids.to(p.device), b0, b1, cb[1])
        r = gather_block_rows(q, ids, (b1 - b0, cb[1], cb[2]))
        rows.append(torch.where(inside.repeat_interleave(cb[2])[:, None, None],
                                r, 0))
    return all_reduce(packed.mesh, rows, "sum")


def _scatter_blocks(packed, rows, col_ids, valid, cb):
    """scatter_block_rows into the packed canvas (whole, in place, or
    Sharded: each shard writes its x-part of each block)."""
    if not isinstance(packed, Sharded):
        return scatter_block_rows(packed, rows, col_ids, valid, cb)
    out = []
    for p, (lo, hi) in zip(packed.parts, bounds_of(packed)):
        q, b0, b1 = _hull(p, lo, hi)
        dev = p.device
        ids, inside = _local_cols(col_ids.to(dev), b0, b1, cb[1])
        v = valid.to(dev) * inside.repeat_interleave(cb[2]).to(torch.int32)
        q = scatter_block_rows(q.contiguous(), rows.to(dev), ids, v,
                               (b1 - b0, cb[1], cb[2]))
        out.append(q[lo - b0 * VB_WIDTH:hi - b0 * VB_WIDTH])
    return Sharded(packed.mesh, out, packed.extent)


def _gather_archive(a_packed, slots):
    """gather_archive_rows of the archive (whole or row-sharded: each shard
    gathers the rows it owns, the rest are zero, and the shards' rows sum)
    -> rows on home."""
    if not isinstance(a_packed, Sharded):
        return gather_archive_rows(a_packed, slots)
    rows = []
    for p, (lo, hi) in zip(a_packed.parts, bounds_of(a_packed)):
        sl = slots.to(p.device)
        own = (sl >= lo) & (sl < hi)
        r = gather_archive_rows(p, torch.where(own, sl - lo, 0))
        rows.append(torch.where(own[:, None, None], r, 0))
    return all_reduce(a_packed.mesh, rows, "sum")


def _scatter_archive(a_packed, rows, slots, valid):
    """scatter_archive_rows into the archive (whole or row-sharded: each
    shard writes the rows it owns), in place."""
    if not isinstance(a_packed, Sharded):
        return scatter_archive_rows(a_packed, rows, slots, valid)
    for p, (lo, hi) in zip(a_packed.parts, bounds_of(a_packed)):
        dev = p.device
        sl = slots.to(dev)
        own = (sl >= lo) & (sl < hi) & (valid.to(dev) != 0)
        scatter_archive_rows(p, rows.to(dev), torch.where(own, sl - lo, 0),
                             own.to(torch.int32))
    return a_packed


def _write_keys(keys, slot, abs_key):
    """keys with keys[slot[b]] = abs_key[b] where slot[b] < B (slot B is the
    non-write)."""
    def rows(part, lo, hi):
        sl = slot.to(part.device)
        ext = torch.cat([part, part[:1]])
        ext[torch.where((sl >= lo) & (sl < hi), sl - lo,
                        hi - lo).to(torch.int64)] = abs_key.to(part.device)
        return ext[:hi - lo]

    if not isinstance(keys, Sharded):
        return rows(keys, 0, keys.shape[0])
    return Sharded(keys.mesh, [rows(p, lo, hi) for p, (lo, hi)
                               in zip(keys.parts, bounds_of(keys))],
                   keys.extent)


def _shift_packed(packed, shift, cb):
    """The scroll's one-pass shift (shift_canvas, cocs re-anchored) of the
    packed canvas [X, Y, Z, 3], whole or Sharded.  A shard's new planes come
    from the shards that held them: it fetches the old planes of its block
    hull moved by the x-shift (defaults beyond the canvas) and shifts that
    window, whose extent is whole blocks, by the same shift."""
    X, Y, Z, _ = packed.shape
    if not isinstance(packed, Sharded):
        dev = packed.device
        return shift_canvas(packed.reshape(X, Y, 3 * Z), _packed_defaults(Z, dev),
                            shift).reshape(X, Y, Z, 3)
    mesh = packed.mesh
    # past the canvas everything is default, whatever the shift
    sx = max(-cb[0], min(int(shift[0]), cb[0]))
    sh = (sx, int(shift[1]), int(shift[2]))

    def hull(g):
        lo, hi = g * packed.step, (g + 1) * packed.step
        return (lo // VB_WIDTH * VB_WIDTH, -(-hi // VB_WIDTH) * VB_WIDTH)

    # the window [w0, w1) that the shift reads through: the hull and the
    # hull moved by the x-shift; only the moved hull holds old planes
    hulls = [hull(g) for g in range(mesh.size)]
    srcs = [(a + VB_WIDTH * sx, b + VB_WIDTH * sx) for a, b in hulls]
    got = fetch_rows(mesh, [p.reshape(p.shape[0], Y, 3 * Z) for p in packed.parts],
                     X, srcs)
    out = []
    for i, (p, (lo, hi)) in enumerate(zip(packed.parts, bounds_of(packed))):
        (a, b), (s0, _) = hulls[mesh.first + i], srcs[mesh.first + i]
        w0, w1 = a + min(0, VB_WIDTH * sx), b + max(0, VB_WIDTH * sx)
        dflt = _packed_defaults(Z, p.device)
        src = dflt.reshape(1, 1, 3 * Z).expand(w1 - w0, Y, 3 * Z).clone()
        o = max(s0, 0) - w0
        src[o:o + got[i].shape[0]] = got[i]
        res = shift_canvas(src, dflt, sh)
        out.append(res[lo - w0:hi - w0].reshape(hi - lo, Y, Z, 3))
    return Sharded(mesh, out, packed.extent)


def _do_scroll(state: MapState, new_origin_blk, cfg: MapConfig,
               compact_cols: int | None = None,
               old_origin_blk=None) -> MapState:
    """Shift the resident canvas to `new_origin_blk` (three host ints).

    Outgoing present blocks are archived (overwriting the archive row that
    already holds the same key, else appended in linear block order; rows
    beyond max_blocks are dropped and counted); the exposed region resets
    to defaults and is refilled from the archive where it holds the block.
    compact_cols bounds the block-columns that exit or enter (the host's
    bucket; default every column).  old_origin_blk is the current origin as
    host ints when the caller knows it (else it is read from the state).

    The input state is consumed: its archive `a_packed` is updated in place."""
    cb = cfg.canvas_blocks
    cbx, cby, cbz = cb
    B = cfg.max_blocks
    dev = state.present.device
    new = np.asarray(new_origin_blk, np.int64).reshape(3)
    old = (state.origin_blk.cpu().numpy() if old_origin_blk is None
           else np.asarray(old_origin_blk)).astype(np.int64).reshape(3)
    shift = new - old
    ncols = cbx * cby
    compact_cols = min(compact_cols or ncols, ncols)
    old_t = torch.as_tensor(old.astype(np.int32), device=dev)
    new_t = torch.as_tensor(new.astype(np.int32), device=dev)

    profiler.count("scroll.cols", compact_cols)
    with profiler.span("scroll.archive_out"):
        # ---- 1. archive outgoing present blocks -----------------------------
        out_ax = []
        for a, n in enumerate(cb):
            p = torch.arange(n, device=dev) - int(shift[a])
            out_ax.append((p < 0) | (p >= n))
        exits = (out_ax[0][:, None, None] | out_ax[1][None, :, None]
                 | out_ax[2][None, None, :]) & state.present
        old_dir = _arch_directory(state.arch_keys, state.n_arch, old_t, cb)
        have_slot = (old_dir >= 0).reshape(-1)
        exits_f = exits.reshape(-1)
        need_new = exits_f & ~have_slot
        order = torch.cumsum(need_new.to(torch.int32), 0, dtype=torch.int32) - 1
        slot_new = state.n_arch + order
        ok_new = need_new & (slot_new < B)
        slot = torch.where(have_slot, old_dir.reshape(-1),
                           torch.where(ok_new, slot_new, B))
        slot = torch.where(exits_f, slot, B)  # only outgoing blocks write

        bidx_all = torch.arange(cbx * cby * cbz, dtype=torch.int32, device=dev)
        abs_key = _block_pos_vox(bidx_all, cb) // VB_WIDTH + old_t[None, :]
        new_keys = _write_keys(state.arch_keys, slot, abs_key)
        n_need = need_new.sum(dtype=torch.int32)
        granted = torch.minimum(n_need, B - state.n_arch)
        dropped = n_need - granted

        packed = smap(pack_voxels, state.occ_val, state.vox_type, state.dist_sq,
                      state.coc)
        jz = torch.arange(cbz, dtype=torch.int32, device=dev)
        # archive rows anchor cocs to their OWN block origin
        cids, cidv = _compact_ids(exits.any(2).reshape(-1), compact_cols)
        crows = _gather_blocks(packed, cids, cb)
        bidx = cids[:, None] * cbz + jz[None, :]
        crows = shift_packed_coc(
            crows, -_block_pos_vox(bidx.reshape(-1), cb)[:, None, :])
        cslot = torch.where(cidv[:, None], slot[bidx.to(torch.int64)], B).reshape(-1)
        aval = cslot < B
        a_packed = _scatter_archive(state.a_packed, crows,
                                    torch.where(aval, cslot, 0),
                                    aval.to(torch.int32))
        n_arch = state.n_arch + granted

    with profiler.span("scroll.shift"):
        # ---- 2. one-pass shift of the canvas, cocs re-anchored --------------
        packed = _shift_packed(packed, shift, cb)
        present = shift_fill(state.present, shift, False)
        # the per-cell dist bound rolls with the canvas (a block is 2 cells);
        # exposed cells reset to -1, restored cells get the conservative max
        dmax_cell = shift_fill(state.dmax_cell, shift * 2, -1)

    with profiler.span("scroll.archive_in"):
        # ---- 3. load entering blocks from the archive ------------------------
        new_dir = _arch_directory(new_keys, n_arch, new_t, cb)
        entering = ~present & (new_dir >= 0)
        gslot = torch.where(entering, new_dir, 0).reshape(-1)
        ent2 = entering
        for ax in range(3):
            ent2 = ent2.repeat_interleave(2, dim=ax)
        dmax_cell = torch.where(ent2, EMPTY_VALUE, dmax_cell)

        cids2, cidv2 = _compact_ids(entering.any(2).reshape(-1), compact_cols)
        bidx2 = (cids2[:, None] * cbz + jz[None, :]).to(torch.int64)
        valid_b = entering.reshape(-1)[bidx2] & cidv2[:, None]
        slot_b = torch.where(valid_b, gslot[bidx2], 0).reshape(-1)
        grows = _gather_archive(a_packed, slot_b)
        # entering rows re-anchor block-relative -> new-canvas-relative
        grows = shift_packed_coc(grows, _block_pos_vox(bidx2.reshape(-1), cb)[:, None, :])
        packed = _scatter_blocks(packed, grows, cids2,
                                 valid_b.reshape(-1).to(torch.int32), cb)
        present = present | entering

        occ_val, vox_type, dist_sq, coc = smap(unpack_voxels, packed)
    return dataclasses.replace(
        state, origin_blk=new_t, occ_val=occ_val, vox_type=vox_type,
        dist_sq=dist_sq, coc=coc, present=present, arch_keys=new_keys,
        n_arch=n_arch, a_packed=a_packed,
        arch_dropped=state.arch_dropped + dropped, dmax_cell=dmax_cell,
        p1c_ok=torch.zeros((), dtype=torch.bool, device=dev))


def scroll_canvas(state: MapState, new_origin_blk, cfg: MapConfig,
                  compact_cols: int | None = None,
                  old_origin_blk=None) -> MapState:
    """Shift the resident canvas to a new origin (host ints); a zero shift
    returns the state unchanged.  See _do_scroll."""
    old = (state.origin_blk.cpu().numpy() if old_origin_blk is None
           else np.asarray(old_origin_blk))
    if np.array_equal(np.asarray(new_origin_blk).reshape(3), old.reshape(3)):
        return state
    return _do_scroll(state, new_origin_blk, cfg, compact_cols, old)


def stream_extract(state: MapState, changed_blk, carry_blk, rot: int = 0, *,
                   cfg: MapConfig, k_cols: int):
    """Compact changed voxel blocks into archive-format rows for host
    streaming (the JAX package's stream_extract): the changed set, OR-ed
    with the carry of earlier ticks, is served by (x, y) block-column, at
    most k_cols columns per tick in the rotated order (rank - rot) mod
    ncols, via one sort: key = rot_rank * ncols + rank, and a column is
    served iff its key <= the k-th smallest.

    Returns (col_ids int32 [k], col_valid bool [k], rows int32
    [k * cbz, 512, 3], blk_mask bool [k, cbz], leftover bool [bx, by, bz])."""
    cbx, cby, cbz = cb = cfg.canvas_blocks
    ncols = cbx * cby
    dev = changed_blk.device
    want = changed_blk | carry_blk
    col_changed = want.any(2).reshape(-1)
    rank = torch.arange(ncols, dtype=torch.int32, device=dev)
    rot_rank = torch.remainder(rank - int(rot), ncols)
    big = ncols * ncols
    key = torch.where(col_changed, rot_rank * ncols + rank, big)
    skey = torch.sort(key).values[:k_cols]
    valid = skey < big
    ids = torch.where(valid, skey % ncols, 0)
    served = col_changed & (key <= skey[k_cols - 1])
    leftover = want & ~served.reshape(cbx, cby, 1)
    packed = smap(pack_voxels, state.occ_val, state.vox_type, state.dist_sq,
                  state.coc)
    rows = _gather_blocks(packed, ids, cb)
    blk_mask = want.reshape(ncols, cbz)[ids.to(torch.int64)] & valid[:, None]
    return ids, valid, rows, blk_mask, leftover


def np_scroll_counts(present_before, shift_blk, arch_keys, n_arch,
                     new_origin_blk):
    """Host-side (numpy) count of one scroll's block traffic, from the
    present mask before it and the archive after it: (exiting present
    blocks, blocks entering from the archive)."""
    present = np.asarray(present_before, bool)
    cb = present.shape
    s = [int(v) for v in shift_blk]
    stay = np.zeros_like(present)
    src = tuple(slice(max(0, v), min(n, n + v)) for v, n in zip(s, cb))
    dst = tuple(slice(max(0, -v), min(n, n - v)) for v, n in zip(s, cb))
    if all(d.start < d.stop for d in dst):
        stay[dst] = present[src]
    exits = int(present.sum()) - int(stay.sum())
    rel = np.asarray(arch_keys)[:int(n_arch)] - np.asarray(new_origin_blk)
    inside = np.all((rel >= 0) & (rel < np.asarray(cb)), axis=-1)
    held = np.zeros(cb, bool)
    held[tuple(rel[inside].T)] = True
    return exits, int((held & ~stay).sum())


def np_unpack_voxels(rows: np.ndarray):
    """Host-side unpack of packed uint32 [..., 3] rows (numpy; for the
    streaming consumer)."""
    w0 = rows[..., 0]
    dist = (w0 & 0xFFFFF).astype(np.int32)
    occ = ((w0 >> 20) & 0xFF).astype(np.uint8)
    typ = ((w0 >> 28) & 0xF).astype(np.int8)
    cx = (rows[..., 1] & 0xFFFF).astype(np.uint16).view(np.int16)
    cy = ((rows[..., 1] >> 16) & 0xFFFF).astype(np.uint16).view(np.int16)
    cz = (rows[..., 2] & 0xFFFF).astype(np.uint16).view(np.int16)
    return occ, typ, dist, np.stack([cx, cy, cz], axis=-1)


def canvas_geometry(cfg: MapConfig, pvt: np.ndarray, motion=None):
    """Host-side: canvas origin (block-aligned) for a pivot; a copy of the
    JAX package's map_state.canvas_geometry (motion-biased placement).

    Returns (canvas_origin_blk int32[3], canvas_origin_vox int32[3],
    window_offset int32[3]) with window_offset = pvt - canvas_origin_vox."""
    pvt = np.asarray(pvt, np.int64)
    if np.abs(pvt).max() > (1 << 30):
        raise ValueError("pivot beyond +-2^30 voxels: int32 grid coordinates "
                         "would overflow")
    halo = cfg.halo_grids
    cb = np.asarray(cfg.canvas_blocks, np.int64)
    cs = cb * VB_WIDTH
    local = np.asarray(cfg.local_size, np.int64)
    centered = np.floor((pvt + local // 2 - cs // 2) / VB_WIDTH + 0.5).astype(np.int64)
    o_min = -(-(pvt + local + halo - cs) // VB_WIDTH)  # ceil div
    o_max = np.floor_divide(pvt - halo, VB_WIDTH)
    tgt = centered.copy()
    bias = getattr(cfg, "scroll_bias", 0.5)
    if motion is not None and bias != 0.5:
        m = np.asarray(motion)
        for ax in range(3):
            if m[ax] > 0:
                tgt[ax] = round(centered[ax]
                                + (o_max[ax] - centered[ax]) * (2 * bias - 1))
            elif m[ax] < 0:
                tgt[ax] = round(centered[ax]
                                + (o_min[ax] - centered[ax]) * (2 * bias - 1))
    origin_blk = np.clip(tgt, o_min, o_max)
    origin_vox = origin_blk * VB_WIDTH
    off = pvt - origin_vox
    if not (np.all(off >= halo) and np.all(off + local + halo <= cs)):
        raise AssertionError("window+halo must fit inside canvas")
    return origin_blk.astype(np.int32), origin_vox.astype(np.int32), off.astype(np.int32)
