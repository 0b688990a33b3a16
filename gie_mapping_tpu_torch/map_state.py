"""Map state of the PyTorch port: the resident canvas + block archive.

Counterpart of gie_mapping_tpu/map_state.py.  The fields, dtypes and
meanings are the JAX package's (`MapState` there documents each), with one
representational change: the archive `a_packed` holds its uint32 words as
an int32 bit pattern, because PyTorch's uint32 arithmetic is thin;
`state_to_numpy` / `state_from_numpy` convert at the boundary.

The canvas scroll (archive I/O, canvas shift, coc re-anchor) is not ported
yet.  `place_fresh` covers the one scroll every run makes, the first
placement of a fresh map, which moves no data.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

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
    def create(cfg: MapConfig, device=None) -> "MapState":
        from .models.pipeline import p1_cache_enabled

        dev = torch.device(device) if device is not None else torch.device("cpu")
        cs = cfg.canvas_size
        cb = cfg.canvas_blocks
        B = cfg.max_blocks
        rows = torch.from_numpy(_PACKED_DEFAULT_ROW.view(np.int32).copy())
        return MapState(
            origin_blk=torch.zeros(3, dtype=torch.int32, device=dev),
            occ_val=torch.zeros(cs, dtype=torch.uint8, device=dev),
            vox_type=torch.full(cs, VOX_UNKNOWN, dtype=torch.int8, device=dev),
            dist_sq=torch.full(cs, EMPTY_VALUE, dtype=torch.int32, device=dev),
            coc=torch.full(cs + (3,), int(COC_INVALID16), dtype=torch.int16,
                           device=dev),
            present=torch.zeros(cb, dtype=torch.bool, device=dev),
            arch_keys=torch.full((B, 3), int(EMPTY_KEY), dtype=torch.int32,
                                 device=dev),
            n_arch=torch.zeros((), dtype=torch.int32, device=dev),
            a_packed=rows.to(dev).expand(B, ROW_WORDS).contiguous(),
            arch_dropped=torch.zeros((), dtype=torch.int32, device=dev),
            dmax_cell=torch.full(tuple(c // 4 for c in cs), EMPTY_VALUE,
                                 dtype=torch.int32, device=dev),
            p1c=torch.zeros(cs if p1_cache_enabled(cfg) else (1, 1, 1),
                            dtype=torch.int32, device=dev),
            p1c_ok=torch.zeros((), dtype=torch.bool, device=dev),
        )


FIELDS = tuple(f.name for f in dataclasses.fields(MapState))


def state_to_numpy(state: MapState) -> dict:
    """{field: numpy array} with the JAX package's dtypes (a_packed uint32)."""
    out = {}
    for name in FIELDS:
        a = getattr(state, name).detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name == "a_packed" else a
    return out


def state_from_numpy(arrays: dict, device=None) -> MapState:
    """MapState from {field: numpy array} as `state_to_numpy` gives them (or
    as the JAX package's MapState leaves convert with np.asarray)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    kw = {}
    for name in FIELDS:
        a = np.array(arrays[name], order="C")  # a copy; keeps 0-d arrays 0-d
        if name == "a_packed":
            a = a.astype(np.uint32, copy=False).view(np.int32)
        kw[name] = torch.from_numpy(a).to(dev)
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


def is_fresh(state: MapState) -> bool:
    """True while no block was ever allocated and nothing was archived: the
    canvas then holds only defaults (host sync)."""
    return not bool(state.present.any()) and int(state.n_arch) == 0


def place_fresh(state: MapState, new_origin_blk, cfg: MapConfig):
    """Move a FRESH map's canvas to `new_origin_blk` (block coords).

    The JAX package's scroll (map_state.py::_do_scroll) changes exactly
    three fields of a fresh map: origin_blk, dmax_cell (shifted by two cells
    per block, -1 fill) and p1c_ok (False).  Nothing exits (no present
    block) and nothing enters (empty archive).  Returns (state, enter_shift
    int numpy [3] in voxels) — the shift the frame's change gate needs.

    Raises NotImplementedError for any other state: moving data is the
    canvas scroll, which the port does not have yet."""
    if not is_fresh(state):
        raise NotImplementedError(
            "canvas scroll of a populated map is not ported yet "
            "(gie_mapping_tpu/map_state.py::_do_scroll); the port only "
            "places a fresh map")
    new = np.asarray(new_origin_blk, np.int64).reshape(3)
    old = state.origin_blk.cpu().numpy().astype(np.int64)
    shift = new - old
    state = dataclasses.replace(
        state,
        origin_blk=torch.as_tensor(new.astype(np.int32),
                                   device=state.origin_blk.device),
        dmax_cell=shift_fill(state.dmax_cell, shift * 2, -1),
        p1c_ok=torch.zeros((), dtype=torch.bool, device=state.p1c_ok.device),
    )
    return state, (shift * VB_WIDTH).astype(np.int32)


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
