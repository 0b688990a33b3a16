"""Canvas scroll shift with the fused coc re-anchor: kernel wrapper + plain
version.

Counterpart of gie_mapping_tpu/ops/pallas/blockrows.py::shift_canvas_pallas
(called there with reanchor_blk = shift_blk); the CUDA kernel is
csrc/shift.cu.  On the packed canvas view cv [X, Y, L] (L = 3 * Z, int32 bit
patterns of the packed uint32 words) and a block shift (s0, s1, s2):

    out[x, y, l] = cv[x + 8 s0, y + 8 s1, l + 24 s2]   (defaults[l] where
                                                        the source is out)

and then, per 16-bit half, lane l % 3 == 1 (cx | cy << 16) takes
lo - 8 s0, hi - 8 s1 and lane 2 (cz) takes lo - 8 s2, mod 2^16; a half
equal to the 0x7FFF sentinel passes through.  Any shift is one pass, a
shift of at least the canvas gives all defaults.
"""
from __future__ import annotations

import torch

from . import _build

VB = 8  # voxels per block edge


def _reanchor_plain(w: torch.Tensor, shift_blk) -> torch.Tensor:
    """The fused coc re-anchor of the shift, on int32 words [..., L]."""
    L = w.shape[-1]
    u = w.to(torch.int64) & 0xFFFFFFFF
    lane = torch.arange(L, device=w.device) % 3
    rx, ry, rz = ((VB * int(s)) & 0xFFFF for s in shift_blk)
    lo = u & 0xFFFF
    hi = u >> 16
    lo_delta = torch.where(lane == 1, rx, rz)
    new_lo = torch.where(lo == 0x7FFF, lo, (lo - lo_delta) & 0xFFFF)
    new_hi = torch.where((lane == 1) & (hi != 0x7FFF), (hi - ry) & 0xFFFF, hi)
    out = torch.where(lane == 0, u, new_lo | (new_hi << 16))
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)


def shift_canvas_plain(cv: torch.Tensor, defaults: torch.Tensor,
                       shift_blk) -> torch.Tensor:
    """Plain version of shift_canvas."""
    X, Y, L = cv.shape
    out = defaults.reshape(1, 1, L).expand(X, Y, L).clone()
    src, dst = [], []
    for s, n in zip((VB * int(shift_blk[0]), VB * int(shift_blk[1]),
                     3 * VB * int(shift_blk[2])), (X, Y, L)):
        lo, hi = max(0, -s), min(n, n - s)
        if hi <= lo:
            return _reanchor_plain(out, shift_blk)
        dst.append(slice(lo, hi))
        src.append(slice(lo + s, hi + s))
    out[tuple(dst)] = cv[tuple(src)]
    return _reanchor_plain(out, shift_blk)


def shift_canvas(cv: torch.Tensor, defaults: torch.Tensor,
                 shift_blk) -> torch.Tensor:
    """Scroll shift of the packed canvas view cv int32 [X, Y, L] by the
    block shift `shift_blk` (three host ints), exposed lanes filled from
    defaults int32 [L], cocs re-anchored.  Returns a new tensor (an in-place
    shift would race).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if cv.dim() != 3 or cv.dtype != torch.int32 or defaults.dtype != torch.int32:
        raise TypeError(f"shift_canvas wants int32 [X, Y, L] and int32 [L], got "
                        f"{cv.dtype} {tuple(cv.shape)}, {defaults.dtype}")
    X, Y, L = cv.shape
    if X % VB or Y % VB or L % (3 * VB) or defaults.numel() != L:
        raise ValueError(f"shift_canvas: canvas {tuple(cv.shape)} is not whole "
                         f"blocks, or defaults has {defaults.numel()} != {L} lanes")
    if defaults.device != cv.device:
        raise ValueError("shift_canvas: inputs on different devices")
    s = [int(v) for v in shift_blk]
    if cv.device.type == "cpu":
        return shift_canvas_plain(cv, defaults, s)
    if cv.device.type != "cuda":
        raise ValueError(f"shift_canvas: unsupported device {cv.device}")
    src = cv.contiguous()
    dflt = defaults.reshape(L).contiguous()
    out = torch.empty_like(src)
    for t in (src, dflt, out):
        if t.data_ptr() % 16:
            raise ValueError("shift_canvas: tensors must be 16-byte aligned")
    # a shift past the canvas empties it whatever its size: clamp the source
    # offset (int32-safe), keep the full shift for the re-anchor (mod 2^16)
    cl = [max(-(n // VB) - 1, min(v, n // VB + 1)) for v, n in zip(s, (X, Y, L // 3))]
    with _build.on_device_of(src):
        rc = _build.fn("gie_shift_canvas")(
            src.data_ptr(), out.data_ptr(), dflt.data_ptr(), X, Y, L,
            VB * cl[0], VB * cl[1], 3 * VB * cl[2], (VB * s[0]) & 0xFFFF,
            (VB * s[1]) & 0xFFFF, (VB * s[2]) & 0xFFFF, _build.stream_of(src))
    shift_canvas.launches += 1
    _build.check("gie_shift_canvas", rc)
    return out


shift_canvas.launches = 0
