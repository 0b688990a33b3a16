"""EDT phase 1 with the packed output word: kernel wrapper + plain version.

Counterpart of gie_mapping_tpu/ops/pallas/phase1.py::phase1_packed_pallas;
the CUDA kernel is csrc/phase1.cu.  Per voxel of an [X, Y, Z] canvas
(yb = bits(Y - 1)):

    packed = valid ? (g1^2 << (yb + 1)) | (coc_y << 1) | 1 : 0

g1 is the distance along y to the nearest OCCUPIED voxel (ties go to the
lower y), valid = g1 < max_width.
"""
from __future__ import annotations

import functools

import torch

from ...utils.constants import VOX_OCCUPIED
from . import _build

def phase1_fits(Y: int) -> bool:
    """True iff the packed word has room (Y <= 1024)."""
    yb = (Y - 1).bit_length() if Y > 1 else 1
    return 3 * yb + 1 <= 31


def phase1_pack_bits(Y: int) -> int:
    """yb of the packed word: packed = (g1sq << (yb+1)) | (coc_y << 1) | valid."""
    yb = (Y - 1).bit_length() if Y > 1 else 1
    if 3 * yb + 1 > 31:
        raise ValueError(f"phase-1 packing needs Y <= 1024, got {Y}")
    return yb


def phase1_packed_plain(vox_type: torch.Tensor, max_width: int) -> torch.Tensor:
    """Plain PyTorch version: running max/min of the occupied index."""
    X, Y, Z = vox_type.shape
    yb = phase1_pack_bits(Y)
    occ = vox_type == VOX_OCCUPIED
    y_idx = torch.arange(Y, dtype=torch.int32, device=vox_type.device)[None, :, None]
    big = 1 << 29
    last_le = torch.cummax(torch.where(occ, y_idx, -1), dim=1).values
    rev = torch.where(occ, y_idx, big).flip(1)
    next_ge = torch.cummin(rev, dim=1).values.flip(1)
    d_fwd = torch.where(last_le >= 0, y_idx - last_le, max_width)
    d_bwd = torch.where(next_ge < big, next_ge - y_idx, max_width)
    g1 = torch.clamp(torch.minimum(d_fwd, d_bwd), max=max_width)
    coc_y = torch.where(d_fwd <= d_bwd, last_le, next_ge)
    valid = g1 < max_width
    g1c = torch.where(valid, g1, 0)
    cocc = torch.where(valid, coc_y, 0)
    word = ((g1c * g1c) << (yb + 1)) | (cocc << 1) | 1
    return torch.where(valid, word, 0).to(torch.int32)


def phase1_tile(X: int, Z: int, wave: int) -> int:
    """z-columns per CTA: 8 where the grid (X times the z-tiles) then fits
    one wave of the card (`wave`: the CTAs of the 8-column kernel that it
    holds at once, phase1_wave), else 16; at most Z rounded up to a power of
    two.  Of the widths 1 to 32, 8 ran fastest on an H100 wherever its grid
    fit one wave, 16 at the full canvas (PERF.md)."""
    tz = 8 if X * -(-Z // 8) <= wave else 16
    return min(tz, 1 << (Z - 1).bit_length())


@functools.lru_cache(maxsize=None)
def phase1_wave(index: int) -> int:
    """The CTAs of the 8-column kernel that CUDA device `index` holds at
    once: its SM count times the occupancy the driver reports for this
    build."""
    with torch.cuda.device(index):
        n = _build.fn("gie_phase1_ctas_per_sm")()
    if n <= 0:
        raise RuntimeError(f"gie_phase1_ctas_per_sm: CUDA error {-n}")
    return n * torch.cuda.get_device_properties(index).multi_processor_count


def phase1_packed(vox_type: torch.Tensor, max_width: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Packed phase-1 word of an int8 [X, Y, Z] type canvas (OCCUPIED voxels
    are the sites).  `out` (int32, same shape, contiguous) receives the
    result in place, e.g. an x-slab view of the phase-1 cache.

    CPU tensors take the plain version; CUDA tensors launch the kernel with
    phase1_tile's z-columns per CTA."""
    if vox_type.dim() != 3 or vox_type.dtype != torch.int8:
        raise TypeError(f"phase1_packed wants int8 [X, Y, Z], got "
                        f"{vox_type.dtype} {tuple(vox_type.shape)}")
    if out is not None and (out.shape != vox_type.shape
                            or out.dtype != torch.int32
                            or out.device != vox_type.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous int32 tensor shaped like "
                         "vox_type on the same device")
    if vox_type.device.type == "cpu":
        res = phase1_packed_plain(vox_type, max_width)
        if out is None:
            return res
        out.copy_(res)
        return out
    if vox_type.device.type != "cuda":
        raise ValueError(f"phase1_packed: unsupported device {vox_type.device}")
    X, Y, Z = vox_type.shape
    yb = phase1_pack_bits(Y)
    src = vox_type.contiguous()
    if out is None:
        out = torch.empty(vox_type.shape, dtype=torch.int32,
                          device=vox_type.device)
    with _build.on_device_of(src):
        rc = _build.fn("gie_phase1_packed")(
            src.data_ptr(), out.data_ptr(), X, Y, Z, yb, int(max_width),
            phase1_tile(X, Z, phase1_wave(src.get_device())), _build.stream_of(src))
    phase1_packed.launches += 1
    _build.check("gie_phase1_packed", rc)
    return out


phase1_packed.launches = 0
