"""Exact 3-phase separable EDT with closest-obstacle coordinates (coc).

Counterpart of gie_mapping_tpu/ops/edt_batch.py on its default chain
("allin": packed phase 1, packed phase-2 envelope, middle-axis phase-3
envelope, z-major lanes):

  phase 1 (along y)   ops/kernels/phase1.py::phase1_packed   [X, Y, Z]
  phase 2 (along x)   ops/kernels/envelope.py::envelope_packed on [X, Z, Y]
  phase 3 (along z)   ops/kernels/envelope.py::envelope_mid    on [X, Z, Y]

and, on a one-voxel-deep (Z == 1) grid, phase 1 then the generic
ops/kernels/envelope.py::envelope along x on [X, 1, Y], with no phase 3.

Outputs are bit-identical to the JAX package's batch_edt / batch_edt_slab:
  dist_sq int32 [..] squared distance (EMPTY_VALUE where no site reachable),
  coc int32 [.., 3] canvas coordinate of the closest site (INVALID_COC),
  valid bool.
"""
from __future__ import annotations

import torch

from ..utils.constants import EMPTY_VALUE, INVALID_COC
from .kernels.envelope import (env_idx_bits, envelope, envelope_mid,
                               envelope_packed)
from .kernels.phase1 import phase1_pack_bits, phase1_packed

_BIG = 1 << 28  # "infinite" squared cost of a lane without a site


def _zyx(a: torch.Tensor) -> torch.Tensor:
    """[X, Y, Z] <-> [X, Z, Y] (contiguous)."""
    return a.permute(0, 2, 1).contiguous()


def _phase3_inputs(pk2, pay2t, ib2):
    d2t = pk2 >> ib2
    site2t = pk2 & ((1 << ib2) - 1)
    d2m = torch.where((pay2t & 1) > 0, d2t, _BIG)
    pay3 = (site2t << 11) | pay2t
    return d2m, pay3


def _finish(dist_sq, coc_x, coc_y, coc_z, valid):
    dist_sq = torch.where(valid, dist_sq, EMPTY_VALUE).to(torch.int32)
    coc = torch.stack([torch.where(valid, c, INVALID_COC)
                       for c in (coc_x, coc_y, coc_z)], dim=-1).to(torch.int32)
    return {"dist_sq": dist_sq, "coc": coc, "valid": valid}


def _batch_edt_2d(p1_packed, yb, ib2):
    """The Z == 1 grid: phase 2 along x through the generic envelope on the
    [X, 1, Y] layout, no phase 3, coc_z = 0.  The JAX package runs phase 1
    through XLA here; unpacking the packed word differs from it only in the
    payload of site-free lanes, which the valid mask drops."""
    g1sq = torch.where((p1_packed & 1) > 0, p1_packed >> (yb + 1), _BIG)
    pay2 = p1_packed & ((1 << (yb + 1)) - 1)
    pk2, pay2t = envelope(_zyx(g1sq), _zyx(pay2))                 # [X, 1, Y]
    pk2, pay2s = _zyx(pk2), _zyx(pay2t)                          # [X, Y, 1]
    return _finish(pk2 >> ib2, pk2 & ((1 << ib2) - 1), pay2s >> 1,
                   torch.zeros_like(pk2), (pay2s & 1) > 0)


def batch_edt(vox_type: torch.Tensor, max_width: int,
              p1_packed: torch.Tensor | None = None) -> dict:
    """EDT of an int8 [X, Y, Z] type canvas (OCCUPIED voxels are sites).

    p1_packed: the packed phase-1 word of this canvas (phase1_packed), when
    the caller maintains it; phase 1 is then skipped."""
    X, Y, Z = vox_type.shape
    yb = phase1_pack_bits(Y)
    if p1_packed is None:
        p1_packed = phase1_packed(vox_type, max_width)
    ib2 = env_idx_bits(X)
    if Z == 1:
        return _batch_edt_2d(p1_packed, yb, ib2)
    pk2, pay2t = envelope_packed(_zyx(p1_packed), yb)            # [X, Z, Y]
    d2m, pay3 = _phase3_inputs(pk2, pay2t, ib2)
    ib3 = env_idx_bits(Z)
    pk3, pay3s = envelope_mid(d2m, pay3)                        # [X, Z, Y]
    d3 = pk3 >> ib3
    coc_z3 = pk3 & ((1 << ib3) - 1)
    zbits = (Z - 1).bit_length() + 1
    d3c = torch.clamp(d3, max=(1 << (30 - zbits)) - 1)
    packed_c = _zyx((d3c << (zbits + 1)) | (coc_z3 << 1) | (pay3s & 1))
    pay3b = _zyx(pay3s)                                          # [X, Y, Z]
    return _finish(packed_c >> (zbits + 1), pay3b >> 11,
                   (pay3b >> 1) & ((1 << 10) - 1),
                   (packed_c >> 1) & ((1 << zbits) - 1), (packed_c & 1) > 0)


def batch_edt_slab(vox_type: torch.Tensor, x0: int, y0: int, *, sx: int,
                   sy: int, max_width: int,
                   p1_packed: torch.Tensor | None = None) -> dict:
    """batch_edt restricted to the output slab [x0:x0+sx, y0:y0+sy, :].

    Only the lanes are sliced; every phase scans its complete site axis, so
    the slab equals the same voxels of a full batch_edt.  x0, y0 are host
    ints (the caller clamps them so the slab fits)."""
    X, Y, Z = vox_type.shape
    if Z <= 1:
        raise ValueError("batch_edt_slab requires a 3-D canvas (Z > 1)")
    if not (0 <= x0 <= X - sx and 0 <= y0 <= Y - sy):
        raise ValueError(f"slab [{x0}:+{sx}, {y0}:+{sy}] outside {X}x{Y}")
    yb = phase1_pack_bits(Y)
    if p1_packed is None:
        p1_packed = phase1_packed(vox_type, max_width)
    ib2 = env_idx_bits(X)
    pp = _zyx(p1_packed[:, y0:y0 + sy])                          # [X, Z, sy]
    pk2, pay2t = envelope_packed(pp, yb)
    d2m, pay3 = _phase3_inputs(pk2, pay2t, ib2)
    ib3 = env_idx_bits(Z)
    pk3, pay3o = envelope_mid(d2m[x0:x0 + sx].contiguous(),
                              pay3[x0:x0 + sx].contiguous())     # [sx, Z, sy]
    d3 = _zyx(pk3 >> ib3)
    coc_z = _zyx(pk3 & ((1 << ib3) - 1))
    pay3b = _zyx(pay3o)                                          # [sx, sy, Z]
    return _finish(d3, pay3b >> 11, (pay3b >> 1) & ((1 << 10) - 1), coc_z,
                   (pay3b & 1) > 0)
