"""Exact 3-phase separable EDT with closest-obstacle coordinates (coc).

Counterpart of gie_mapping_tpu/ops/edt_batch.py on its default chain
("allin": packed phase 1, packed phase-2 envelope, middle-axis phase-3
envelope, z-major lanes):

  phase 1 (along y)   ops/kernels/phase1.py::phase1_packed   [X, Y, Z]
  phase 2 (along x)   ops/kernels/envelope.py::envelope_packed on [X, Z, Y]
  phase 3 (along z)   ops/kernels/envelope.py::envelope_mid    on [X, Z, Y]

and, on a one-voxel-deep (Z == 1) grid, phase 1 then the generic
ops/kernels/envelope.py::envelope along x on [X, 1, Y], with no phase 3.

Over a device mesh (parallel/mesh.py), batch_edt_sharded /
batch_edt_sharded_slab run the JAX package's sharded arms: each phase on
the shard of mesh device i, the two phase boundaries as all_to_all
reshards (the distributed separable-transform layout):

  phase 1 (along y)   phase1_packed on the x-shard          [X/n, Y, Z]
  reshard 1           [X/n, Z, Y] -> all_to_all              [X, Z/n, Y]
  phase 2 (along x)   envelope_packed                        [X, Z/n, Y]
  reshard 2           [Z/n, X, Y] -> all_to_all              [Z, X/n, Y]
  phase 3 (along z)   the generic envelope                   [Z, X/n, Y]

and the outputs stay x-shards [X/n, Y, Z], each on its shard's device (the
canvas is stored so between frames; parallel/mesh.py).  Phase 3 runs the generic
envelope on the resharded layout, as the JAX package's sharded path does,
not envelope_mid; both are exact, so the outputs equal batch_edt's.

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
from ..parallel.mesh import Sharded, all_to_all

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
    pk3, pay3s = envelope_mid(d2m, pay3)                        # [X, Z, Y]
    return _phase3_outputs(pk3, pay3s)


def _phase3_outputs(pk3, pay3s):
    """batch_edt's result from phase 3's packed words and payloads
    [X, Z, Y], transposed back to [X, Y, Z]."""
    Z = pk3.shape[1]
    ib3 = env_idx_bits(Z)
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


def sharded_edt_ok(shape, mesh) -> bool:
    """Whether batch_edt_sharded supports this (shape, mesh)."""
    if mesh is None:
        return False
    X, Y, Z = shape
    n = mesh.size
    return n > 1 and Z > 1 and X % n == 0 and Z % n == 0


def _edt_sharded(vox_type: Sharded, max_width, y0=0, sy=None):
    """The sharded chain over the y lanes [y0, y0 + sy) (all of x and z).
    Returns the canvas-layout outputs as x-shards [X/n, sy, Z]."""
    if not isinstance(vox_type, Sharded):
        raise TypeError("the sharded EDT takes the canvas as x-shards "
                        "(parallel.mesh.Sharded)")
    mesh = vox_type.mesh
    X, Y, Z = vox_type.shape
    if not sharded_edt_ok(vox_type.shape, mesh):
        raise ValueError(f"the sharded EDT needs Z > 1 and X, Z divisible "
                         f"by the mesh size {mesh.size}; got {X}x{Y}x{Z}")
    sy = Y if sy is None else sy
    if not 0 <= y0 <= Y - sy:
        raise ValueError(f"y-slab [{y0}:+{sy}] outside Y = {Y}")
    yb = phase1_pack_bits(Y)
    ib2, ib3 = env_idx_bits(X), env_idx_bits(Z)
    zbits = (Z - 1).bit_length() + 1
    # phase 1 on each x-shard; the y-slab is cut before the first reshard,
    # so both reshards move sy / Y of the canvas
    f2 = all_to_all([_zyx(phase1_packed(t, max_width)[:, y0:y0 + sy])
                     for t in vox_type.parts], 1, 0, mesh)     # [X, Z/n, sy]
    d2m, pay3 = [], []
    for f in f2:
        d, p = _phase3_inputs(*envelope_packed(f, yb), ib2)
        d2m.append(d.movedim(1, 0))                             # [Z/n, X, sy]
        pay3.append(p.movedim(1, 0))
    d2m = all_to_all(d2m, 1, 0, mesh)                           # [Z, X/n, sy]
    pay3 = all_to_all(pay3, 1, 0, mesh)
    outs = []
    for f, p in zip(d2m, pay3):
        pk3, pay3s = envelope(f, p)
        d3c = torch.clamp(pk3 >> ib3, max=(1 << (30 - zbits)) - 1)
        coc_z3 = pk3 & ((1 << ib3) - 1)
        packed_c = ((d3c << (zbits + 1)) | (coc_z3 << 1)
                    | (pay3s & 1)).movedim(0, 2)                # [X/n, sy, Z]
        pay3b = pay3s.movedim(0, 2)
        outs.append(_finish(packed_c >> (zbits + 1), pay3b >> 11,
                            (pay3b >> 1) & ((1 << 10) - 1),
                            (packed_c >> 1) & ((1 << zbits) - 1),
                            (packed_c & 1) > 0))
    return {k: Sharded(mesh, [o[k] for o in outs], X) for k in outs[0]}


def batch_edt_sharded(vox_type: Sharded, max_width: int, mesh=None) -> dict:
    """batch_edt over a canvas sharded along x on a 1-D device mesh (the
    JAX package's batch_edt_sharded; see the module docstring).  vox_type
    is the canvas's x-shards (parallel.mesh.Sharded); the outputs come back
    as x-shards [X/n, Y, Z], equal to batch_edt's.  Requires
    sharded_edt_ok(vox_type.shape, mesh); `mesh`, if given, must be the
    shards' own."""
    _same_mesh(vox_type, mesh)
    return _edt_sharded(vox_type, max_width)


def batch_edt_sharded_slab(vox_type: Sharded, y0: int, *, sy: int,
                           max_width: int, mesh=None) -> dict:
    """batch_edt_sharded restricted to the y-slab [y0:y0+sy] (all x, all
    z): x is the sharded axis and z a site axis, so only the y lanes are
    sliced.  y0 is a host int (the caller clamps it so the slab fits).
    Returns {"dist_sq", "coc", "valid"} as x-shards [X/n, sy, Z], equal to
    the same voxels of batch_edt."""
    _same_mesh(vox_type, mesh)
    return _edt_sharded(vox_type, max_width, y0, sy)


def _same_mesh(t, mesh):
    if mesh is not None and isinstance(t, Sharded) and t.mesh != mesh:
        raise ValueError("batch_edt_sharded: the shards lie on another mesh")
