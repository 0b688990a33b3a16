"""Float32 arithmetic rounded exactly as the JAX package's CPU reference
rounds it, on every device.

Three PyTorch defaults would otherwise move results by an ulp, and an ulp
moves a voxel across a panorama bin edge:
  * CUDA divides by a Python scalar as a multiply by its reciprocal (so a
    constant's reciprocal is rounded here, on the host);
  * the vectorised CPU float32 sqrt is off by one ulp for ~0.6 % of inputs,
    and the float64 one is not always correctly rounded either;
  * XLA contracts some multiply-adds into fused multiply-adds, which
    PyTorch has no operator for.
And one XLA rewrite must be copied: inside a jitted program XLA turns a
division by a compile-time constant into a multiply by the constant's
float32 reciprocal (`div_const`); a division by a traced value stays an
IEEE division.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def recip_f32(d: float) -> float:
    """The float32 reciprocal 1 / float32(d), correctly rounded, as a
    Python float (exact in float32)."""
    return float(np.float32(1) / np.float32(d))


def div_const(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d as XLA's jitted code computes a division by a constant: a
    times the float32 reciprocal of d (the multiply on a's device)."""
    return a * torch.tensor(recip_f32(d), dtype=a.dtype, device=a.device)


def sqrt_f32(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of float32 `a`.

    The float64 root rounded to float32 is right if that root is correctly
    rounded (float64 carries more than 2 * 24 + 2 bits), but PyTorch's CPU
    float64 sqrt has been seen to misround roots that lie a hair from a
    float32 midpoint.  So the exact squares of the two midpoints next to
    the result settle it: a midpoint has 25 significant bits, its square
    at most 50, exact in float64, and no float32 `a` equals one."""
    a64 = a.double()
    r = torch.sqrt(a64).float()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    dn = torch.nextafter(r, torch.full_like(r, -math.inf))
    r64 = r.double()
    m_up = (r64 + up.double()) * 0.5
    m_dn = (r64 + dn.double()) * 0.5
    r = torch.where(m_up * m_up < a64, up, r)
    return torch.where((r > 0) & (m_dn * m_dn > a64), dn, r)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 a*b + c (one rounding).

    The product is exact in float64 and the sum rounds once there; the only
    way the float64 -> float32 rounding can then disagree with a single
    rounding is a result exactly halfway between two floats, which the exact
    residual of the float64 sum (TwoSum) resolves."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    f = s.float()
    up = torch.nextafter(f, torch.full_like(f, math.inf))
    dn = torch.nextafter(f, torch.full_like(f, -math.inf))
    f64 = f.double()
    tie_up = s == (f64 + up.double()) * 0.5
    tie_dn = s == (f64 + dn.double()) * 0.5
    f = torch.where(tie_up & (err > 0), up, f)
    return torch.where(tie_dn & (err < 0), dn, f)
