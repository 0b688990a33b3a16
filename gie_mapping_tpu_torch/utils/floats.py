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

XLA's CPU sin and cos are the C library's sinf and cosf, which neither
PyTorch's sin nor CUDA's sinf reproduces (nor the correctly rounded
value): `sinf_exact` and `cosf_exact` carry glibc's algorithm.
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


def ftz_f32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` with subnormal values flushed to zero of the same sign,
    as XLA's CPU code runs (flush-to-zero and denormals-are-zero)."""
    return torch.where(a.abs() < 2.0 ** -126, a * 0, a)


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


# glibc's single-precision sine and cosine (sysdeps/ieee754/flt-32/s_sinf.c,
# s_cosf.c, sincosf.h, sincosf_data.c; glibc >= 2.28), whose table holds
# the polynomials in the order c0, c1, s1, c2, s2, c3, s3, c4; the second
# table (quadrants 2 and 3) negates the cosine's.
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2 / pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")  # pi / 2
_COS = tuple(float.fromhex(v) for v in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN = tuple(float.fromhex(v) for v in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_ABSTOP12_PIO4 = 0x3F4  # abstop12(float(pi / 4)): |y| < 0.75
_ABSTOP12_TINY = 0x398  # abstop12(0x1p-12f)


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """glibc's sinf (cos False) or cosf of float32 `y`, |y| < 120, in
    float64 tensor operations (one rounding to float32 at the end).  The
    quadrant comes from reduce_fast as compiled where the C library has no
    round-to-integer instruction (x86-64): n = (int(x * 2/pi * 2^24) +
    2^23) >> 24; for |y| <= pi, n * pi/2 is exact, so whether the C
    compiler fuses x - n * pi/2 cannot matter."""
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    n = ((x * _HPI_INV).trunc().long() + 0x800000) >> 24
    n = torch.where(top < _ABSTOP12_PIO4, 0, n)
    xr = x - n.double() * _HPI
    xs = torch.where((n & 3) == 1, -xr, torch.where((n & 3) == 2, -xr, xr))
    x2 = xr * xr
    # sinf_poly's two branches: the odd quadrant takes the cosine
    x3 = xs * x2
    sin = (xs + x3 * _SIN[0]) + (x3 * x2) * (_SIN[1] + x2 * _SIN[2])
    sg = torch.where((n & 2) != 0, -1.0, 1.0).double()
    c1 = sg * _COS[0] + x2 * (sg * _COS[1])
    x4 = x2 * x2
    c = c1 + x4 * (sg * _COS[2])
    c2 = sg * _COS[3] + x2 * (sg * _COS[4])
    cosv = c + (x4 * x2) * c2
    odd = ((n ^ 1) if cos else n) & 1
    out = torch.where(odd != 0, cosv, sin).float()
    tiny = top < _ABSTOP12_TINY
    return torch.where(tiny, torch.ones_like(y) if cos else y, out)


def sinf_exact(y: torch.Tensor) -> torch.Tensor:
    """The C library's (glibc's) single-precision sin of float32 `y`,
    elementwise, for |y| <= pi."""
    return _sincosf(y, cos=False)


def cosf_exact(y: torch.Tensor) -> torch.Tensor:
    """The C library's (glibc's) single-precision cos of float32 `y`,
    elementwise, for |y| <= pi."""
    return _sincosf(y, cos=True)
