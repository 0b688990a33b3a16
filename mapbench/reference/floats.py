"""Float32 helpers of the plain reference: a correctly rounded fused
multiply-add, and the frame change as the published program rounds it."""
from __future__ import annotations

import math

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding.  The product of two float32
    values is exact in float64, so only the float64 sum can round; its
    exact error (TwoSum) settles the one case where rounding that sum to
    float32 differs from rounding the exact value: a sum that lands on a
    float32 midpoint."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    v = s - p
    err = (p - (s - v)) + (c64 - v)
    f = s.float()
    up = torch.nextafter(f, torch.full_like(f, math.inf))
    dn = torch.nextafter(f, torch.full_like(f, -math.inf))
    tie_up = (s == (f.double() + up.double()) * 0.5) & (err > 0)
    tie_dn = (s == (f.double() + dn.double()) * 0.5) & (err < 0)
    return torch.where(tie_up, up, torch.where(tie_dn, dn, f))


def to_sensor(rel: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Sensor-frame coordinates rel @ rot of world offsets rel [..., 3]
    (float32), rounded as the engine's published per-frame program rounds
    its dot product: rows in whole groups of eight take output x and y as
    ((a0 r0 + a1 r1) + a2 r2) and output z as fma(a2, r2, fma(a1, r1,
    a0 r0)); the remaining rows take the fused form in every column."""
    a = rel.reshape(-1, 3)
    x, y, z = a[:, 0:1], a[:, 1:2], a[:, 2:3]
    out = fma32(z, rot[2], fma32(y, rot[1], x * rot[0]))
    n = a.shape[0] // 8 * 8
    out[:n, :2] = ((x * rot[0, :2] + y * rot[1, :2]) + z * rot[2, :2])[:n]
    return out.reshape(rel.shape)
