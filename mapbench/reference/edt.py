"""Plain exact Euclidean distance transform with closest-site coordinates.

Three separable passes, each a brute-force minimum over every site of its
axis, with the tie rule stated per pass (the engine's published rule):

  pass 1 (along y): the nearest site of the (x, z) column; ties to the
                    lower y; valid where it lies nearer than max_width.
  pass 2 (along x): min over x' of (x - x')^2 + g1(x')^2; ties to the
                    smallest x'.
  pass 3 (along z): min over z' of (z - z')^2 + d2(z'); ties to the
                    smallest z'.

The closest site is (x' of pass 2 at the winning z', its pass-1 y, z').
Plain PyTorch on whatever device the input lies on; int64 throughout.
"""
from __future__ import annotations

import torch

INF = 1 << 40
_IDX = 1 << 10  # every axis is shorter than 1024


def _pass1(sites: torch.Tensor, max_width: int):
    """(g1 int64, coc_y int64, valid bool) [X, Y, Z] along y."""
    X, Y, Z = sites.shape
    y = torch.arange(Y, device=sites.device)[None, :, None]
    below = torch.cummax(torch.where(sites, y, -1), dim=1).values
    above = torch.cummin(torch.where(sites, y, INF).flip(1), dim=1).values.flip(1)
    d_lo = torch.where(below >= 0, y - below, INF)
    d_hi = torch.where(above < INF, above - y, INF)
    take_lo = d_lo <= d_hi
    g1 = torch.where(take_lo, d_lo, d_hi)
    coc_y = torch.where(take_lo, below, above)
    valid = g1 < max_width
    return g1, coc_y, valid


def _min_along(cost: torch.Tensor, chunk_elems: int):
    """For cost [N, L] (>= INF where a site is absent): per output position
    i in [0, N) and lane l, (min over sites j of (i - j)^2 + cost[j, l],
    the smallest j that attains it; INF where no site is).  The minimum is
    taken over packed keys (cost << b | j), in int32 where they fit.
    Returns (best [N, L], arg [N, L]) int64."""
    N, L = cost.shape
    dev = cost.device
    b = max(1, (N - 1).bit_length())
    inf32 = 1 << (30 - b)
    small = (inf32 > int(torch.where(cost < INF, cost, 0).max()) + (N - 1) ** 2
             and (inf32 + (N - 1) ** 2) << b < 1 << 31)
    dt, inf = (torch.int32, inf32) if small else (torch.int64, INF)
    j = torch.arange(N, device=dev, dtype=dt)
    c = (torch.clamp(cost, max=inf).to(dt) << b)                 # [N, L]
    step = max(1, chunk_elems // max(N * L, 1))
    best, arg = [], []
    for i0 in range(0, N, step):
        i = torch.arange(i0, min(i0 + step, N), device=dev, dtype=dt)
        ddj = ((i[:, None] - j[None, :]) ** 2 << b) | j[None, :]  # [c, N]
        k = (ddj[:, :, None] + c[None]).amin(dim=1).long()      # [c, L]
        best.append(k >> b)
        arg.append(k & ((1 << b) - 1))
    best = torch.cat(best)
    return torch.where(best >= inf, INF, best), torch.cat(arg)


def exact_edt(sites: torch.Tensor, max_width: int,
              chunk_elems: int = 1 << 27) -> dict:
    """EDT of a bool [X, Y, Z] site mask.  Returns {"valid" bool, "dist_sq"
    int64, "coc" int64 [X, Y, Z, 3]} (dist and coc meaningless where not
    valid)."""
    X, Y, Z = sites.shape
    g1, cy1, v1 = _pass1(sites, max_width)
    # pass 2 along x, lanes (y, z)
    c2 = torch.where(v1, g1 * g1, INF).reshape(X, Y * Z)
    d2, x2 = _min_along(c2, chunk_elems)
    d2 = d2.reshape(X, Y, Z)
    x2 = x2.reshape(X, Y, Z)
    v2 = d2 < INF
    # the winner's pass-1 y, gathered at (x2, y, z)
    cy2 = torch.gather(cy1, 0, x2)
    # pass 3 along z, lanes (x, y)
    c3 = torch.where(v2, d2, INF).permute(2, 0, 1).reshape(Z, X * Y)
    d3, z3 = _min_along(c3, chunk_elems)
    d3 = d3.reshape(Z, X, Y).permute(1, 2, 0)
    z3 = z3.reshape(Z, X, Y).permute(1, 2, 0)
    valid = d3 < INF
    coc = torch.stack([torch.gather(x2, 2, z3), torch.gather(cy2, 2, z3), z3],
                      dim=-1)
    return {"valid": valid, "dist_sq": d3, "coc": coc}
