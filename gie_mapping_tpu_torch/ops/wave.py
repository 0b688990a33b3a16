"""Incremental global EDT of the relax engine (merge_mode="relax") and
exploration-frontier marking.

Counterpart of gie_mapping_tpu/ops/wave.py: `reconcile_window`
(limited-observation reconciliation of a window EDT with the stored
canvas), `invalidate_disappeared` (the raise wave as a coc-equality flood)
and `relax_fixed_point` (the masked 6-neighbour (dist, coc) relaxation to
a fixed point), then `mark_frontiers`.

Each `lax.while_loop` of the JAX package becomes a Python loop that runs
`_SWEEPS_PER_CHECK` sweeps and then reads one flag from the device: one host
sync per four sweeps.  The sweep counts equal the JAX package's, so
`relax_iters` is the same frame output.

Closest-obstacle coordinates are int16 canvas-relative (COC_INVALID16 where
none); distances int32 squared grid units (EMPTY_VALUE where none).
"""
from __future__ import annotations

import torch

from ..map_state import COC_INVALID16
from ..parallel.mesh import (any_flags, bounds_of, crop, like, parts_of,
                             sbuild, smap, splice, x_halo)
from ..utils import geometry as geo
from ..utils.constants import (EMPTY_VALUE, VOX_FNT, VOX_FREE, VOX_UNKNOWN)

INV16 = int(COC_INVALID16)
_DIRS = tuple((axis, sign) for axis in range(3) for sign in (1, -1))
# sweeps between convergence checks; must equal the JAX package's default
# (its callers use it), or the sweep counts, a frame output, differ
_SWEEPS_PER_CHECK = 4


def _shift_fill(arr: torch.Tensor, axis: int, sign: int, fill) -> torch.Tensor:
    """Shift by one voxel along `axis` (sign=+1 brings the neighbour at
    +axis into each cell), filling the exposed face with `fill`."""
    out = torch.full_like(arr, fill)
    n = arr.shape[axis]
    if sign > 0:
        out.narrow(axis, 0, n - 1).copy_(arr.narrow(axis, 1, n - 1))
    else:
        out.narrow(axis, 1, n - 1).copy_(arr.narrow(axis, 0, n - 1))
    return out


def reconcile_window(batch: dict, canvas_dist_win, canvas_coc_win, glb_type,
                     win_off, local_size):
    """MarkLimitedObserve semantics: the window's fresh batch-EDT values
    replace the stored ones, except where the new value only got worse
    because the stored closest obstacle lies outside the window.

    win_off: host ints (the window's offset in the canvas).  Returns
    (seed_dist int32, seed_coc int16 canvas-relative) for the window, with
    EMPTY/INVALID where the voxel is unobserved or sees nothing."""
    dev = glb_type.device
    off = torch.tensor([int(v) for v in win_off], dtype=torch.int32, device=dev)
    observed = glb_type != VOX_UNKNOWN
    valid_new = batch["valid"]
    dist_new = torch.where(valid_new, batch["dist_sq"], EMPTY_VALUE)
    coc_new = torch.where(valid_new[..., None],
                          (batch["coc"] + off).to(torch.int16), INV16)
    old_valid = canvas_coc_win[..., 0] != INV16
    old_in_loc = geo.inside_volume(canvas_coc_win.to(torch.int32) - off,
                                   local_size) & old_valid
    limited = (dist_new > canvas_dist_win) & ~old_in_loc & old_valid
    dist_sel = torch.where(limited, canvas_dist_win, dist_new)
    coc_sel = torch.where(limited[..., None], canvas_coc_win, coc_new)
    seed_dist = torch.where(observed, dist_sel, EMPTY_VALUE).to(torch.int32)
    seed_coc = torch.where(observed[..., None], coc_sel, INV16).to(torch.int16)
    return seed_dist, seed_coc


def _neighbours(t, fill) -> list:
    """Per part of t, {(axis, sign): the part shifted by one voxel along
    axis (sign=+1 brings the neighbour at +axis into each cell)}, `fill`
    beyond the canvas.  On an x-sharded field the x-neighbours come from
    one halo exchange (parallel.mesh.x_halo)."""
    out = []
    for p, e in zip(parts_of(t), x_halo(t, fill)):
        out.append({(axis, sign): ((e[2:] if sign > 0 else e[:-2]) if axis == 0
                                   else _shift_fill(p, axis, sign, fill))
                    for axis, sign in _DIRS})
    return out


def invalidate_disappeared(dist, coc, outside_mask, stale_coc, dead_win,
                           win_off, *, max_sweeps: int):
    """The raise wave as a flood over the stale coc field: seeded at the
    window voxels whose obstacle disappeared (`dead_win`), each sweep
    extends the raised set to the 6-neighbours whose stale coc equals the
    raised voxel's.  Raised voxels in `outside_mask` are reset to
    EMPTY/INVALID.  The canvas fields may be x-sharded (each sweep then
    exchanges one x-plane with each neighbouring shard, and the
    convergence flag reduces over the shards).  Returns (dist, coc,
    raised)."""
    local_size = dead_win.shape
    shp = tuple(dist.shape[1:])
    raised = sbuild(dist, lambda lo, hi, d: torch.zeros(
        (hi - lo,) + shp, dtype=torch.bool, device=d))
    raised = splice(raised, tuple(slice(int(o), int(o) + n)
                                  for o, n in zip(win_off, local_size)),
                    dead_win, inplace=True)
    # the coc-equality masks do not change between sweeps
    same = [[(axis, sign, (sc == nb[(axis, sign)]).all(-1)
              & (sc[..., 0] != INV16)) for axis, sign in _DIRS]
            for sc, nb in zip(parts_of(stale_coc), _neighbours(stale_coc, INV16))]
    it, changed = 0, True
    while changed and it < max_sweeps:
        new = raised
        for _ in range(_SWEEPS_PER_CHECK):
            out = []
            for p, nb, eqs in zip(parts_of(new), _neighbours(new, False), same):
                for axis, sign, eq in eqs:
                    p = p | (nb[(axis, sign)] & eq)
                out.append(p)
            new = like(new, out)
        it += _SWEEPS_PER_CHECK
        changed = any_flags(new, [[(a != b).any()] for a, b in
                                  zip(parts_of(new), parts_of(raised))])
        raised = new
    inval = smap(torch.logical_and, raised, outside_mask)
    dist = smap(lambda i, d: torch.where(i, EMPTY_VALUE, d), inval, dist)
    coc = smap(lambda i, c: torch.where(i[..., None], INV16, c).to(torch.int16),
               inval, coc)
    return dist, coc, raised


def relax_fixed_point(dist, coc, can_update, outside_observed, window_mask,
                      *, cutoff_sq: int, max_iters: int):
    """Masked 6-neighbour (dist, coc) min-relaxation to a fixed point: each
    sweep, every updatable voxel takes the exact squared distance to a
    source neighbour's closest obstacle where that is smaller.  A voxel is
    a source if it has a coc and lies in the window, or is observed outside
    it within the cutoff.  The fields may be x-sharded: each sweep exchanges
    one x-plane of coc and of the source mask with each neighbouring shard,
    and each check (one host read per _SWEEPS_PER_CHECK sweeps) reduces the
    flags over the shards.  Returns (dist, coc, sweeps run)."""
    grids = []
    for p, (lo, hi) in zip(parts_of(dist), bounds_of(dist)):
        gx, gy, gz = (g.squeeze(-1) for g in geo.local_coord_grid(
            p.shape, p.device).split(1, dim=-1))
        grids.append((gx + lo, gy, gz))

    def sweep(dist, coc):
        src_ok = smap(lambda d, c, w, o: (c[..., 0] != INV16) & (
            w | (o & (d <= cutoff_sq))), dist, coc, window_mask,
            outside_observed)
        nd, nc, flags = [], [], []
        for d, c, cu, g, nbc, nbs in zip(
                parts_of(dist), parts_of(coc), parts_of(can_update), grids,
                _neighbours(coc, INV16), _neighbours(src_ok, False)):
            best_d, best_c = d, c
            for axis, sign in _DIRS:
                n_coc = nbc[(axis, sign)]
                valid = nbs[(axis, sign)] & (n_coc[..., 0] != INV16)
                cand = None
                for k, gk in enumerate(g):
                    e = gk - torch.where(valid, n_coc[..., k].to(torch.int32), gk)
                    cand = e * e if cand is None else cand + e * e
                cand = torch.where(valid, cand, EMPTY_VALUE)
                better = cand < best_d
                best_d = torch.where(better, cand, best_d)
                best_c = torch.where(better[..., None], n_coc, best_c)
            improve = (best_d < d) & cu
            nd.append(torch.where(improve, best_d, d))
            nc.append(torch.where(improve[..., None], best_c, c))
            flags.append(improve.any())
        return like(dist, nd), like(coc, nc), flags

    it, changed = 0, True
    while changed and it < max_iters:
        flags = [[] for _ in parts_of(dist)]
        for _ in range(_SWEEPS_PER_CHECK):
            dist, coc, ch = sweep(dist, coc)
            for f, c in zip(flags, ch):
                f.append(c)
        it += _SWEEPS_PER_CHECK
        changed = any_flags(dist, flags)
    return dist, coc, it


def mark_frontiers(canvas_vox_type, glb_type, win_off, local_size):
    """FREE window voxels with an UNKNOWN 6-neighbour become FRONTIER
    (absent blocks and beyond-canvas count as unknown).

    Works on a window+1-halo slice clamped into the canvas (gathered from
    the shards of an x-sharded canvas).  win_off is a host int triple.
    Returns the frontier mask (bool, window shape); the window's output
    type is torch.where(fnt, VOX_FNT, glb_type)."""
    cs = canvas_vox_type.shape
    ext = [min(l + 2, c) for l, c in zip(local_size, cs)]
    starts = [min(max(int(win_off[a]) - 1, 0), cs[a] - ext[a]) for a in range(3)]
    # clamped like the reference's dynamic_slice
    rel = [min(max(int(win_off[a]) - starts[a], 0), ext[a] - local_size[a])
           for a in range(3)]
    sl = crop(canvas_vox_type, tuple(slice(starts[a], starts[a] + ext[a])
                                     for a in range(3)))
    unknown = sl == VOX_UNKNOWN
    nbr = torch.zeros_like(unknown)
    for axis, sign in _DIRS:
        nbr |= _shift_fill(unknown, axis, sign, True)
    nbr_win = nbr[rel[0]:rel[0] + local_size[0], rel[1]:rel[1] + local_size[1],
                  rel[2]:rel[2] + local_size[2]]
    return (glb_type == VOX_FREE) & nbr_win
