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


def invalidate_disappeared(dist, coc, outside_mask, stale_coc, dead_win,
                           win_off, *, max_sweeps: int):
    """The raise wave as a flood over the stale coc field: seeded at the
    window voxels whose obstacle disappeared (`dead_win`), each sweep
    extends the raised set to the 6-neighbours whose stale coc equals the
    raised voxel's.  Raised voxels in `outside_mask` are reset to
    EMPTY/INVALID.  Returns (dist, coc, raised)."""
    local_size = dead_win.shape
    raised = torch.zeros(dist.shape, dtype=torch.bool, device=dist.device)
    raised[tuple(slice(int(o), int(o) + n)
                 for o, n in zip(win_off, local_size))] = dead_win
    coc_valid = stale_coc[..., 0] != INV16
    # the coc-equality masks do not change between sweeps
    same = [(axis, sign, (stale_coc == _shift_fill(stale_coc, axis, sign,
                                                    INV16)).all(-1) & coc_valid)
            for axis, sign in _DIRS]
    it, changed = 0, True
    while changed and it < max_sweeps:
        new = raised
        for _ in range(_SWEEPS_PER_CHECK):
            out = new
            for axis, sign, eq in same:
                out = out | (_shift_fill(new, axis, sign, False) & eq)
            new = out
        it += _SWEEPS_PER_CHECK
        changed = bool((new != raised).any())
        raised = new
    inval = raised & outside_mask
    dist = torch.where(inval, EMPTY_VALUE, dist)
    coc = torch.where(inval[..., None], INV16, coc).to(torch.int16)
    return dist, coc, raised


def relax_fixed_point(dist, coc, can_update, outside_observed, window_mask,
                      *, cutoff_sq: int, max_iters: int):
    """Masked 6-neighbour (dist, coc) min-relaxation to a fixed point: each
    sweep, every updatable voxel takes the exact squared distance to a
    source neighbour's closest obstacle where that is smaller.  A voxel is
    a source if it has a coc and lies in the window, or is observed outside
    it within the cutoff.  Returns (dist, coc, sweeps run)."""
    dev = dist.device
    gx, gy, gz = (g.squeeze(-1) for g in geo.local_coord_grid(
        dist.shape, dev).split(1, dim=-1))

    def sweep(dist, coc):
        src_ok = (coc[..., 0] != INV16) & (
            window_mask | (outside_observed & (dist <= cutoff_sq)))
        best_d, best_c = dist, coc
        for axis, sign in _DIRS:
            n_coc = _shift_fill(coc, axis, sign, INV16)
            valid = _shift_fill(src_ok, axis, sign, False) \
                & (n_coc[..., 0] != INV16)
            cand = None
            for k, g in enumerate((gx, gy, gz)):
                d = g - torch.where(valid, n_coc[..., k].to(torch.int32), g)
                cand = d * d if cand is None else cand + d * d
            cand = torch.where(valid, cand, EMPTY_VALUE)
            better = cand < best_d
            best_d = torch.where(better, cand, best_d)
            best_c = torch.where(better[..., None], n_coc, best_c)
        improve = (best_d < dist) & can_update
        return (torch.where(improve, best_d, dist),
                torch.where(improve[..., None], best_c, coc), improve.any())

    it, changed = 0, True
    while changed and it < max_iters:
        flags = []
        for _ in range(_SWEEPS_PER_CHECK):
            dist, coc, ch = sweep(dist, coc)
            flags.append(ch)
        it += _SWEEPS_PER_CHECK
        changed = bool(torch.stack(flags).any())
    return dist, coc, it


def mark_frontiers(canvas_vox_type, glb_type, win_off, local_size):
    """FREE window voxels with an UNKNOWN 6-neighbour become FRONTIER
    (absent blocks and beyond-canvas count as unknown).

    Works on a window+1-halo slice clamped into the canvas.  win_off is a
    host int triple.  Returns the frontier mask (bool, window shape); the
    window's output type is torch.where(fnt, VOX_FNT, glb_type)."""
    cs = canvas_vox_type.shape
    ext = [min(l + 2, c) for l, c in zip(local_size, cs)]
    starts = [min(max(int(win_off[a]) - 1, 0), cs[a] - ext[a]) for a in range(3)]
    # clamped like the reference's dynamic_slice
    rel = [min(max(int(win_off[a]) - starts[a], 0), ext[a] - local_size[a])
           for a in range(3)]
    sl = canvas_vox_type[starts[0]:starts[0] + ext[0],
                         starts[1]:starts[1] + ext[1],
                         starts[2]:starts[2] + ext[2]]
    unknown = sl == VOX_UNKNOWN
    nbr = torch.zeros_like(unknown)
    for axis, sign in _DIRS:
        nbr |= _shift_fill(unknown, axis, sign, True)
    nbr_win = nbr[rel[0]:rel[0] + local_size[0], rel[1]:rel[1] + local_size[1],
                  rel[2]:rel[2] + local_size[2]]
    return (glb_type == VOX_FREE) & nbr_win
