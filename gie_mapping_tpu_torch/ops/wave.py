"""Exploration-frontier marking (counterpart of
gie_mapping_tpu/ops/wave.py::mark_frontiers).  The relaxation engine of that
module (merge_mode="relax") is not ported yet."""
from __future__ import annotations

import torch

from ..utils.constants import VOX_FNT, VOX_FREE, VOX_UNKNOWN


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


def mark_frontiers(canvas_vox_type, glb_type, win_off, local_size):
    """FREE window voxels with an UNKNOWN 6-neighbour become FRONTIER
    (absent blocks and beyond-canvas count as unknown).

    Works on a window+1-halo slice clamped into the canvas.  win_off is a
    host int triple.  Returns (glb_type with FNT marks int8, fnt bool)."""
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
    for axis in range(3):
        for sign in (1, -1):
            nbr |= _shift_fill(unknown, axis, sign, True)
    nbr_win = nbr[rel[0]:rel[0] + local_size[0], rel[1]:rel[1] + local_size[1],
                  rel[2]:rel[2] + local_size[2]]
    fnt = (glb_type == VOX_FREE) & nbr_win
    return torch.where(fnt, VOX_FNT, glb_type).to(torch.int8), fnt
