"""Occupancy fusion primitives: the low-pass occupancy filter and the
virtual-fence AABB test (counterpart of gie_mapping_tpu/ops/fusion.py)."""
from __future__ import annotations

import torch

from ..utils.constants import (OCC_VAL_MAX, OCC_VAL_MIN, VOX_FREE,
                               VOX_OCCUPIED, VOX_UNKNOWN)


def _lowpass(old_occ, old_type, val, alpha, occu_thresh):
    """Low-pass occupancy update + re-thresholded type
    (set_hashvoxel_occ_val, reference voxmap_utils.cuh:181-200)."""
    prev = torch.where(old_type != VOX_UNKNOWN, old_occ.to(torch.float32), 0.0)
    new = alpha * val + (1.0 - alpha) * prev
    new = torch.clamp(new, OCC_VAL_MIN, OCC_VAL_MAX)
    new_u8 = new.to(torch.uint8)
    new_type = torch.where(new_u8 > occu_thresh, VOX_OCCUPIED,
                           VOX_FREE).to(torch.int8)
    return new_u8, new_type


def _fence_mask(glb_pos, fence_ll, fence_ur, fence_active, n_obs):
    """Virtual-fence / external-observer AABB obstacle test: outside box 0
    (the inverted flyable-region fence) or inside any box 1..n.

    fence_ll/ur: [M,3] float32; fence_active: [M] bool; n_obs: int."""
    M = fence_ll.shape[0]
    pts = glb_pos[..., None, :]
    inside = ((pts >= fence_ll) & (pts <= fence_ur)).all(dim=-1)
    live = fence_active & (torch.arange(M, device=fence_ll.device) < n_obs)
    out0 = live[0] & ~inside[..., 0]
    rest = (inside[..., 1:] & live[1:]).any(dim=-1)
    return out0 | rest
