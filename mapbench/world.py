"""A world of axis-aligned boxes, and the sensors that look at it, on the
device.

A world is a [B, 2, 3] tensor of boxes (lower and upper corners, metres),
made from a traffic file's `world`: a closed room, rings of jittered
obstacles and any list of fixed boxes.  `ray_hits` is the exact slab test
of rays against every box; `depth_images` renders with it the forward (x)
distance per pixel of a pinhole camera in one large call a frame, for the
sensor modules (mapbench/sensors/).  A closed room around everything makes
every ray hit a surface, so every frame has the same number of live
pixels or points.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def room_boxes(lo, hi, thickness):
    """The six slabs (floor, ceiling, four walls) of a closed room whose
    inside is [lo, hi]."""
    lo, hi, t = np.asarray(lo, float), np.asarray(hi, float), float(thickness)
    out = []
    for a in range(3):
        for side in (0, 1):
            b_lo, b_hi = lo - t, hi + t
            if side == 0:
                b_hi = b_hi.copy()
                b_hi[a] = lo[a]
            else:
                b_lo = b_lo.copy()
                b_lo[a] = hi[a]
            out.append((b_lo, b_hi))
    return out


def ring_boxes(ring: dict, rng: np.random.Generator):
    """`count` boxes in fixed angular slots of a ring, alternating over
    `radii_m`; the seed's generator moves each within its slot by at most
    `jitter_deg` and `jitter_m`."""
    n = int(ring["count"])
    radii = ring["radii_m"]
    half = np.asarray(ring["size_m"], float) / 2
    out = []
    jd = rng.uniform(-1.0, 1.0, n) * ring["jitter_deg"]
    jr = rng.uniform(-1.0, 1.0, n) * ring["jitter_m"]
    for i in range(n):
        a = math.radians(360.0 * (i + 0.5) / n + jd[i])
        r = radii[i % len(radii)] + jr[i]
        c = np.array([r * math.cos(a), r * math.sin(a), half[2]])
        out.append((c - half, c + half))
    return out


def make_world(spec: dict, seed: int) -> np.ndarray:
    """[B, 2, 3] float32 boxes of a world spec: its room, its rings (the
    only part the seed moves) and its fixed boxes.  B does not depend on
    the seed."""
    rng = np.random.default_rng(seed)
    boxes = []
    if "room" in spec:
        r = spec["room"]
        boxes += room_boxes(r["lo"], r["hi"], r["thickness_m"])
    for ring in spec.get("rings", []):
        boxes += ring_boxes(ring, rng)
    for b in spec.get("boxes", []):
        boxes.append((np.asarray(b["lo"], float), np.asarray(b["hi"], float)))
    return np.asarray([[lo, hi] for lo, hi in boxes], np.float32)


def pixel_rays(cam: dict, device) -> torch.Tensor:
    """Sensor-frame ray directions [rows * cols, 3] with unit forward (x)
    component: pixel (u, v) sees (1, -(u - cx) / fx, -(v - cy) / fy)."""
    v, u = torch.meshgrid(torch.arange(cam["rows"], device=device, dtype=torch.float32),
                          torch.arange(cam["cols"], device=device, dtype=torch.float32),
                          indexing="ij")
    d = torch.stack([torch.ones_like(u), -(u - cam["cx"]) / cam["fx"],
                     -(v - cam["cy"]) / cam["fy"]], dim=-1)
    return d.reshape(-1, 3)


def ray_hits(boxes: torch.Tensor, dirs: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Ray parameter t [P] at the first box surface that rays origin + t
    dirs [P, 3] (world frame) hit, +inf where no box is: the exact slab
    test against every box."""
    lo, hi = boxes[:, 0], boxes[:, 1]                          # [B, 3]
    inv = 1.0 / dirs
    t1 = (lo[None] - origin[None, None]) * inv[:, None]        # [P, B, 3]
    t2 = (hi[None] - origin[None, None]) * inv[:, None]
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = (tmax >= tmin) & (tmin > 0)
    return torch.where(hit, tmin, torch.inf).amin(-1)


def depth_images(boxes: torch.Tensor, rots: torch.Tensor, origins: torch.Tensor,
                 cam: dict) -> torch.Tensor:
    """Depth images [F, rows, cols] float32 of F camera poses (rots [F, 3,
    3] sensor-to-world, origins [F, 3]) in a box world: the forward
    distance to the nearest box surface hit, +inf where no box is."""
    rays = pixel_rays(cam, boxes.device)                       # [P, 3]
    return torch.stack([ray_hits(boxes, rays @ rots[f].T, origins[f])
                        .reshape(cam["rows"], cam["cols"])
                        for f in range(rots.shape[0])])
