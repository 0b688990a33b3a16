"""The benchmark's one traffic generator: a traffic file of mapbench/
traffic/ (a sensor path, a box world, the number of noisy passes) and a
configuration's sensor make the frames a cell runs.

The path and the sensor are found by name: the traffic's `path.kind` is
the module mapbench/paths/<kind>.py (its `poses(path)`), the
configuration's `sensor.kind` the module mapbench/sensors/<kind>.py (its
`render`, the engine's and the reference's frame, the span to trace).  A
new path or sensor is a new file there; a new cell of known kinds is data
alone.

The world's layout is data; the seed draws only the jitter of ring
obstacles within their slots and the sensor noise, so every seed gives
the same frames, poses, boxes, live pixels or points and (the poses fixing
the canvas moves) scrolls.  Readings are rendered and noised on the device
in a few large calls, then copied to host memory once: the mapper is
handed host arrays, as a sensor callback hands them.
"""
from __future__ import annotations

import importlib
import re

import torch

from .world import make_world


def plugin(folder: str, kind: str):
    """The module mapbench/<folder>/<kind>.py ("paths" or "sensors")."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", str(kind)):
        raise ValueError(f"mapbench: bad {folder} kind {kind!r}")
    try:
        return importlib.import_module(f"mapbench.{folder}.{kind}")
    except ModuleNotFoundError as e:
        if e.name == f"mapbench.{folder}.{kind}":
            raise ValueError(f"mapbench: no {folder} module {kind!r}") from None
        raise


def sensor_module(sensor: dict):
    return plugin("sensors", sensor["kind"])


def camera_path(path: dict):
    """(rots [F, 3, 3], trans [F, 3]) float32 of a traffic's path."""
    return plugin("paths", path["kind"]).poses(path)


def make_traffic(traffic: dict, sensor: dict, seed: int, device) -> dict:
    """The frames of one cell: {"rots", "trans" (one pass), "data" [K, F,
    ...] float32 host array (K noisy passes of the same poses, each
    frame's readings as the sensor module renders them), "boxes" [B, 2,
    3], "counts"}."""
    dev = torch.device(device)
    boxes = make_world(traffic["world"], seed)
    rots, trans = camera_path(traffic["path"])
    K = int(traffic["passes"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    b, r, t = (torch.from_numpy(a).to(dev) for a in (boxes, rots, trans))
    data, live = sensor_module(sensor).render(b, r, t, sensor, K, gen)
    counts = {"frames_per_pass": int(rots.shape[0]), "passes": K,
              "boxes": int(boxes.shape[0]),
              "live_min": int(live.min()), "live_max": int(live.max())}
    return {"rots": rots, "trans": trans, "data": data.cpu().numpy(),
            "boxes": boxes, "counts": counts}
