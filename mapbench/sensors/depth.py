"""A pinhole depth camera: one depth image [rows, cols] a frame, the
forward (x) distance per pixel, with depth noise sigma =
noise_sigma_per_m2 z^2.

Engine: VolumetricMapper.process_depth, whose sensor model is
pipeline.SENSORS["depth"] (ops/scan_sensors.py::realsense_update).
Reference: reference/depth.py::depth_model.

A sensor module gives the harness (mapbench/generate.py, run.py,
control.py, trace.py), found by the configuration's `sensor.kind`:
SPAN, the engine's sensor model that the traced run wraps ((module of the
engine, attribute path; a dict's key as the last part)); TINY and
TINY_DEPLOYMENT, the sensor and deployment settings of the CPU tests;
size(sensor), the live readings a frame; render(...), the K noisy passes;
engine_frame(...) and reference_frame(...), one map cycle of each side.
A module whose engine entry takes several frames in one call (a replay
in chunks) may keep them in engine_frame and add flush(mapper), which the
harness calls after the warm-up and at the window's close, before the
mirror's flush, so that every frame the reference replays reaches the
engine.
"""
from __future__ import annotations

import numpy as np
import torch

from mapbench.reference.depth import depth_model
from mapbench.world import depth_images

SPAN = ("models.pipeline", "SENSORS.depth")
TINY = {"rows": 24, "cols": 32, "fx": 27.7128, "fy": 27.7128, "cx": 15.5, "cy": 11.5}
TINY_DEPLOYMENT: dict = {}


def size(sensor: dict) -> int:
    return int(sensor["rows"]) * int(sensor["cols"])


def render(boxes, rots, trans, sensor, passes, gen):
    """(data [K, F, rows, cols] float32, live readings per frame [F]) of F
    poses in a box world, K noisy passes drawn from `gen`."""
    clean = depth_images(boxes, rots, trans, sensor)
    noise = torch.randn((passes,) + tuple(clean.shape), generator=gen, device=clean.device)
    data = clean[None] + sensor["noise_sigma_per_m2"] * clean[None] ** 2 * noise
    return data, torch.isfinite(clean).reshape(clean.shape[0], -1).sum(1)


def engine_frame(mapper, sensor, proj, data):
    return mapper.process_depth(proj, data, sensor["fx"], sensor["fy"],
                                sensor["cx"], sensor["cy"])


def reference_frame(ref, sensor, rot, trans, data):
    trans32 = np.asarray(trans, np.float32)
    pvt, origin, enter, off = ref.place(trans32)
    inst = depth_model(ref, pvt, rot, trans32, data, sensor["fx"], sensor["fy"],
                       sensor["cx"], sensor["cy"])
    ref.merge(inst, None, origin, enter, off)
