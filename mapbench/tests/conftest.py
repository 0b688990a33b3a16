"""Tiny versions of the benchmark's configuration and traffic, for CPU
tests: a 20 x 20 x 10 window on a 56 x 56 x 48 canvas, the sensor modules'
TINY sizes, a 1 m loop of 10 frames in a 6 m room."""
import copy
import json
from pathlib import Path

import pytest

from mapbench.generate import sensor_module

HERE = Path(__file__).resolve().parents[1]


def load(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


def tiny(config, traffic, gate=True):
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["deployment"].update(local_size_m=[2.0, 2.0, 1.0], cutoff_dist=0.8)
    config["overrides"] = dict(config.get("overrides", {}), local_size_m=(2.0, 2.0, 1.0),
                               cutoff_dist=0.8,
                               # the change gate on (or off) at this small canvas
                               edt_gate_min_vox=0 if gate else 1 << 40)
    sm = sensor_module(config["sensor"])
    config["sensor"].update(sm.TINY)
    config["deployment"].update(sm.TINY_DEPLOYMENT)
    config["overrides"].update(sm.TINY_DEPLOYMENT)
    traffic["path"].update(radius_m=1.0, height_m=1.0,
                           frames=10 if traffic["path"]["laps"] else 6)
    # (a depth image, a 2 m window, a tiny canvas: cases of every cell)
    traffic["passes"] = 2
    traffic["warmup_passes"] = 1
    traffic["world"] = {
        "room": {"lo": [-3, -3, 0], "hi": [3, 3, 2.0], "thickness_m": 0.2},
        "rings": [{"count": 6, "radii_m": [0.4, 1.7], "size_m": [0.3, 0.3, 1.6],
                   "jitter_deg": 3.0, "jitter_m": 0.1}],
        "boxes": [{"lo": [-1, 2.2, 0], "hi": [1, 2.4, 1.5]}]}
    return config, traffic


@pytest.fixture
def tiny_flight():
    return tiny(load("configs", "depthcam"), load("traffic", "flight"))


# (configuration, traffic) of each cell
CELLS = [("depthcam", "flight"), ("depthcam", "hover"), ("cow_lady", "kinect")]


def tiny_cell(cell, gate=True):
    return tiny(load("configs", cell[0]), load("traffic", cell[1]), gate)


@pytest.fixture
def tiny_hover():
    return tiny(load("configs", "depthcam"), load("traffic", "hover"))
