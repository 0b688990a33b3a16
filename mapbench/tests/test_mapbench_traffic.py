"""Every seed gives a cell the same amount of work: frames, poses, boxes,
live pixels and canvas moves; only the obstacles' jitter and the noise
change."""
import numpy as np
import pytest
import torch

from conftest import load
from mapbench.generate import camera_path, make_traffic, sensor_module
from mapbench.reference.mapper import Geometry

SEEDS = (0, 1, 2147483701, 9876543210123)


def small_sensor(config="depthcam"):
    """The configuration's sensor at its module's CPU-test size."""
    cam = dict(load("configs", config)["sensor"])
    cam.update(sensor_module(cam).TINY)
    return cam


def scrolls(dep, trans, passes):
    """Canvas moves over `passes` laps of a path, by the reference's
    placement rule."""
    g = Geometry(dep)
    origin, last, n = None, None, 0
    for _ in range(passes):
        for t in trans:
            pvt = g.pivot(t)
            motion = None if last is None else pvt - last
            last = pvt
            if origin is None or not g.fits(pvt, origin):
                new = g.place(pvt, motion)
                n += origin is None or not np.array_equal(new, origin)
                origin = new
    return n


@pytest.mark.parametrize("config,name", [("depthcam", "flight"), ("depthcam", "hover"),
                                         ("cow_lady", "kinect")])
def test_work_is_the_same_for_every_seed(config, name):
    traffic = load("traffic", name)
    dep = load("configs", config)["deployment"]
    seen = set()
    for seed in SEEDS:
        cam = small_sensor(config)
        tr = make_traffic(traffic, cam, seed, "cpu")
        c = tr["counts"]
        assert c["live_min"] == c["live_max"] == sensor_module(cam).size(cam)
        assert np.isfinite(tr["data"]).all()
        seen.add((c["frames_per_pass"], c["passes"], c["boxes"],
                  tr["rots"].tobytes(), tr["trans"].tobytes(),
                  scrolls(dep, tr["trans"], c["passes"])))
    assert len(seen) == 1


def test_seed_moves_obstacles_and_noise_only():
    traffic = load("traffic", "flight")
    a = make_traffic(traffic, small_sensor(), 5, "cpu")
    b = make_traffic(traffic, small_sensor(), 5, "cpu")
    c = make_traffic(traffic, small_sensor(), 6, "cpu")
    assert np.array_equal(a["data"], b["data"]) and np.array_equal(a["boxes"], b["boxes"])
    assert not np.array_equal(a["data"], c["data"])
    assert not np.array_equal(a["data"][0], a["data"][1])  # passes differ


def test_flight_path():
    """38 frames a lap, 0.99 m apart, facing along the path; a canvas move
    on 20 of a lap's 38 cycles."""
    traffic = load("traffic", "flight")
    rots, trans = camera_path(traffic["path"])
    step = np.linalg.norm(np.diff(trans, axis=0), axis=1)
    assert len(trans) == 38 and np.allclose(step, 0.9914, atol=1e-3)
    heading = np.diff(trans, axis=0)[:, :2]
    fwd = rots[:-1, :2, 0]
    cos = (heading * fwd).sum(1) / np.linalg.norm(heading, axis=1)
    assert (cos > 0.99).all()
    dep = load("configs", "depthcam")["deployment"]
    assert scrolls(dep, trans, 2) - scrolls(dep, trans, 1) == 20


def test_kinect_path():
    """The headline's circle: 40 poses, 0.24 m apart, 12 canvas moves a
    lap."""
    rots, trans = camera_path(load("traffic", "kinect")["path"])
    step = np.linalg.norm(np.diff(trans, axis=0), axis=1)
    assert len(trans) == 40 and np.allclose(step, 0.2355, atol=1e-3)
    dep = load("configs", "cow_lady")["deployment"]
    assert scrolls(dep, trans, 3) - scrolls(dep, trans, 2) == 12


def test_hover_path():
    rots, trans = camera_path(load("traffic", "hover")["path"])
    assert len(trans) == 12 and np.ptp(trans, axis=0).max() == 0
    dep = load("configs", "depthcam")["deployment"]
    assert scrolls(dep, trans, 4) == 1   # the first placement only


def test_depth_image_of_a_wall():
    """A camera 2 m in front of a wall sees depth 2 at every pixel."""
    from mapbench.world import depth_images
    cam = small_sensor()
    boxes = torch.tensor([[[2.0, -50, -50], [3.0, 50, 50]]])
    d = depth_images(boxes, torch.eye(3)[None], torch.zeros(1, 3), cam)
    assert torch.allclose(d, torch.full_like(d, 2.0))
