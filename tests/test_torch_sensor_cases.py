"""Inputs of the projection sensors' and the DDA walk's tests (numpy only,
no tests here): tests/test_torch_depth.py, test_torch_multiscan.py and
test_torch_dda.py hold the port against the JAX package on them on the
CPU, tests/test_torch_cuda.py the port on the GPU against its CPU results.

Each pose is a float32 [9, 3] row block as the JAX package packs a frame
(pvt, rows 3-5 the rotation, row 6 the sensor origin, rows 7-8 the
sensor's scalars; the canvas rows are not used by a sensor model)."""
import numpy as np

from gie_mapping_tpu_torch.runtime.datasets import BoxWorld
from gie_mapping_tpu_torch.utils import geometry as tgeo

WORLD_SEED = 29
# the goldens' reduced window: 25 x 25 x 10 voxels of 0.2 m (6,250, not a
# multiple of 8: the frame change's tail rows); and the presets' windows
SMALL = dict(local_size_m=(5.0, 5.0, 2.0), voxel_width=0.2)


def world():
    return BoxWorld.corridor(seed=WORLD_SEED, n_pillars=6, extent=4.0,
                             height=2.5)


def poses(kind, local_size, voxel_width, n=4, seed=0):
    """(pose rows float32 [n, 9, 3], measurements [n, ...]) of `kind`
    ("depth": bench_suite.py's 96 x 128 depth camera at fx = fy = 80;
    "multiscan": the 16 x 360 ring LiDAR) at n random poses near the
    world's centre, tilted a little."""
    w = world()
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 9, 3), np.float32)
    data = []
    for k in range(n):
        trans = np.asarray([rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5),
                            rng.uniform(0.5, 1.5)], np.float32)
        q = (1.0, rng.normal() * 0.1, rng.normal() * 0.1, rng.normal())
        p = tgeo.Projection.from_pose(trans, q)
        rows[k, 0] = tgeo.calculate_pivot(trans, voxel_width, local_size)
        rows[k, 3:6], rows[k, 6] = p.rot.numpy(), trans
        if kind == "depth":
            img, fx, fy, cx, cy = w.depth_image(p, rows=96, cols=128, fx=80.0,
                                                fy=80.0, max_range=6.0)
            rows[k, 7], rows[k, 8, 0] = (fx, fy, cx), cy
        else:
            img, tmin, tinc, pmin, pinc = w.multiscan(p, max_range=8.0)
            rows[k, 7], rows[k, 8, 0] = (tmin, tinc, pmin), pinc
        data.append(img)
    return rows, np.stack(data).astype(np.float32)


def edge_depth(img, seed=0):
    """A copy of a depth image with pixels of every special kind: NaN,
    +Inf, 0, exactly 0.21 and just above it, and values that put a voxel's
    centre near a band edge (at face_pose, 2.0 +- a voxel width)."""
    img = img.copy()
    rng = np.random.default_rng(seed)
    flat = img.reshape(-1)
    idx = rng.permutation(flat.size)
    n = flat.size // 12
    specials = [np.nan, np.inf, 0.0, np.float32(0.21),
                np.nextafter(np.float32(0.21), np.float32(1)), 2.0, 3.3]
    for j, v in enumerate(specials):
        flat[idx[j * n:(j + 1) * n]] = v
    return img


def face_pose(local_size, voxel_width):
    """A pose rows block whose sensor sits on voxel faces and looks along
    +x with no rotation: voxel centres then project onto pixel edges and
    bin edges."""
    rows = np.zeros((9, 3), np.float32)
    trans = np.asarray([0.0, 0.1, 1.0], np.float32)
    rows[0] = tgeo.calculate_pivot(trans, voxel_width, local_size)
    rows[3:6], rows[6] = np.eye(3, dtype=np.float32), trans
    return rows


def dda_rays(origin, voxel_width=0.2):
    """Endpoints (float32 [N, 3], world frame) of the DDA walk's edge rays
    from `origin`: axis-aligned, through voxel edges and corners (diagonal
    directions), same-cell, endpoints in the sensor's own voxel, rays
    longer than the walk's 0.707 * X voxel widths, and a grid of
    endpoints on voxel centres."""
    o = np.asarray(origin, np.float32)
    pts = []
    for a in range(3):
        for s in (-1, 1):
            for L in (0.3, 1.0, 2.0, 5.0, 9.0):
                p = o.copy()
                p[a] += s * L
                pts.append(p)
    for d in ([1, 1, 0], [1, 1, 1], [-1, 1, 1], [1, -1, -1], [2, 1, 0],
              [0, 1, 1], [-1, -1, 0], [3, 1, 1]):
        d = np.asarray(d, np.float32)
        for L in (0.2, 0.6, 1.4, 3.0, 5.5, 8.0):
            pts.append(o + d * L)
    pts.append(o + np.float32([0.01, 0.01, 0.01]))
    pts.append(o + np.float32([0.05, 0.0, 0.0]))
    pts += [o + np.float32([0.0, 0.0, 0.02])] * 3
    g = np.stack(np.meshgrid(np.arange(-8, 9), np.arange(-8, 9), [-2, 0, 3],
                             indexing="ij"), -1).reshape(-1, 3)
    grid = g * voxel_width + o
    return np.concatenate([np.asarray(pts, np.float32),
                           grid.astype(np.float32)])


def random_rays(origin, n, seed, near=0.05):
    """n endpoints at random directions and ranges near-9 m from origin,
    and a valid mask with about a tenth of them off."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    r = rng.uniform(near, 9.0, n).astype(np.float32)
    pts = (np.asarray(origin, np.float32) + v * r[:, None]).astype(np.float32)
    return pts, rng.random(n) < 0.9
