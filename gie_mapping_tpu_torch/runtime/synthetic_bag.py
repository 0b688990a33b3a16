"""A cow-lady-scale synthetic rosbag, and its replay through the port; the
counterpart is the JAX package's examples/make_synthetic_bag.py.

    python -m gie_mapping_tpu_torch.runtime.synthetic_bag OUT [--frames 60]
        [--rays 16384] [--compression none|bz2|lz4] [--run] [--cpu]

The bag has the structure of launch/cow_dataset.launch's inputs:
PointCloud2 frames at 10 Hz on /camera/depth_registered/points (the
corridor world's clouds along a circle of radius 1.5 m at 1.2 m) and vicon
TransformStamped poses at 100 Hz on
/kinect/vrpn_client/estimated_transform (linear interpolation between the
frames' positions), written with runtime/rosbag_writer.py.  With --run it
is converted with runtime/rosbag.convert_bag (to OUT.npz) and replayed in
this process through cli.main(["cow_lady", "--replay", OUT.npz, "--frames",
n]), on the card unless --cpu.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import geometry as geo
from . import rosbag_writer as w
from .datasets import BoxWorld, circular_trajectory

SENSOR_TOPIC = "/camera/depth_registered/points"
POSE_TOPIC = "/kinect/vrpn_client/estimated_transform"


def make_bag(path, n_frames=60, n_rays=16384, hz=10.0, pose_hz=100.0,
             seed=0, chunk_messages=200, compression="bz2") -> int:
    """Write the bag to `path`; returns its message count."""
    world = BoxWorld.corridor(seed=seed, n_pillars=8, extent=4.0, height=2.5)
    poses = circular_trajectory(n_frames=n_frames, radius=1.5, height=1.2)
    bag = w.BagWriter(chunk_messages=chunk_messages, compression=compression)
    t0 = 1600000000.0
    # vicon poses at pose_hz (linear interpolation between frame poses)
    n_pose = int(n_frames * pose_hz / hz)
    for i in range(n_pose):
        t = t0 + i / pose_hz
        fi = min(int(i * hz / pose_hz), n_frames - 1)
        fj = min(fi + 1, n_frames - 1)
        a = (i * hz / pose_hz) - fi
        pos = ((1 - a) * poses[fi].trans.cpu().numpy()
               + a * poses[fj].trans.cpu().numpy())
        quat = geo.rot_to_quat(poses[fi].rot.cpu().numpy())
        bag.add(POSE_TOPIC, "geometry_msgs/TransformStamped", t,
                w.transform_stamped(t, pos, quat, child_frame="kinect"))
    for i, proj in enumerate(poses):
        t = t0 + i / hz
        pts = world.pointcloud(proj, n_rays=n_rays, max_range=8.0, seed=i)
        bag.add(SENSOR_TOPIC, "sensor_msgs/PointCloud2", t,
                w.pointcloud2(t, pts))
    return bag.write(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="output .bag path")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--rays", type=int, default=16384)
    ap.add_argument("--compression", default="bz2",
                    choices=("none", "bz2", "lz4"),
                    help="chunk compression (lz4: the pure-Python runtime/lz4f)")
    ap.add_argument("--run", action="store_true",
                    help="convert and replay in this process after writing")
    ap.add_argument("--cpu", action="store_true",
                    help="replay on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    n = make_bag(args.out, n_frames=args.frames, n_rays=args.rays,
                 compression=args.compression)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out}: {n} messages, {size_mb:.1f} MB "
          f"({args.frames} cloud frames @10 Hz + poses @100 Hz)")
    npz = args.out + ".npz"
    if not args.run:
        print("next:\n  python -m gie_mapping_tpu_torch.runtime.rosbag "
              f"{args.out} {npz} --sensor {SENSOR_TOPIC} --odom {POSE_TOPIC}"
              "\n  python -m gie_mapping_tpu_torch.cli cow_lady --replay "
              f"{npz} --frames {args.frames}")
        return 0

    from .. import cli
    from .rosbag import convert_bag

    k = convert_bag(args.out, npz, SENSOR_TOPIC, POSE_TOPIC)
    print(f"converted: {k} frames -> {npz}")
    cli.main(["cow_lady", "--replay", npz, "--frames", str(args.frames)]
             + (["--cpu"] if args.cpu else []))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
