"""Pure-python rosbag v1 ("#ROSBAG V2.0") reader and offline frame converter.

A copy of gie_mapping_tpu/runtime/rosbag.py for the PyTorch port (numpy
only; its frames replay through gie_mapping_tpu_torch.cli --replay).

The reference's only integration fixtures are public rosbag replays
(README.md:102-145; launch/*.launch play UGV-corridor,
Cow-Lady, UAV 2-D-LiDAR / depth-cam / 3-D-LiDAR bags).  This module makes
those datasets usable WITHOUT a ROS installation: it parses the bag container
format and the ROS1 serialization of the five message types the pipelines
consume, and converts (sensor, odometry) streams into the npz frame schema of
runtime/datasets.py (save_frames_npz) replayed by the CLI (`--replay`).

Container format (self-describing, little-endian):
  "#ROSBAG V2.0\\n" then records of
    u32 header_len | header | u32 data_len | data
  where header is a list of (u32 field_len | name '=' value) fields.  Record
  kinds by op byte: 0x03 bag header, 0x05 chunk (data = nested records,
  compression none|bz2|lz4), 0x07 connection (topic/type/md5), 0x02 message
  data (conn id + time + serialized message), 0x04/0x06 indices (skipped —
  we stream chunks in order instead of seeking).

Supported message types: sensor_msgs/{PointCloud2,LaserScan,Image,CameraInfo},
nav_msgs/Odometry, geometry_msgs/{PoseStamped,TransformStamped},
tf/tfMessage + tf2_msgs/TFMessage.

CLI:  python -m gie_mapping_tpu_torch.runtime.rosbag in.bag out.npz \\
          --sensor /velodyne_points --odom /odom
"""
from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

_U32 = struct.Struct("<I")

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = _U32.unpack_from(buf, off)
        off += 4
        fld = buf[off:off + flen]
        off += flen
        eq = fld.index(b"=")
        fields[fld[:eq].decode()] = fld[eq + 1:]
    return fields


def _records(buf: bytes, off: int = 0) -> Iterator[tuple[dict, bytes]]:
    n = len(buf)
    while off < n:
        try:
            (hlen,) = _U32.unpack_from(buf, off)
            off += 4
            if off + hlen > n:
                raise ValueError("record header runs past end of data")
            hdr = _parse_header(buf[off:off + hlen])
            off += hlen
            (dlen,) = _U32.unpack_from(buf, off)
            off += 4
            if off + dlen > n:
                raise ValueError("record data runs past end of data")
        except (struct.error, IndexError) as e:
            raise ValueError(f"corrupt rosbag record at offset {off}: {e}") from e
        yield hdr, buf[off:off + dlen]
        off += dlen


@dataclass
class Connection:
    cid: int
    topic: str
    msg_type: str


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    t: float          # bag receive time, seconds
    raw: bytes        # ROS1-serialized message body

    def parse(self):
        return parse_message(self.msg_type, self.raw)


def read_bag(path) -> Iterator[BagMessage]:
    """Stream messages from a rosbag v1 file in chunk order."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a rosbag v2.0 file: {magic[:20]!r}")
        data = f.read()

    conns: dict[int, Connection] = {}

    def handle(hdr: dict, body: bytes) -> Iterator[BagMessage]:
        if "op" not in hdr or not hdr["op"]:
            raise ValueError("rosbag record without an 'op' header field")
        op = hdr["op"][0]
        if op == OP_CONNECTION:
            cid = _U32.unpack(hdr["conn"])[0]
            info = _parse_header(body)
            conns[cid] = Connection(
                cid, hdr["topic"].decode(), info.get("type", b"").decode()
            )
        elif op == OP_MSG:
            cid = _U32.unpack(hdr["conn"])[0]
            secs, nsecs = struct.unpack("<II", hdr["time"])
            if cid not in conns:
                raise ValueError(
                    f"message record references unknown connection {cid} "
                    "(connection record missing or out of order)")
            c = conns[cid]
            yield BagMessage(c.topic, c.msg_type, secs + nsecs * 1e-9, body)
        elif op == OP_CHUNK:
            comp = hdr.get("compression", b"none").decode()
            if comp == "none":
                inner = body
            elif comp == "bz2":
                inner = bz2.decompress(body)
            elif comp == "lz4":
                try:
                    import lz4.frame  # native wheel when available (faster)

                    inner = lz4.frame.decompress(body)  # pragma: no cover
                except ImportError:
                    from .lz4f import decompress  # pure-python fallback

                    # chunk header carries the uncompressed size — cap the
                    # decoder so a hostile frame can't exhaust memory, and
                    # wrap decoder errors into the ValueError contract
                    cap = None
                    if len(hdr.get("size", b"")) == 4:
                        (cap,) = struct.unpack("<L", hdr["size"])
                    try:
                        inner = decompress(body, max_output=cap)
                    except (struct.error, IndexError) as e:
                        raise ValueError(f"corrupt lz4 chunk: {e}") from e
            else:
                raise ValueError(f"unknown chunk compression {comp!r}")
            for h2, b2 in _records(inner):
                yield from handle(h2, b2)

    for hdr, body in _records(data):
        yield from handle(hdr, body)


# ---------------------------------------------------------------------------
# ROS1 message deserialization (little-endian wire format)
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("b", "o")

    def __init__(self, b: bytes):
        self.b = b
        self.o = 0

    def u8(self):
        v = self.b[self.o]
        self.o += 1
        return v

    def u32(self):
        (v,) = _U32.unpack_from(self.b, self.o)
        self.o += 4
        return v

    def f(self, fmt: str):
        s = struct.Struct("<" + fmt)
        v = s.unpack_from(self.b, self.o)
        self.o += s.size
        return v if len(v) > 1 else v[0]

    def string(self) -> str:
        n = self.u32()
        v = self.b[self.o:self.o + n].decode(errors="replace")
        self.o += n
        return v

    def raw(self, n: int) -> bytes:
        v = self.b[self.o:self.o + n]
        self.o += n
        return v

    def farray(self, dtype, count: Optional[int] = None):
        if count is None:
            count = self.u32()
        dt = np.dtype(dtype).newbyteorder("<")
        v = np.frombuffer(self.b, dt, count, self.o).copy()
        self.o += count * dt.itemsize
        return v

    def header(self) -> dict:
        seq = self.u32()
        secs, nsecs = self.u32(), self.u32()
        frame_id = self.string()
        return {"seq": seq, "stamp": secs + nsecs * 1e-9, "frame_id": frame_id}


def _pose(r: _Reader) -> dict:
    px, py, pz = r.f("3d")
    qx, qy, qz, qw = r.f("4d")
    return {
        "position": np.array([px, py, pz], np.float32),
        "quat_wxyz": np.array([qw, qx, qy, qz], np.float32),
    }


def parse_message(msg_type: str, raw: bytes) -> dict:
    """Deserialize one ROS1 message body into a plain dict of numpy values."""
    r = _Reader(raw)
    t = msg_type
    if t == "sensor_msgs/PointCloud2":
        out = {"header": r.header(), "height": r.u32(), "width": r.u32()}
        nf = r.u32()
        fields = []
        for _ in range(nf):
            fields.append({"name": r.string(), "offset": r.u32(),
                           "datatype": r.u8(), "count": r.u32()})
        out["fields"] = fields
        out["is_bigendian"] = r.u8()
        out["point_step"] = r.u32()
        out["row_step"] = r.u32()
        out["data"] = r.raw(r.u32())
        out["is_dense"] = r.u8()
        return out
    if t == "sensor_msgs/LaserScan":
        out = {"header": r.header()}
        (out["angle_min"], out["angle_max"], out["angle_increment"],
         out["time_increment"], out["scan_time"], out["range_min"],
         out["range_max"]) = r.f("7f")
        out["ranges"] = r.farray(np.float32)
        out["intensities"] = r.farray(np.float32)
        return out
    if t == "sensor_msgs/Image":
        out = {"header": r.header(), "height": r.u32(), "width": r.u32(),
               "encoding": r.string(), "is_bigendian": r.u8(),
               "step": r.u32()}
        out["data"] = r.raw(r.u32())
        return out
    if t == "sensor_msgs/CameraInfo":
        out = {"header": r.header(), "height": r.u32(), "width": r.u32(),
               "distortion_model": r.string()}
        out["D"] = r.farray(np.float64)
        out["K"] = r.farray(np.float64, 9)
        out["R"] = r.farray(np.float64, 9)
        out["P"] = r.farray(np.float64, 12)
        out["binning_x"], out["binning_y"] = r.u32(), r.u32()
        out["roi"] = {"x_offset": r.u32(), "y_offset": r.u32(),
                      "height": r.u32(), "width": r.u32(),
                      "do_rectify": r.u8()}
        return out
    if t == "nav_msgs/Odometry":
        out = {"header": r.header(), "child_frame_id": r.string()}
        out.update(_pose(r))
        return out  # pose covariance / twist not needed by any consumer
    if t == "geometry_msgs/PoseStamped":
        out = {"header": r.header()}
        out.update(_pose(r))
        return out
    if t == "geometry_msgs/TransformStamped":
        out = {"header": r.header(), "child_frame_id": r.string()}
        tx, ty, tz = r.f("3d")
        qx, qy, qz, qw = r.f("4d")
        out["position"] = np.array([tx, ty, tz], np.float32)
        out["quat_wxyz"] = np.array([qw, qx, qy, qz], np.float32)
        return out
    if t in ("tf/tfMessage", "tf2_msgs/TFMessage"):
        n = r.u32()
        tfs = []
        for _ in range(n):
            sub = parse_message("geometry_msgs/TransformStamped", r.b[r.o:])
            tfs.append(sub)
            # re-walk to advance: header + child + 7 doubles
            rr = _Reader(r.b[r.o:])
            rr.header(), rr.string(), rr.f("3d"), rr.f("4d")
            r.o += rr.o
        return {"transforms": tfs}
    raise KeyError(f"unsupported message type {msg_type!r}")


_PC2_DT = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
           5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def pointcloud2_xyz(msg: dict, ring_field: Optional[str] = None):
    """Extract [N,3] float32 xyz (and optional per-point ring idx) from a
    parsed PointCloud2 (CPU equivalent of pntcld_process,
    src/pntcld_map_maker.cpp:49-61)."""
    step = msg["point_step"]
    n = (msg["width"] * msg["height"]) if step else 0
    buf = np.frombuffer(msg["data"], np.uint8)
    n = min(n, len(buf) // step) if step else 0
    rows = buf[: n * step].reshape(n, step)
    by_name = {f["name"]: f for f in msg["fields"]}

    def col(name):
        f = by_name[name]
        dt = np.dtype(_PC2_DT[f["datatype"]]).newbyteorder("<")
        return rows[:, f["offset"]: f["offset"] + dt.itemsize].copy().view(dt)[:, 0]

    xyz = np.stack([col("x").astype(np.float32),
                    col("y").astype(np.float32),
                    col("z").astype(np.float32)], axis=1)
    if ring_field and ring_field in by_name:
        return xyz, col(ring_field).astype(np.int32)
    return xyz, None


def depth_image_m(msg: dict) -> np.ndarray:
    """Depth Image -> float32 metres [H,W] (16UC1 mm or 32FC1 m)."""
    h, w = msg["height"], msg["width"]
    enc = msg["encoding"]
    if enc in ("16UC1", "mono16"):
        d = np.frombuffer(msg["data"], np.dtype(np.uint16).newbyteorder("<"))
        return d.reshape(h, w).astype(np.float32) * 1e-3
    if enc == "32FC1":
        d = np.frombuffer(msg["data"], np.dtype(np.float32).newbyteorder("<"))
        return d.reshape(h, w).copy()
    raise ValueError(f"unsupported depth encoding {enc!r}")


# ---------------------------------------------------------------------------
# bag -> replay frames
# ---------------------------------------------------------------------------

_POSE_TYPES = ("nav_msgs/Odometry", "geometry_msgs/PoseStamped",
               "geometry_msgs/TransformStamped")
_SENSOR_TYPES = ("sensor_msgs/PointCloud2", "sensor_msgs/LaserScan",
                 "sensor_msgs/Image")


def _apply_extrinsic(pose: dict, T: np.ndarray) -> dict:
    """pose_world_sensor = pose_world_body @ T (body->sensor, e.g. the
    cow-lady vicon->cam T_V_C, include/parameters.h:112-118)."""
    from ..utils import geometry as geo

    R = geo.quat_to_rot(*pose["quat_wxyz"].astype(np.float64))
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = pose["position"]
    M = M @ T
    q = geo.rot_to_quat(M[:3, :3])
    return {"position": M[:3, 3].astype(np.float32),
            "quat_wxyz": q.astype(np.float32)}


def bag_to_frames(path, sensor_topic: str, odom_topic: str, *,
                  slop: float = 0.1, max_frames: Optional[int] = None,
                  extrinsic: Optional[np.ndarray] = None,
                  ring_field: Optional[str] = None,
                  tf_child_frame: Optional[str] = None,
                  camera_info_topic: Optional[str] = None) -> list[dict]:
    """Pair sensor messages with the nearest-in-time pose (ApproximateTime
    policy, volumetric_mapper.cpp:19-57) and emit npz-schema frames.

    ring_field: PointCloud2 field holding the LiDAR ring index; when given,
    frames carry (points, ring) for the vlp16 multiscan path.
    tf_child_frame: when the odom topic is tf, select this child frame.
    """
    poses: list[tuple[float, dict]] = []
    pending: list[tuple[float, dict, str]] = []
    cam_info: Optional[dict] = None
    frames: list[dict] = []

    def nearest_pose(t: float):
        if not poses:
            return None
        i = min(range(len(poses)), key=lambda j: abs(poses[j][0] - t))
        return poses[i] if abs(poses[i][0] - t) <= slop else None

    def emit(t, msg, msg_type):
        got = nearest_pose(t)
        if got is None:
            return False
        _, pose = got
        if extrinsic is not None:
            pose = _apply_extrinsic(pose, np.asarray(extrinsic, np.float64))
        fr = {"position": pose["position"], "quat_wxyz": pose["quat_wxyz"],
              "t": np.float64(t)}
        if msg_type == "sensor_msgs/PointCloud2":
            pts, ring = pointcloud2_xyz(msg, ring_field)
            ok = np.isfinite(pts).all(axis=1)
            fr["points"] = pts[ok]
            if ring is not None:
                fr["ring"] = ring[ok]
        elif msg_type == "sensor_msgs/LaserScan":
            fr["ranges"] = msg["ranges"]
            fr["theta_min"] = np.float32(msg["angle_min"])
            fr["theta_inc"] = np.float32(msg["angle_increment"])
        elif msg_type == "sensor_msgs/Image":
            if cam_info is None:
                return False  # wait for intrinsics
            K = cam_info["K"]
            fr["depth"] = depth_image_m(msg)
            fr["fx"], fr["fy"] = np.float32(K[0]), np.float32(K[4])
            fr["cx"], fr["cy"] = np.float32(K[2]), np.float32(K[5])
        else:
            return False
        frames.append(fr)
        return True

    for bm in read_bag(path):
        if max_frames is not None and len(frames) >= max_frames:
            break
        if bm.topic == odom_topic and bm.msg_type in _POSE_TYPES:
            m = bm.parse()
            poses.append((m["header"]["stamp"] or bm.t, m))
        elif bm.topic == odom_topic and bm.msg_type in ("tf/tfMessage",
                                                        "tf2_msgs/TFMessage"):
            for tf in bm.parse()["transforms"]:
                if tf_child_frame in (None, tf["child_frame_id"]):
                    poses.append((tf["header"]["stamp"] or bm.t, tf))
        elif camera_info_topic and bm.topic == camera_info_topic:
            cam_info = bm.parse()
        elif bm.topic == sensor_topic and bm.msg_type in _SENSOR_TYPES:
            m = bm.parse()
            pending.append((m["header"]["stamp"] or bm.t, m, bm.msg_type))
        # drain sensor messages whose pose window has certainly arrived
        while pending and poses and poses[-1][0] - pending[0][0] > slop:
            t, m, mt = pending.pop(0)
            emit(t, m, mt)

    for t, m, mt in pending:
        if max_frames is not None and len(frames) >= max_frames:
            break
        emit(t, m, mt)
    return frames


def convert_bag(path, out_npz, sensor_topic, odom_topic, **kw):
    """bag -> save_frames_npz file; returns the frame count."""
    from .datasets import save_frames_npz

    frames = bag_to_frames(path, sensor_topic, odom_topic, **kw)
    if any("ring" in f for f in frames):
        # pre-bin to range rings (vlp16_map_maker.cpp:73-148) so replay uses
        # the multiscan path without a per-frame host conversion
        from .rings import cloud_to_rings

        for f in frames:
            if "ring" not in f:
                continue
            img, tmin, tinc = cloud_to_rings(f.pop("points"), f.pop("ring"))
            # VLP-16 elevation fan: -15 deg, 2 deg steps
            # (vlp16_map_maker.cpp:30-36 defaults)
            f.update(rings=img, theta_min=np.float32(tmin),
                     theta_inc=np.float32(tinc),
                     phi_min=np.float32(-0.2617994),
                     phi_inc=np.float32(0.0349066))
    save_frames_npz(out_npz, frames)
    return len(frames)


def topics(path) -> dict[str, tuple[str, int]]:
    """{topic: (msg_type, message_count)} — bag introspection helper."""
    out: dict[str, list] = {}
    for bm in read_bag(path):
        e = out.setdefault(bm.topic, [bm.msg_type, 0])
        e[1] += 1
    return {k: tuple(v) for k, v in out.items()}


def _main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("out", nargs="?", help="output .npz (omit to list topics)")
    ap.add_argument("--sensor", help="sensor topic")
    ap.add_argument("--odom", help="odometry/pose/tf topic")
    ap.add_argument("--camera-info", default=None)
    ap.add_argument("--ring-field", default=None)
    ap.add_argument("--tf-child-frame", default=None)
    ap.add_argument("--slop", type=float, default=0.1)
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)
    if args.out is None:
        for topic, (mt, n) in sorted(topics(args.bag).items()):
            print(f"{topic:40s} {mt:32s} {n}")
        return
    n = convert_bag(args.bag, args.out, args.sensor, args.odom,
                    camera_info_topic=args.camera_info,
                    ring_field=args.ring_field,
                    tf_child_frame=args.tf_child_frame, slop=args.slop,
                    max_frames=args.max_frames)
    print(f"wrote {n} frames -> {args.out}")


if __name__ == "__main__":  # pragma: no cover
    _main()
