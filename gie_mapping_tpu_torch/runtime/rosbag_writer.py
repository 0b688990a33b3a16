"""Minimal rosbag-v1 (format 2.0) WRITER + ROS1 message serializers.

A copy of gie_mapping_tpu/runtime/rosbag_writer.py for the PyTorch port.

The reader (runtime/rosbag.py) makes recorded dataset bags drop-in
(README.md:102-145 of the reference lists the five public bags); this writer
closes the loop without ROS: generate full-scale synthetic bags with the
exact container layout (bag-header record, connection records, plain and
bz2-compressed chunks) and real message serializations, then rehearse the
whole convert -> replay pipeline (examples/make_synthetic_bag.py,
tests/test_rosbag_rehearsal.py).  Implements the documented container format
(http://wiki.ros.org/Bags/Format/2.0); byte-level layout is pinned against
the independent reader by tests/test_rosbag.py's fixtures.
"""
from __future__ import annotations

import bz2
import struct

import numpy as np


def _hdr(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        f = k.encode() + b"=" + v
        out += struct.pack("<I", len(f)) + f
    return out


def _rec(fields: dict, data: bytes = b"") -> bytes:
    h = _hdr(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def conn_record(cid: int, topic: str, msg_type: str) -> bytes:
    info = _hdr({"topic": topic.encode(), "type": msg_type.encode(),
                 "md5sum": b"0" * 32, "message_definition": b""})
    return _rec({"op": b"\x07", "conn": struct.pack("<I", cid),
                 "topic": topic.encode()}, info)


def msg_record(cid: int, t: float, body: bytes) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    return _rec({"op": b"\x02", "conn": struct.pack("<I", cid),
                 "time": struct.pack("<II", secs, nsecs)}, body)


def chunk_record(records: bytes, compression: str = "none") -> bytes:
    if compression == "none":
        payload = records
    elif compression == "bz2":
        payload = bz2.compress(records)
    elif compression == "lz4":  # LZ4 frame format, as roslz4 writes
        from .lz4f import compress

        payload = compress(records)
    else:
        raise ValueError(f"unknown chunk compression {compression!r}")
    return _rec({"op": b"\x05", "compression": compression.encode(),
                 "size": struct.pack("<I", len(records))}, payload)


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def ros_header(t: float, frame: str = "map") -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    return struct.pack("<III", 7, secs, nsecs) + _string(frame)


# ---------------------------------------------------------------------------
# message serializers (sensor_msgs / nav_msgs / geometry_msgs / tf)
# ---------------------------------------------------------------------------

def laserscan(t, ranges, tmin=-np.pi, tinc=2 * np.pi / 360,
              range_max=30.0) -> bytes:
    r = np.asarray(ranges, np.float32)
    body = ros_header(t, "laser")
    body += struct.pack("<7f", tmin, tmin + tinc * (len(r) - 1), tinc,
                        0.0, 0.1, 0.02, range_max)
    body += struct.pack("<I", len(r)) + r.tobytes()
    body += struct.pack("<I", 0)  # intensities
    return body


def odometry(t, pos, quat_wxyz) -> bytes:
    w, x, y, z = quat_wxyz
    body = ros_header(t, "odom") + _string("base")
    body += struct.pack("<3d", *pos) + struct.pack("<4d", x, y, z, w)
    body += struct.pack("<36d", *([0.0] * 36))          # pose covariance
    body += struct.pack("<6d", *([0.0] * 6))            # twist
    body += struct.pack("<36d", *([0.0] * 36))          # twist covariance
    return body


def transform_stamped(t, pos, quat_wxyz, child_frame="base") -> bytes:
    """geometry_msgs/TransformStamped (the cow-lady vicon pose topic's type,
    launch/cow_dataset.launch)."""
    w, x, y, z = quat_wxyz
    body = ros_header(t, "world") + _string(child_frame)
    body += struct.pack("<3d", *pos) + struct.pack("<4d", x, y, z, w)
    return body


def tf_message(transforms) -> bytes:
    """tf/tfMessage: list of pre-serialized transform_stamped bodies."""
    return struct.pack("<I", len(transforms)) + b"".join(transforms)


def pointcloud2(t, xyz, ring=None) -> bytes:
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
    step = 12
    if ring is not None:
        fields.append(("ring", 12, 4, 1))  # uint16
        step = 14
    body = ros_header(t, "lidar")
    body += struct.pack("<II", 1, n)  # height, width
    body += struct.pack("<I", len(fields))
    for name, off, dt, cnt in fields:
        body += _string(name) + struct.pack("<IBI", off, dt, cnt)
    data = np.zeros((n, step), np.uint8)
    data[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    if ring is not None:
        data[:, 12:14] = (np.asarray(ring, np.uint16)
                          .view(np.uint8).reshape(n, 2))
    body += struct.pack("<B", 0)                        # is_bigendian
    body += struct.pack("<II", step, step * n)          # point_step, row_step
    body += struct.pack("<I", data.size) + data.tobytes()
    body += struct.pack("<B", 1)                        # is_dense
    return body


def depth_image(t, depth_m) -> bytes:
    d = np.asarray(depth_m, np.float32)
    body = ros_header(t, "cam")
    body += struct.pack("<II", d.shape[0], d.shape[1])
    body += _string("32FC1") + struct.pack("<B", 0)
    body += struct.pack("<I", d.shape[1] * 4)
    body += struct.pack("<I", d.nbytes) + d.tobytes()
    return body


def camera_info(t, fx, fy, cx, cy, h, w) -> bytes:
    body = ros_header(t, "cam")
    body += struct.pack("<II", h, w) + _string("plumb_bob")
    body += struct.pack("<I", 0)  # D
    K = np.array([fx, 0, cx, 0, fy, cy, 0, 0, 1], np.float64)
    body += K.tobytes()
    body += np.eye(3, dtype=np.float64).tobytes()
    body += np.zeros(12, np.float64).tobytes()
    body += struct.pack("<II", 0, 0)
    body += struct.pack("<IIIIB", 0, 0, 0, 0, 0)
    return body


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class BagWriter:
    """Accumulate (topic, msg_type, t, body) and write a v2.0 bag.

    Messages are written in the order added, packed into chunks of
    `chunk_messages` records; connection records go into the first chunk
    (the layout the reader — and rosbag's own reindexer — accepts)."""

    def __init__(self, chunk_messages: int = 200, compression: str = "bz2"):
        self.chunk_messages = chunk_messages
        self.compression = compression
        self._conns: dict[tuple[str, str], int] = {}
        self._msgs: list[tuple[int, float, bytes]] = []

    def add(self, topic: str, msg_type: str, t: float, body: bytes):
        cid = self._conns.setdefault((topic, msg_type), len(self._conns))
        self._msgs.append((cid, t, body))

    def write(self, path):
        blob = b"#ROSBAG V2.0\n"
        n_chunks = -(-len(self._msgs) // self.chunk_messages) if self._msgs else 0
        blob += _rec({"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                      "conn_count": struct.pack("<I", len(self._conns)),
                      "chunk_count": struct.pack("<I", n_chunks)},
                     b"\x20" * 128)
        conns = b"".join(conn_record(cid, topic, mt)
                         for (topic, mt), cid in self._conns.items())
        for i in range(0, len(self._msgs), self.chunk_messages):
            recs = b"".join(msg_record(cid, t, body)
                            for cid, t, body in
                            self._msgs[i:i + self.chunk_messages])
            blob += chunk_record(conns + recs, self.compression)
            conns = b""
        with open(path, "wb") as f:
            f.write(blob)
        return len(self._msgs)
