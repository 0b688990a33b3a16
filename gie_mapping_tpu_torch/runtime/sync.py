"""Approximate-time message synchronisation for replayed sensor streams.

A copy of gie_mapping_tpu/runtime/sync.py for the PyTorch port.

Counterpart of the reference's message_filters ApproximateTime policy pairing
each sensor message with the closest odometry sample
(src/volumetric_mapper.cpp:19-57) and of its MsgMgr readiness
gate (include/volumetric_mapper.h:56-59).
"""
from __future__ import annotations

import bisect
from typing import Any, List, Optional, Tuple


class ApproximateTimeSync:
    """Pairs (stamp, payload) sensor messages with the nearest odometry
    (stamp, pose) sample within `slop` seconds."""

    def __init__(self, slop: float = 0.1, queue_size: int = 100):
        self.slop = slop
        self.queue_size = queue_size
        self._odom_t: List[float] = []
        self._odom_v: List[Any] = []

    def push_odom(self, stamp: float, pose: Any):
        i = bisect.bisect(self._odom_t, stamp)
        self._odom_t.insert(i, stamp)
        self._odom_v.insert(i, pose)
        if len(self._odom_t) > self.queue_size:
            self._odom_t.pop(0)
            self._odom_v.pop(0)

    def match(self, stamp: float) -> Optional[Tuple[float, Any]]:
        """Nearest odom sample within slop, or None."""
        if not self._odom_t:
            return None
        i = bisect.bisect(self._odom_t, stamp)
        cands = []
        if i > 0:
            cands.append(i - 1)
        if i < len(self._odom_t):
            cands.append(i)
        best = min(cands, key=lambda j: abs(self._odom_t[j] - stamp))
        if abs(self._odom_t[best] - stamp) > self.slop:
            return None
        return self._odom_t[best], self._odom_v[best]


class MsgMgr:
    """Readiness gate: the map cycle runs only when a fresh synchronized
    sensor frame is pending (volumetric_mapper.h:56-59)."""

    def __init__(self):
        self._pending = None

    def offer(self, frame):
        self._pending = frame

    @property
    def is_ready(self) -> bool:
        return self._pending is not None

    def take(self):
        f, self._pending = self._pending, None
        return f
