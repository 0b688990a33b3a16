"""Tracing of the PyTorch port: the engine's own spans and counters, and a
torch.profiler trace writer.

Counterpart of gie_mapping_tpu/runtime/profiler.py (the reference's
wall-clock brackets, volumetric_mapper.cpp:153, 186-203), without its
device syncs: no span or counter waits for the device or reads a tensor.

    from gie_mapping_tpu_torch.runtime import profiler
    profiler.enable()
    mapper.process_depth(...)
    spans, counters = profiler.take()
    profiler.disable()

Off (the default) `span` returns one shared no-op context and `count`
returns at once.  On, a span stamps its start and end with time.time_ns(),
the clock of torch.profiler's (kineto's) records, so a span and the device
records it launched lie on one time line; it takes its parent and its frame
id (the mapper's `map_ct` of the frame, set by the frame's root span) from a
per-thread stack, and with `ranges` on it also opens a `gie/<name>`
record_function range, which any torch.profiler session shows.  Records
stay in memory until `take()` drains them, at most CAP of them; beyond it
the oldest are dropped and a `trace.dropped` counter says how many.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch

PREFIX = "gie/"
CAP = 1 << 20  # records kept between two take() calls

_on = False
_ranges = True
_records: collections.deque = collections.deque(maxlen=CAP)
_dropped = 0
_local = threading.local()
_NULL = contextlib.nullcontext()


def enable(ranges: bool = True) -> None:
    """Start recording spans and counters; `ranges` also opens a
    record_function range per span (False: stamps in memory only, so a
    profiler session's records are what they are without the spans)."""
    global _on, _ranges
    _on, _ranges = True, bool(ranges)


def disable() -> None:
    """Stop recording; the records stay until take()."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take():
    """Drain the records: (spans, counters).  A span is (name, start_ns,
    end_ns, parent name or None, frame id or None), a counter (name, value,
    frame id or None, ns when counted); `trace.dropped` counts records lost
    to the cap since the last take()."""
    global _dropped
    recs = list(_records)
    _records.clear()
    spans = [r for r in recs if len(r) == 5]
    counters = [r for r in recs if len(r) == 4]
    if _dropped:
        counters.append(("trace.dropped", _dropped, None, time.time_ns()))
        _dropped = 0
    return spans, counters


def _keep(rec) -> None:
    global _dropped
    if len(_records) == CAP:
        _dropped += 1
    _records.append(rec)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    """One recorded span; `ms` is its duration once it has ended."""

    __slots__ = ("name", "frame", "record", "t0", "t1", "parent", "_rf")

    def __init__(self, name, frame, record):
        self.name, self.frame, self.record = name, frame, record
        self.t1 = self._rf = None

    def __enter__(self):
        if self.record:
            stack = _stack()
            top = stack[-1] if stack else None
            self.parent = top.name if top is not None else None
            if self.frame is None and top is not None:
                self.frame = top.frame
            stack.append(self)
            if _ranges:
                self._rf = torch.profiler.record_function(PREFIX + self.name)
                self._rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.record:
            if self._rf is not None:
                self._rf.__exit__(*exc)
            _stack().pop()
            _keep((self.name, self.t0, self.t1, self.parent, self.frame))
        return False

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


def span(name: str, frame=None):
    """A context recording span `name` while tracing is on; `frame` (a
    root span's) is the frame id its descendants inherit."""
    if not _on:
        return _NULL
    return _Span(name, frame, True)


def timed(name: str):
    """A span whose duration the program keeps whether tracing is on or
    off (`.ms` after the block): one pair of stamps for both."""
    return _Span(name, None, _on)


def count(name: str, value) -> None:
    """Record counter `name` at `value`, a number the host already holds,
    while tracing is on."""
    if not _on:
        return
    stack = _stack()
    _keep((name, value, stack[-1].frame if stack else None, time.time_ns()))


@contextlib.contextmanager
def torch_trace(log_dir: str, device="cuda"):
    """Trace the enclosed work with torch.profiler (host and, on a card,
    device activity) and the engine's spans, and write it as a Chrome trace
    to log_dir/trace.json.  Yields the profiler; the spans' records stay
    for take()."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    dev = torch.device(device)
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = (_on, _ranges)
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        if was[0]:
            enable(was[1])
        else:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
