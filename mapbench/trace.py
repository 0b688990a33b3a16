"""The traced run's instrumentation: spans around the engine's layers,
the kernels' call shapes, one profiler session over the window, and the
reduction of its raw events to what the metric readers read.

Spans are the benchmark's own: `install` wraps, by name, the functions
the mapper module calls (the canvas scroll, the merge, the sensor model
that the sensor module names, the EDT, the streaming tick and the
mirror's ingest) and the kernel wrappers, each call in a record_function
range with host stamps.
The profiler's raw kineto events are read (building its FunctionEvents
for a long session costs seconds), and each device record is given to
the innermost span whose host side launched it.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict

import torch

from . import roofline

PREFIX = "mapbench/"
PKG = "gie_mapping_tpu_torch"
# span name -> (module, attribute): the layer functions wrapped by name
SPANS = {
    "scroll": ("models.mapper", "scroll_step"),
    "merge": ("models.mapper", "merge_frame"),
    "edt": ("models.pipeline", "batch_edt"),
    "edt_slab": ("models.pipeline", "batch_edt_slab"),
    "stream": ("models.mapper", "VolumetricMapper._stream"),
    "ingest": ("runtime.host_mirror", "HostMirror.ingest_rows"),
}
CHILDREN_OF_FRAME = ("sensor", "scroll", "merge", "stream")


class Recorder:
    """Host stamps per span name and the kernel calls of a traced window."""

    def __init__(self):
        self.stamps = defaultdict(list)     # name -> [(t0, t1)] seconds
        self.calls = defaultdict(list)      # kernel -> [(bytes, ops, mask)]
        self.active = False

    def wrap(self, name, f):
        rec = self

        def g(*a, **kw):
            if not rec.active:
                return f(*a, **kw)
            t0 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + name):
                r = f(*a, **kw)
            rec.stamps[name].append((t0, time.perf_counter()))
            return r
        g.__wrapped__ = f
        return g

    def wrap_kernel(self, name, f):
        rec = self

        def g(*a, **kw):
            if rec.active:
                rec.calls[name].append(roofline.work(name, a, kw))
            return f(*a, **kw)
        g.__wrapped__ = f
        return g

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + "frame"):
            yield
        self.stamps["frame"].append((t0, time.perf_counter()))


def _resolve(path):
    """(holder, key) of an engine attribute path (module, "a.b.c"); a dict
    on the way is entered by key."""
    mod, attr = path
    obj = importlib.import_module(f"{PKG}.{mod}")
    parts = attr.split(".")
    for p in parts[:-1]:
        obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
    return obj, parts[-1]


def install(rec: Recorder, sensor_span, extra=None):
    """Wrap the spans' functions, the sensor model at `sensor_span` (a
    sensor module's SPAN), the `extra` spans that metric readers ask for
    ({span: (module, attribute path)}) and the kernel wrappers; returns an
    undo callable."""
    undo = []

    def patch(obj, attr, new):
        if isinstance(obj, dict):
            old = obj[attr]
            obj[attr] = new(old)
            undo.append(lambda: obj.__setitem__(attr, old))
        else:
            old = getattr(obj, attr)
            setattr(obj, attr, new(old))
            undo.append(lambda: setattr(obj, attr, old))

    spans = dict(SPANS, sensor=tuple(sensor_span))
    for name, path in (extra or {}).items():
        spans.setdefault(name, tuple(path))
    for name, path in spans.items():
        obj, attr = _resolve(path)
        patch(obj, attr, lambda f, n=name: rec.wrap(n, f))
    for kernel, (mods, _) in roofline.KERNELS.items():
        for m in mods:
            patch(importlib.import_module(f"{PKG}.{m}"), kernel,
                  lambda f, k=kernel: rec.wrap_kernel(k, f))

    def restore():
        for u in reversed(undo):
            u()
    return restore


class Trace:
    """What a traced window gives the metric readers."""

    def __init__(self, rec: Recorder, frames: int, events, window):
        self.rec = rec
        self.frames = frames
        self.window_ns = window          # (start, end) on the profiler clock
        self.device = events["device"]   # [(start, dur, name, span)]
        self.ranges = events["ranges"]
        self.linked = events["linked"]

    # -- host spans ---------------------------------------------------------
    def span_ms(self, name):
        """[ms] of every call of span `name`."""
        return [(b - a) * 1e3 for a, b in self.rec.stamps.get(name, [])]

    def mean_ms(self, name):
        v = self.span_ms(name)
        return sum(v) / len(v) if v else None

    def frame_self_ms(self):
        """Host ms a frame spends outside its child spans, per frame."""
        frames = self.rec.stamps.get("frame", [])
        if not frames:
            return None
        inside = 0.0
        for child in CHILDREN_OF_FRAME:
            inside += sum(b - a for a, b in self.rec.stamps.get(child, []))
        total = sum(b - a for a, b in frames)
        return (total - inside) * 1e3 / len(frames)

    # -- device records -----------------------------------------------------
    def busy_ns(self):
        """Length of the union of device records within the window."""
        w0, w1 = self.window_ns
        busy, end = 0, w0
        for s, d, _, _ in self.device:
            a, b = max(s, end), min(s + d, w1)
            if b > a:
                busy += b - a
            end = max(end, min(s + d, w1))
        return busy

    def ops_in(self, spans):
        """Device records launched inside any of `spans` (names)."""
        return sum(1 for *_, sp in self.device if sp in spans)

    def kernel_device_s(self, kernel):
        names = roofline.KERNELS[kernel][1]
        return sum(d for _, d, n, _ in self.device if any(k in n for k in names)) / 1e9

    def kernel_bound_s(self, kernel):
        tot = 0.0
        for b, o, mask in self.rec.calls.get(kernel, []):
            k = int((mask != 0).sum()) if mask is not None else 1
            tot += roofline.bound_s(b * k, o * k)
        return tot

    def roofline_share(self, kernels):
        """Summed bound over summed device time of `kernels`, in %, or None
        where none of them ran."""
        dev = sum(self.kernel_device_s(k) for k in kernels)
        if dev <= 0 or not any(self.rec.calls.get(k) for k in kernels):
            return None
        return 100.0 * sum(self.kernel_bound_s(k) for k in kernels) / dev

    def idle_gaps(self):
        """{what the host was doing: idle device seconds} over the window."""
        w0, w1 = self.window_ns
        gaps = defaultdict(float)
        end = w0
        starts = [r[0] for r in self.ranges]
        for s, d, _, _ in self.device + [(w1, 0, "", None)]:
            s = min(s, w1)
            if s > end:
                mid = (s + end) // 2
                gaps[_innermost(self.ranges, starts, mid) or "harness"] += (s - end) / 1e9
            end = max(end, s + d)
        return dict(gaps)

    def device_ops(self):
        tot = defaultdict(float)
        for _, d, n, _ in self.device:
            tot[n] += d / 1e9
        return dict(tot)


def _innermost(spans, starts, t, reach=64):
    """Name of the innermost span [(start, end, name)] (sorted by start)
    holding time t: walking back from the last span that starts by t, the
    first that holds t starts latest.  Spans nest or are disjoint."""
    i = bisect.bisect_right(starts, t)
    for s, e, n in reversed(spans[max(0, i - reach):i]):
        if s <= t < e:
            return n
    return None


def read_events(prof) -> dict:
    """Reduce a profiler session's raw kineto events: the mapbench ranges,
    and every device record with the span whose host side launched it (by
    the runtime call's correlation id; by its own start where no runtime
    call links to it)."""
    from torch.autograd import DeviceType

    ranges, runtime, dev = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                ranges.append((e.start_ns(), e.end_ns(), name[len(PREFIX):]))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and not name.startswith(PREFIX):
            # (a range's device-side annotation is no device record)
            dev.append((e.start_ns(), e.duration_ns(), name,
                        e.correlation_id(), e.linked_correlation_id()))
    spans = sorted(r for r in ranges if r[2] not in ("window",))
    starts = [r[0] for r in spans]
    out, linked = [], 0
    for s, d, name, c1, c2 in sorted(dev):
        t = runtime.get(c1, runtime.get(c2))
        if t is not None:
            linked += 1
        out.append((s, d, name, _innermost(spans, starts, s if t is None else t)))
    return {"device": out, "ranges": spans, "linked": linked,
            "window": [r for r in ranges if r[2] == "window"]}
