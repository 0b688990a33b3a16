"""The engine's own spans and counters in a traced run, for the metric
readers that read them.

The engine records them itself (gie_mapping_tpu_torch/runtime/profiler.py:
`enable`, `disable`, `take`), stamped on the clock of the profiler's
records.  A reader of them calls `start()` when it is loaded: the harness
loads every reader before the traced window opens, and again when it reads
it after the window.  `start()` switches the engine's recording on with
stamps only, no record_function range, so the profiler session's records
and the benchmark's own spans are what they are without it.  The first
`of(t)` after the window switches it off, drains the records and hands
those of the window to the Trace as `t.program`.  An engine without the API
records nothing: `start()` does nothing there, `of(t)` gives None and so
does every reader of it.
"""
from __future__ import annotations

import importlib
from collections import defaultdict

from .trace import _innermost

ENGINE_PROFILER = "gie_mapping_tpu_torch.runtime.profiler"


def _api():
    """The engine's profiler module where it has the span API, else None."""
    try:
        mod = importlib.import_module(ENGINE_PROFILER)
    except ImportError:
        return None
    if all(hasattr(mod, f) for f in ("enable", "disable", "enabled", "take")):
        return mod
    return None


def start():
    """Switch the engine's recording on, stamps only (a reader's load)."""
    api = _api()
    if api is not None and not api.enabled():
        api.enable(ranges=False)


class Program:
    """The engine's records of one window: spans (name, start_ns, end_ns,
    parent, frame id) that start in it and counters (name, value, frame id,
    ns) counted in it."""

    def __init__(self, spans, counters, window):
        w0, w1 = window
        self.spans = [s for s in spans if w0 <= s[1] < w1]
        self.counters = [c for c in counters if w0 <= c[3] < w1]
        self.ms = defaultdict(list)        # span name -> [ms]
        for name, a, b, _, _ in self.spans:
            self.ms[name].append((b - a) / 1e6)
        self.values = defaultdict(list)    # counter name -> [value]
        for name, v, _, _ in self.counters:
            self.values[name].append(v)

    def calls(self, name):
        return len(self.ms.get(name, ()))

    def total_ms(self, *names):
        return sum(sum(self.ms.get(n, ())) for n in names)

    def mean_ms(self, name):
        v = self.ms.get(name)
        return sum(v) / len(v) if v else None

    def mean(self, counter):
        v = self.values.get(counter)
        return sum(v) / len(v) if v else None


def of(t):
    """The engine's records of traced window `t` (a Program), or None where
    the engine recorded nothing."""
    api = _api()
    if api is not None:
        api.disable()
        spans, counters = api.take()
        if getattr(t, "program", None) is None and (spans or counters):
            t.program = Program(spans, counters, t.window_ns)
    return getattr(t, "program", None)


def idle_gaps(t):
    """{engine span the host was in: idle device seconds} over the window
    (Trace.idle_gaps's reduction over the engine's own spans; `harness`
    outside them), or None where the engine recorded nothing."""
    p = of(t)
    if p is None:
        return None
    spans = sorted((a, b, name) for name, a, b, _, _ in p.spans)
    starts = [s[0] for s in spans]
    w0, w1 = t.window_ns
    gaps = defaultdict(float)
    end = w0
    for s, d, _, _ in t.device + [(w1, 0, "", None)]:
        s = min(s, w1)
        if s > end:
            mid = (s + end) // 2
            gaps[_innermost(spans, starts, mid) or "harness"] += (s - end) / 1e9
        end = max(end, s + d)
    return dict(gaps)
