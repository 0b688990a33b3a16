"""The readers of the engine's own spans and counters (mapbench/program.py):
on a synthetic trace that carries the engine's records, None from each
where there are none, and a traced tiny run in which switching the
engine's recording on leaves the other metrics as they were."""
import pytest

from conftest import tiny_cell
from mapbench import program
from mapbench import trace as trace_mod
from mapbench.run import read_metric, run_cell
from mapbench.trace import Recorder, Trace

MS = 1_000_000
NEW = ("merge.gate_wait_ms", "gate.edt_vox", "scroll.archive_ms",
       "stream.unpack_ms", "stream.blocks_per_tick", "stream.backlog_cols",
       "sensor.stage_ms", "stream.rows_per_tick", "scroll.cols")


def synthetic(with_program=True):
    """Two 40 ms frames in an 80 ms window; one scroll; the engine's spans
    and counters of both, and a span and a counter outside the window."""
    ev = {"device": [(6 * MS, 1 * MS, "k", "merge"), (46 * MS, 2 * MS, "k", "merge")],
          "ranges": [(0, 40 * MS, "frame"), (40 * MS, 80 * MS, "frame")], "linked": 2}
    t = Trace(Recorder(), 2, ev, (0, 80 * MS))
    if not with_program:
        return t
    spans, counters = [], []
    for f, base in ((1, 0), (2, 40)):
        at = lambda a, b: ((base + a) * MS, (base + b) * MS)
        for name, (a, b), parent in (
                ("frame", at(0, 40), None), ("sensor.stage", at(0, 1), "frame"),
                ("merge", at(5, 20), "frame"), ("merge.gate_wait", at(9, 9.5 + f), "merge"),
                ("stream", at(20, 39), "frame"), ("stream.ingest", at(21, 38), "stream"),
                ("stream.unpack", at(21, 21 + 2 * f), "stream.ingest")):
            spans.append((name, a, b, parent, f))
        for name, v in (("gate.slab_vox", 1000 * f), ("stream.blocks", 10 * f),
                        ("stream.backlog_cols", 3 * f), ("stream.rows", 84 * f)):
            counters.append((name, v, f, (base + 22) * MS))
    spans += [("scroll.archive_out", 2 * MS, 3 * MS, "scroll", 1),
              ("scroll.shift", 3 * MS, 4 * MS, "scroll", 1),
              ("scroll.archive_in", 4 * MS, 4.5 * MS, "scroll", 1),
              ("merge.gate_wait", 90 * MS, 99 * MS, "merge", 3)]     # after the window
    counters.append(("scroll.cols", 64, 1, 2 * MS))
    counters.append(("stream.blocks", 500, None, 85 * MS))
    t.program = program.Program(spans, counters, t.window_ns)
    return t


def test_readers_of_the_engine_records():
    t = synthetic()
    assert read_metric("merge.gate_wait_ms", t) == pytest.approx((1.5 + 2.5) / 2)
    assert read_metric("gate.edt_vox", t) == 1500
    assert read_metric("scroll.archive_ms", t) == pytest.approx(1.5)
    assert read_metric("stream.unpack_ms", t) == pytest.approx(3.0)
    assert read_metric("stream.blocks_per_tick", t) == 15
    assert read_metric("stream.backlog_cols", t) == 4.5
    assert read_metric("sensor.stage_ms", t) == pytest.approx(1.0)
    assert read_metric("stream.rows_per_tick", t) == 126
    assert read_metric("scroll.cols", t) == 64
    # idle 0-6 ms (its middle in the scroll's shift), 7-46 and 48-80 ms
    # (theirs in the ingests)
    assert program.idle_gaps(t) == pytest.approx(
        {"scroll.shift": 0.006, "stream.ingest": 0.039 + 0.032})


def test_readers_find_nothing_without_engine_records():
    t = synthetic(with_program=False)
    for name in NEW:
        assert read_metric(name, t) is None, name
    assert program.idle_gaps(t) is None
    scrollless = synthetic()
    scrollless.program.ms.pop("scroll.shift")
    assert read_metric("scroll.archive_ms", scrollless) is None


def test_engine_spans_leave_the_other_metrics_as_they_were(monkeypatch):
    """A traced tiny run with the benchmark's metrics alone and with the
    readers of the engine's records too: the engine records stamps only
    (no gie/ range reaches the profiler session), the device and merge
    operation counts and the frames read the same, and the engine stops
    recording after the reads."""
    import json
    from pathlib import Path

    from gie_mapping_tpu_torch.runtime import profiler

    bench = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    assert set(NEW) <= set(names)
    seen = []
    real = trace_mod.read_events

    def spy(prof):
        seen.append(sorted({e.name() for e in prof.profiler.kineto_results.events()
                            if e.name().startswith(profiler.PREFIX)}))
        return real(prof)

    monkeypatch.setattr(trace_mod, "read_events", spy)
    config, tr = tiny_cell(("depthcam", "flight"))
    got = {}
    for with_new in (False, True):
        metrics = names if with_new else [n for n in names if n not in NEW]
        result, _, _ = run_cell(config, tr, seed=11, seconds=0, device="cpu", trace=True,
                                metrics=metrics, max_frames=6)
        assert result["correct"]
        got[with_new] = result["metrics"]
        assert not profiler.enabled()
    assert seen == [[], []]
    for name in ("device.ops_per_frame", "merge.ops"):
        assert got[True].get(name) == got[False].get(name), name
    assert not set(NEW) & set(got[False])
    for name in NEW:
        assert got[True][name] >= 0, name
    assert got[True]["merge.gate_wait_ms"] > 0 and got[True]["gate.edt_vox"] > 0
