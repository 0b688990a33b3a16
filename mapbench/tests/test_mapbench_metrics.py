"""The metric arithmetic: end-to-end numbers from a window's stamps, the
kernels' bytes, and the readers on a synthetic trace."""
import numpy as np
import pytest
import torch

from conftest import CELLS, tiny_cell
from mapbench import roofline
from mapbench.run import end_to_end, read_metric
from mapbench.trace import Recorder, Trace


def test_end_to_end():
    starts = [0.0, 0.010, 0.030, 0.035]
    m = end_to_end(starts, 0.0, 0.050, 12.5)
    assert m["setup_s"] == 12.5
    assert m["frame_ms"] == pytest.approx(50.0 / 4)
    durs = np.array([10.0, 20.0, 5.0, 15.0])
    assert m["frame_ms_p95"] == pytest.approx(np.percentile(durs, 95))


def test_kernel_bytes():
    X, Y, Z = 240, 240, 168
    n = X * Y * Z
    assert roofline.work("phase1_packed", (torch.zeros(X, Y, Z),))[0] == 5 * n
    assert roofline.work("envelope_packed", (torch.zeros(X, Z, Y), 8))[0] == 12 * n
    assert roofline.work("envelope_mid", (torch.zeros(X, Z, Y), torch.zeros(X, Z, Y)))[0] == 16 * n
    assert roofline.work("shift_canvas", (torch.zeros(X, Y, 3 * Z),))[0] == 8 * 3 * n
    assert roofline.work("gather_block_rows",
                         (None, torch.zeros(32), (30, 30, 21)))[0] == 2 * 6144 * 32 * 21
    b, o, mask = roofline.work("scatter_archive_rows",
                               (None, None, None, torch.tensor([1, 0, 1])))
    assert b == 2 * 6144 and int((mask != 0).sum()) == 2
    # 1 GB at 3.35 TB/s
    assert roofline.bound_s(1e9, 0) == pytest.approx(1e9 / 3.35e12)


def synthetic():
    rec = Recorder()
    rec.stamps["frame"] = [(0.0, 0.040), (0.040, 0.080)]
    rec.stamps["merge"] = [(0.005, 0.020), (0.045, 0.060)]
    rec.stamps["sensor"] = [(0.0, 0.004), (0.040, 0.044)]
    rec.stamps["stream"] = [(0.020, 0.039), (0.060, 0.079)]
    rec.calls["envelope_mid"] = [(16 * 10 ** 6, 10 ** 7, None)] * 2
    ms = 1_000_000
    ranges = [(0, 40 * ms, "frame"), (5 * ms, 20 * ms, "merge"),
              (40 * ms, 80 * ms, "frame"), (45 * ms, 60 * ms, "merge")]
    bound_ns = int(16e6 / 3.35e12 * 1e9)
    dev = [(6 * ms, 2 * bound_ns, "envelope_mid_fh_kernel", "merge"),
           (10 * ms, 1 * ms, "copy", "merge"),
           (46 * ms, 2 * bound_ns, "envelope_mid_fh_kernel", "merge"),
           (70 * ms, 1 * ms, "copy", "frame")]
    ev = {"device": dev, "ranges": ranges, "linked": 4}
    return Trace(rec, 2, ev, (0, 80 * ms))


def test_readers():
    t = synthetic()
    assert read_metric("edt_roofline", t) == pytest.approx(50.0, rel=1e-3)
    assert read_metric("merge.ops", t) == 1.5
    assert read_metric("merge.ms", t) == pytest.approx(15.0)
    assert read_metric("mapper.host_ms", t) == pytest.approx(40.0 - 4 - 15 - 19)
    assert read_metric("device.ops_per_frame", t) == 2.0
    busy = 2 * 2 * int(16e6 / 3.35e12 * 1e9) + 2_000_000
    assert read_metric("device.idle_share", t) == pytest.approx(100 * (1 - busy / 80e6))
    assert read_metric("scroll.ms", t) is None      # nothing to read
    gaps = t.idle_gaps()
    assert set(gaps) <= {"frame", "merge"} and sum(gaps.values()) == pytest.approx(
        (80e6 - busy) / 1e9)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: ".".join(c))
def test_traced_run_reads_host_spans(cell):
    """A traced tiny run on the CPU: every span is wrapped and unwrapped,
    and the readers of host spans find something (device ones need a
    card)."""
    import json
    from pathlib import Path

    from mapbench.run import run_cell
    bench = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    config, tr = tiny_cell(cell)
    result, _, _ = run_cell(config, tr, seed=9, seconds=0, device="cpu", trace=True,
                            metrics=names, max_frames=5)
    got = result["metrics"]
    assert result["correct"]
    for name in ("mapper.host_ms", "sensor.ms", "merge.ms", "stream.ms", "stream.ingest_ms"):
        assert got[name] > 0
    assert ("scroll.ms" in got) == bool(tr["path"]["laps"])
    import gie_mapping_tpu_torch.models.mapper as mm
    assert not hasattr(mm.merge_frame, "__wrapped__")
