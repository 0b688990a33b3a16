"""The harness finds paths, sensors and metric readers by name, so a new
cell, sensor or metric is new files: lookups, a sensor module that hands
the engine chunks of frames, and a reader that asks for a span of its
own."""
import types

import pytest

from mapbench import generate
from mapbench import run as run_mod
from mapbench.run import run_cell


def test_lookup_by_name():
    assert generate.plugin("paths", "circle").poses
    assert generate.plugin("sensors", "pinhole_cloud").SPAN
    for folder, kind in (("sensors", "no_such_sensor"), ("paths", "../circle"),
                         ("paths", "circle.py")):
        with pytest.raises(ValueError):
            generate.plugin(folder, kind)


def test_chunked_sensor_module(monkeypatch, tiny_flight):
    """A module that keeps frames and hands them over three at a time, and
    the rest in flush(), is replayed frame for frame."""
    depth = generate.plugin("sensors", "depth")
    held, calls = [], []

    def engine_frame(mapper, sensor, proj, data):
        held.append((proj, data))
        if len(held) == 3:
            flush(mapper)

    def flush(mapper):
        if held:
            calls.append(len(held))
        for proj, data in held:
            depth.engine_frame(mapper, sensor_of[0], proj, data)
        held.clear()

    sensor_of = []
    mod = types.SimpleNamespace(**{k: getattr(depth, k) for k in dir(depth)
                                   if not k.startswith("_")})
    mod.engine_frame, mod.flush = engine_frame, flush
    monkeypatch.setattr(generate, "sensor_module",
                        lambda sensor: sensor_of.append(sensor) or mod)
    config, tr = tiny_flight
    result, checks, _ = run_cell(config, tr, seed=5, seconds=0, device="cpu", max_frames=8)
    assert result["correct"], checks
    assert sum(calls) == 10 + 8 and 0 < len(calls) < 18


def test_reader_with_a_span_of_its_own(monkeypatch, tiny_flight):
    """A reader's SPANS are wrapped in the traced run and read back."""
    reader = types.SimpleNamespace(
        SPANS={"frame_geometry": ("models.mapper", "VolumetricMapper._frame_geometry")},
        read=lambda t: t.mean_ms("frame_geometry"))
    monkeypatch.setattr(run_mod, "metric_reader", lambda name: reader)
    config, tr = tiny_flight
    result, _, _ = run_cell(config, tr, seed=6, seconds=0, device="cpu", trace=True,
                            metrics=["geometry.ms"], max_frames=4)
    assert result["metrics"]["geometry.ms"] > 0
    import gie_mapping_tpu_torch.models.mapper as mm
    assert not hasattr(mm.VolumetricMapper._frame_geometry, "__wrapped__")
