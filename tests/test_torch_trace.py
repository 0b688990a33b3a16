"""The port's own spans and counters (runtime/profiler.py) on tiny CPU
maps: off records nothing, on every frame records each span of its path
once, nested and sharing its frame id, the counters equal the values the
mapper reports, tracing changes neither the host reads nor the map, and
each span's stamps lie on its torch.profiler range."""
import collections

import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch.map_state import (output_digest, state_digest,
                                             state_to_numpy)
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
from gie_mapping_tpu_torch.ops.kernels import _build
from gie_mapping_tpu_torch.runtime import profiler
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as geo

# every span but the root `frame` and the spans outside frames, with its
# parent
PARENT = {
    "sensor.stage": "frame", "sensor": "frame", "scroll": "frame",
    "merge": "frame", "stream": "frame", "capacity.wait": "frame",
    "scroll.archive_out": "scroll", "scroll.shift": "scroll",
    "scroll.archive_in": "scroll",
    "merge.fuse": "merge", "merge.gate": "merge", "merge.gate_wait": "merge",
    "merge.edt": "merge", "merge.tail": "merge",
    "stream.wait": "stream", "stream.ingest": "stream",
    "stream.unpack": "stream.ingest",
}
SCROLL = {"scroll", "scroll.archive_out", "scroll.shift", "scroll.archive_in"}
# spans that need the previous frame's streamed rows and capacity scalars
AFTER_FIRST = {"stream.wait", "stream.ingest", "stream.unpack",
               "capacity.wait"}
KINDS = ("depth", "pointcloud")


@pytest.fixture(autouse=True)
def _one_torch_thread_and_tracing_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.disable()
    profiler.take()
    yield
    profiler.disable()
    profiler.take()
    torch.set_num_threads(n)


def _mapper(kind):
    small = dict(edt_gate_min_vox=0, max_blocks=4096)
    if kind == "depth":
        cfg = tcfg.depthcam_config(local_size_m=(5.0, 5.0, 2.0),
                                   voxel_width=0.2, cutoff_dist=2.0, **small)
    else:
        cfg = tcfg.cow_lady_config(local_size_m=(4.0, 4.0, 1.6),
                                   max_raycast_points=4096, **small)
    return VolumetricMapper(cfg, device="cpu")


def _frames(kind, n=5):
    """n poses moving +x by 0.7 m a frame (the canvas scrolls) and the
    sensor's measurement at each."""
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    yaw = 0.3
    q = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
    out = []
    for i in range(n):
        proj = geo.Projection.from_pose(
            np.asarray([-1.2 + 0.7 * i, 0.2 * i, 1.0], np.float32), q)
        if kind == "depth":
            out.append((proj, world.depth_image(proj, rows=24, cols=32)))
        else:
            out.append((proj, world.pointcloud(proj, n_rays=2048,
                                               max_range=8.0, seed=i)))
    return out


def _step(m, kind, proj, data):
    if kind == "depth":
        return m.process_depth(proj, *data)
    return m.process_pointcloud(proj, data)


def _run(kind, frames, on):
    """A fresh mapper through `frames` and the final flush, tracing on or
    off; returns (mapper, outputs, (spans, counters), per-frame host
    facts)."""
    if on:
        profiler.enable()
    m = _mapper(kind)
    outs, facts = [], []
    for proj, data in frames:
        before = m.stream_ingested
        out = _step(m, kind, proj, data)
        outs.append(out)
        facts.append({"ingested": m.stream_ingested - before,
                      "leftover": m.capacity_report()["stream_leftover"],
                      "origin": tuple(m._origin)})
    m.flush_stream()
    profiler.disable()
    return m, outs, profiler.take(), facts


def _by_frame(spans):
    got = collections.defaultdict(list)
    for s in spans:
        got[s[4]].append(s)
    return got


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    """Tracing off (the default): no record, no record_function range."""
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not profiler.enabled()
    assert profiler.span("merge") is profiler.span("frame")  # one shared no-op
    _run("depth", _frames("depth", 3), on=False)
    assert profiler.take() == ([], [])
    assert entered == []
    _run("depth", _frames("depth", 2), on=True)     # and on, it does
    assert any(a[0] == profiler.PREFIX + "merge" for a in entered)


@pytest.mark.parametrize("kind", KINDS)
def test_each_span_once_nested_in_its_parent(kind):
    """On: every frame records each span of its path once (the scroll's on
    the frames that move the canvas; the stream's ingest and the capacity
    wait from the second frame), each inside its parent, with the frame's
    id; children's durations sum to no more than their parent's."""
    frames = _frames(kind)
    m, _, (spans, _), facts = _run(kind, frames, on=True)
    # outside frames: the mapper's creation and the final flush
    outside = {s[0]: s[3] for s in spans if s[4] is None}
    assert outside == {"mapper.create": None, "stream.wait": None,
                       "stream.ingest": None, "stream.unpack": "stream.ingest"}
    by = _by_frame(spans)
    assert sorted(k for k in by if k is not None) == list(range(1, len(frames) + 1))
    moved = [True] + [facts[i]["origin"] != facts[i - 1]["origin"]
                      for i in range(1, len(facts))]
    assert sum(moved[1:]) >= 1, "the canvas never scrolled"
    for fid, recs in by.items():
        if fid is None:
            continue
        names = collections.Counter(s[0] for s in recs)
        want = {"frame"} | set(PARENT) - SCROLL
        if fid == 1:
            want -= AFTER_FIRST
        if moved[fid - 1]:
            want |= SCROLL
        assert dict(names) == {n: 1 for n in want}, fid
        one = {s[0]: s for s in recs}
        assert one["frame"][3] is None
        for name, (_, t0, t1, parent, f) in one.items():
            assert t0 <= t1 and f == fid
            if name == "frame":
                continue
            assert parent == PARENT[name], name
            p = one[parent]
            assert p[1] <= t0 and t1 <= p[2], (name, parent)
        for parent in set(PARENT.values()) & set(one):
            kids = sum(s[2] - s[1] for s in recs if s[3] == parent)
            assert kids <= one[parent][2] - one[parent][1], parent
    assert m.map_ct == len(frames)


@pytest.mark.parametrize("kind", KINDS)
def test_counters_equal_the_mapper_report(kind):
    """The gate's slab voxels and its wait equal FrameOutput's; the
    ingested blocks a frame equal stream_ingested's growth, within the
    served rows; the last backlog equals capacity_report()'s; the
    scroll's bucket is one of the host's."""
    frames = _frames(kind)
    m, outs, (spans, counters), facts = _run(kind, frames, on=True)
    cnt = collections.defaultdict(dict)
    for name, value, fid, _ in counters:
        assert fid is not None or name.startswith("stream."), name
        cnt[fid].setdefault(name, []).append(value)
    wait = {s[4]: (s[2] - s[1]) / 1e6 for s in spans if s[0] == "merge.gate_wait"}
    ncols = m.cfg.canvas_blocks[0] * m.cfg.canvas_blocks[1]
    for fid, (out, fact) in enumerate(zip(outs, facts), start=1):
        c = cnt[fid]
        assert c["gate.slab_vox"] == [out.gate_slab_vox]
        assert wait[fid] == out.gate_sync_ms
        assert sum(c.get("stream.blocks", [0])) == fact["ingested"]
        if fid > 1:
            assert c["stream.backlog_cols"] == [fact["leftover"]]
            assert c["stream.rows"][0] % m.cfg.canvas_blocks[2] == 0
            assert c["stream.blocks"][0] <= c["stream.rows"][0]
        for v in c.get("scroll.cols", []):
            assert v in (32, 64, 128, ncols)
    assert cnt[None]["stream.backlog_cols"] == [m.capacity_report()["stream_leftover"]]
    assert sum(sum(c.get("stream.blocks", [])) for c in cnt.values()) == m.stream_ingested
    assert any("scroll.cols" in c for c in cnt.values())


def test_tracing_reads_nothing_more_and_changes_nothing(monkeypatch):
    """Tensor.item / tolist / cpu and the synchronisations are called as
    often with tracing on as off, and the map, the outputs and the mirror
    are bitwise the same."""
    calls = collections.Counter()

    def counting(owner, name):
        real = getattr(owner, name)

        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(owner, name, f)

    for name in ("item", "tolist", "cpu"):
        counting(torch.Tensor, name)
    counting(torch.cuda, "synchronize")
    counting(torch.cuda.Event, "synchronize")
    frames = _frames("pointcloud", 4)
    runs = {}
    for on in (False, True):
        calls.clear()
        m, outs, recs, _ = _run("pointcloud", frames, on=on)
        o = outs[-1]
        runs[on] = (dict(calls), state_digest(state_to_numpy(m.state)),
                    output_digest(o.glb_type, o.dist_sq, o.coc),
                    m.mirror.digest())
        assert bool(recs[0]) == on
    assert runs[True] == runs[False]
    assert runs[False][0]["tolist"] > 0


def test_stamps_lie_on_their_profiler_ranges(tmp_path):
    """Under torch_trace every span opens a gie/ range; each span's
    in-memory stamps lie within 200 us of its kineto range (one clock),
    and the Chrome trace shows the spans."""
    frames = _frames("depth", 3)
    m = _mapper("depth")
    with profiler.torch_trace(str(tmp_path / "t"), device="cpu") as prof:
        for proj, data in frames:
            _step(m, "depth", proj, data)
    assert not profiler.enabled()
    spans, _ = profiler.take()
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiler.PREFIX):
            ranges[e.name()[len(profiler.PREFIX):]].append(
                (e.start_ns(), e.end_ns()))
    mine = collections.defaultdict(list)
    for name, t0, t1, _, _ in spans:
        mine[name].append((t0, t1))
    assert set(mine) == set(ranges) and "merge.gate_wait" in mine
    for name, st in mine.items():
        assert len(st) == len(ranges[name]), name
        for (a0, a1), (b0, b1) in zip(sorted(st), sorted(ranges[name])):
            assert abs(a0 - b0) <= 200_000 and abs(a1 - b1) <= 200_000, name
    assert "gie/merge.gate" in (tmp_path / "t" / "trace.json").read_text()


def test_kernel_library_span_and_build_counter(monkeypatch):
    """Loading the kernel library is one span, nested in the caller's,
    whether the build compiled or was found; it counts nothing (build and
    the loader stubbed: no card here)."""
    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    for compile_s in (2.5, 0.0):
        monkeypatch.setattr(_build, "build", lambda: ("lib.so", compile_s))
        profiler.enable()
        with profiler.span("frame", frame=7):
            _build.library.__wrapped__()
        profiler.disable()
        spans, counters = profiler.take()
        assert [(s[0], s[3], s[4]) for s in spans] == [
            ("kernels.library", "frame", 7), ("frame", None, 7)]
        assert counters == []


def test_replay_run_is_one_frame():
    """The replay path records one `frame` span a run; the run's merges and
    scrolls nest in it and share its id, and frames it hands to the
    per-frame path record their own."""
    frames = _frames("depth", 7)
    m = _mapper("depth")
    profiler.enable()
    m.process_depth_batch([p for p, _ in frames], np.stack([d[0] for _, d in frames]),
                          *frames[0][1][1:], chunk=4)
    profiler.disable()
    spans, _ = profiler.take()
    roots = [s for s in spans if s[0] == "frame"]
    merges = [s for s in spans if s[0] == "merge"]
    assert len(merges) == len(frames) and len(roots) < len(frames)
    assert m.replay_scanned_frames > 0
    by = _by_frame(spans)
    for fid, (_, t0, t1, parent, _) in ((r[4], r) for r in roots):
        assert parent is None
        for s in by[fid]:
            assert t0 <= s[1] and s[2] <= t1, s[0]
    assert sorted(r[4] for r in roots) == sorted(set(s[4] for s in merges))
