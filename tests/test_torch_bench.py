"""The port's benchmark harnesses (gie_mapping_tpu_torch/bench/) on the
CPU at reduced sizes, held to the JAX package on the same numpy inputs:
the headline's state after its warm-up against the JAX mapper's after the
same calls, each sensor kind's suite case (its keys, the order of its
tail-latency stage costs, and the state after its scroll chains against
the JAX package's _do_scroll chained over the same state), the scaling
point's 2-shard state against its 1-device one, and bench.py's rule that
the JSON line survives a SIGTERM."""
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gie_mapping_tpu import map_state as jms
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.bench import headline, scaling, suite
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
from gie_mapping_tpu_torch.runtime.datasets import cow_lady_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# reduced windows: 0.2 m voxels where a case allows, short cutoffs
HEADLINE = dict(voxel_width=0.2, local_size_m=(3.2, 3.2, 2.4), cutoff_dist=0.8,
                max_blocks=512)
SMALL = dict(voxel_width=0.2, local_size_m=(3.2, 3.2, 1.6), cutoff_dist=0.8,
             max_blocks=512)
SUITE_CASES = {"cow_lady": dict(SMALL, max_raycast_points=1024),
               "scan2D": SMALL, "depthcam": SMALL, "laser3D": SMALL}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
HEADLINE_EXTRA = {
    "frames": int, "dispatch_mode": str, "mvoxels_per_s": float,
    "relax_iters_last": int, "gate_level_last": int,
    "gate_slab_vox_last": int, "rays_per_frame": int, "passes": int,
    "wall_ms": float, "pass_ms_min": float, "pass_ms_max": float,
    "online_ms": float, "online_p50_ms": float, "online_p95_ms": float,
    "online_max_ms": float, "device": str}
SUITE_EXTRA = {
    "case": str, "frames": int, "dispatch_mode": str, "mvoxels_per_s": float,
    "edt_ms": float, "steady_ms": float, "scroll_ms": float,
    "teleport_ms": float, "scroll_rate": float, "p50_ms": float,
    "p95_ms": float, "worst_ms": float, "tail_order": str, "canvas": list,
    "window": list,
    "sensor": str, "wall_ms": float, "pass_ms_min": float,
    "pass_ms_max": float, "online_ms": float, "online_p50_ms": float,
    "online_p95_ms": float, "online_max_ms": float, "device": str}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_keys(line, extra):
    assert LINE_KEYS <= set(line), line
    json.dumps(line)  # one parsable line
    for k, t in extra.items():
        assert isinstance(line["extra"][k], t), (k, line["extra"][k])
    assert line["value"] > 0 and line["extra"]["device"] == "cpu"


def _jax_state(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _assert_same(got, want, msg):
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg}: {k}")


def test_headline_reduced_matches_jax():
    """2 warm frames + 4 (chunk 4), 4,096 rays, one pass: the JSON line's
    keys and types, and the MapState after the harness's warm-up (the
    online frames and the first batch call) bit for bit against the JAX
    mapper's after the same calls on the same numpy inputs."""
    seen = {}

    def after_warmup(mapper, out):
        # copies: later scrolls update the CPU archive in place
        seen["state"] = {k: v.copy()
                         for k, v in state_to_numpy(mapper.state).items()}
        seen["origin"] = np.asarray(mapper._origin)

    line = headline.run("cpu", frames=4, rays=4096, passes=1,
                        cfg_overrides=HEADLINE, warm=2,
                        after_warmup=after_warmup)
    _assert_keys(line, HEADLINE_EXTRA)
    assert line["metric"] == "cowlady_ogm_edt_ms_per_frame"
    e = line["extra"]
    assert e["dispatch_mode"] == "replay_chunk_4" and e["online_samples"] == 4
    assert e["pass_ms_min"] == e["pass_ms_max"] == line["value"]
    assert 0 < e["online_p50_ms"] <= e["online_p95_ms"] <= e["online_max_ms"]

    overrides, world, poses, n_warm, chunk = cow_lady_bench(
        n_frames=4, n_online=2, rays=4096)
    projs = [jgeo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy())
             for p in poses]
    clouds = [world.pointcloud(p, n_rays=4096, max_range=8.0, seed=i)
              for i, p in enumerate(poses)]
    jm = JaxMapper(jcfg.cow_lady_config(**overrides, **HEADLINE))
    pts, val = jm.stage_pointcloud_batch(clouds)
    for i in range(n_warm):
        jm.process_pointcloud(projs[i], pts[i], val[i])
    jm.process_pointcloud_batch(projs[n_warm:], pts[n_warm:], val[n_warm:],
                                chunk=chunk)
    assert jm.replay_scanned_frames == 4
    _assert_same(seen["state"], _jax_state(jm.state), "headline warm-up")
    np.testing.assert_array_equal(seen["origin"], np.asarray(jm._origin))


_jax_do_scroll = jax.jit(jms._do_scroll, static_argnums=(2,))


@pytest.mark.parametrize("case", sorted(SUITE_CASES))
def test_suite_case_reduced(case, monkeypatch):
    """One reduced case per sensor kind (4 poses, one pass, each stage
    timed once after its untimed call): the keys, the measured stage costs
    in order (0 < p50 <= p95 <= worst, no clamp), and each scroll chain's
    end state against the JAX package's _do_scroll chained over the same
    start state, and unlike that start."""
    monkeypatch.setattr(suite, "STAGE_REPS", 1)
    probe = {}
    line = suite.bench_case(case, "cpu", frames=4, passes=1,
                            cfg_overrides=SUITE_CASES[case], probe=probe)
    _assert_keys(line, SUITE_EXTRA)
    e = line["extra"]
    assert e["case"] == case and e["sensor"] == suite.SENSOR[case]
    assert e["edt_ms"] > 0 and e["scroll_ms"] > 0 and e["teleport_ms"] > 0
    assert 0 < e["p50_ms"] <= e["p95_ms"] <= e["worst_ms"], e
    assert e["tail_order"] == "held"
    jc = jcfg.load_config(case, **suite.case_overrides(case, SUITE_CASES[case]))
    for name in ("scroll", "teleport"):
        p = probe[name]
        js = jms.MapState(**{k: jnp.asarray(v) for k, v in p["start"].items()})
        for j in range(suite.K_EDT):
            new = p["origin"] + (p["delta"] if j % 2 == 0 else 0)
            js = _jax_do_scroll(js, jnp.asarray(new, jnp.int32), jc)
        _assert_same(p["end"], _jax_state(js), f"{case} {name} chain")
        assert any(not np.array_equal(p["end"][k], p["start"][k])
                   for k in FIELDS), f"{case} {name}: the chain changed nothing"


def test_scaling_virtual_two_shards():
    """--virtual 2 --cpu at a reduced window: the line's keys, and the
    2-shard final state equal to the 1-device one on the checkpoint
    fields."""
    line, states = scaling.run("cpu", frames=2, virtual=2,
                               cfg_overrides=dict(local_size_m=(3.2, 3.2, 1.6),
                                                  cutoff_dist=0.8))
    assert line["metric"] == "cowlady_merge_ms_per_frame_by_devices"
    e = line["extra"]
    assert set(e["points_ms"]) == {"1", "2"} and e["devices"] == 2
    assert e["virtual"] is True and e["scaling_efficiency"] > 0
    assert e["device"] == "cpu" and line["value"] == e["points_ms"]["2"]
    one, two = (state_to_numpy(states[k]) for k in ("1", "2"))
    for k in VolumetricMapper.CHECKPOINT_FIELDS:
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)


@pytest.mark.parametrize("mod", [headline, suite, scaling])
def test_harness_raises_without_a_card(mod, monkeypatch):
    """Without --cpu a harness runs on the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run("cuda")


def test_headline_line_survives_sigterm():
    """A SIGTERM after the first pass still leaves a parsable JSON line
    last on stdout (bench.py's rule), and the process exits 128 + 15."""
    code = ("from gie_mapping_tpu_torch.bench import headline; "
            "headline.main(['--cpu', '--frames', '2', '--rays', '1024', "
            f"'--passes', '100000'], cfg_overrides={SMALL!r})")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        first = p.stdout.readline()
        assert json.loads(first)["extra"]["passes"] == 1, first
        p.send_signal(signal.SIGTERM)
        rest, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 128 + signal.SIGTERM, err
    last = json.loads(rest.strip().splitlines()[-1])
    assert last["metric"] == "cowlady_ogm_edt_ms_per_frame"
    assert last["extra"]["passes"] >= 1


@pytest.mark.parametrize("p50, p95, worst, reps, want", [
    (5.0, 8.0, 9.0, {"scroll": [3.0, 3.5], "teleport": [4.0, 4.2]}, "held"),
    (5.0, 5.0, 5.0, {"scroll": [0.1], "teleport": [0.1]}, "held"),
    (5.0, 8.2, 8.0, {"scroll": [3.2, 4.0], "teleport": [3.0, 3.9]},
     "unresolved"),
    (5.0, 9.0, 8.0, {"scroll": [4.0, 4.5], "teleport": [3.0, 3.5]},
     "inverted"),
    (0.0, 3.0, 4.0, {"scroll": [3.0], "teleport": [4.0]}, "inverted"),
    (5.0, 9.0, 4.0, {"scroll": [4.0], "teleport": [4.5]}, "inverted"),
])
def test_tail_order(p50, p95, worst, reps, want):
    """The suite's tail order: held, p95 above worst only within the scroll
    chains' spread, or inverted."""
    assert suite.tail_order(p50, p95, worst, reps) == want
