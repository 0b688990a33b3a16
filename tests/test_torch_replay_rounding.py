"""The replay's rounding of the sensor's height offset against the JAX
package's replay program, voxel for voxel.

JAX's replay_frames scans frames 0..n-2 of a run with lax.scan and runs
the last frame unrolled after it.  XLA:CPU emits the scan body's offset
c * w - t as a scalar loop (every component one FMA) and the unrolled
frames as the per-frame program's vector loop (z's multiply and subtract
apart); a scan of one frame loses its while loop.  The CLI's scan2D frames
put the sensor on a voxel centre, where the two rules give other
inst_types (pipeline._in_scan_loop, scan_sensors._sensor_offsets)."""
import jax
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch import cli as tcli
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models import mapper as tmapper
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.models.pipeline import SENSORS, _in_scan_loop
from gie_mapping_tpu_torch.utils import config as tcfg

SMALL = dict(local_size_m=(4.0, 4.0, 3.0), max_blocks=2048)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcli():
    """The JAX CLI module imported with its persistent compilation cache
    turned off again (as tests/test_torch_cli.py does)."""
    import gie_mapping_tpu.cli  # noqa: F401

    jax.config.update("jax_compilation_cache_dir", None)


def test_in_scan_loop():
    assert [_in_scan_loop(k, 5) for k in range(5)] == [True] * 4 + [False]
    assert not _in_scan_loop(0, 2) and not _in_scan_loop(1, 2)


@pytest.mark.parametrize("overrides, n_frames, chunk, runs", [
    ({}, 6, 6, [5]),              # the scan2D preset's CLI replay
    (SMALL, 10, 10, [5, 2, 2]),   # runs of two (no scan loop) after a scan
], ids=["cli_preset", "mixed_runs"])
def test_scan2d_replay_equals_jax_replay(jcli, monkeypatch, overrides,
                                         n_frames, chunk, runs):
    """process_scan2d_batch on the CLI's synthetic scan2D frames: the port's
    replay ends at 0 voxels from JAX's replay in every MapState field and
    every window output, and the runs are those named."""
    kw = dict(overrides, display_glb_edt=False, display_glb_ogm=False)
    cfg_t, cfg_j = tcfg.load_config("scan2D", **kw), jcfg.load_config("scan2D", **kw)
    frames = list(tcli.synthetic_frames(cfg_t, n_frames))
    projs = [p for p, _ in frames]
    ranges = np.stack([pl[0] for _, (_, pl) in frames])
    tmin, tinc = frames[0][1][1][1:]

    jm = JaxMapper(cfg_j)
    jo = jm.process_scan2d_batch(
        [jgeo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy()) for p in projs],
        ranges, tmin, tinc, chunk=chunk)
    got_runs = []
    orig = tmapper.replay_frames

    def recording(state, poses, *a, **k):
        got_runs.append(len(poses))
        return orig(state, poses, *a, **k)

    monkeypatch.setattr(tmapper, "replay_frames", recording)
    tm = TorchMapper(cfg_t, device="cpu")
    to = tm.process_scan2d_batch(projs, ranges, tmin, tinc, chunk=chunk)
    assert got_runs == runs

    st = state_to_numpy(tm.state)
    diff = {k: int((st[k] != np.asarray(getattr(jm.state, k))).sum())
            for k in FIELDS}
    assert sum(diff.values()) == 0, diff
    for k in ("glb_type", "dist_sq", "coc", "edt"):
        np.testing.assert_array_equal(getattr(to, k), np.asarray(getattr(jo, k)),
                                      err_msg=k)

    # the case exposes the rule: the two roundings give other inst_types
    # on a frame of the run
    p, (kind, pl) = frames[1]
    sc = np.zeros((2, 3), np.float32)
    sc[0, :2] = pl[1:]
    insts = [SENSORS[kind](torch.as_tensor(pl[0], dtype=torch.float32),
                           p.rot.numpy(), p.trans.numpy(), sc[0], sc[1],
                           to.pvt, cfg=cfg_t, replay=r)[0]
             for r in (False, True)]
    assert int((insts[0] != insts[1]).sum()) > 0
