"""The PyTorch port's multi-process mesh
(gie_mapping_tpu_torch/parallel/multihost_demo.py over torch.distributed
with gloo): the sharded frame update over a mesh spanning two or four
processes must match a single process bitwise, as tests/test_multihost.py
holds the JAX package; the single process is itself held against the JAX
package's merge_frame on the same frames."""
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from gie_mapping_tpu.map_state import MapState as JaxState
from gie_mapping_tpu.map_state import canvas_geometry as jax_canvas_geometry
from gie_mapping_tpu.models import pipeline as jpipe
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu_torch.map_state import FIELDS
from gie_mapping_tpu_torch.parallel import multihost_demo as demo

ROOT = os.path.join(os.path.dirname(__file__), "..")
FRAMES = 6  # the pivot crosses two canvas blocks: two scrolls
CASES = "canvas,gated,relax"
# what follows the gate's slabs, which span x on a mesh and not on one
# device (their EDT values agree)
GATE_BOOKKEEPING = ("gate_level", "dmax_cell", "p1c", "p1c_ok")


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(n_procs, per_proc, out):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_port()}"
    return [subprocess.Popen(
        [sys.executable, "-u", "-m", "gie_mapping_tpu_torch.parallel.multihost_demo",
         str(i), str(n_procs), "--devices-per-proc", str(per_proc), "--cpu",
         "--frames", str(FRAMES), "--cases", CASES, "--coordinator", coord,
         "--out", out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n_procs)]


def _wait(procs):
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    assert "multihost demo ok" in outs[0]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """Single-process baselines: one device, and one controller over four
    CPU devices (the same shards as the multi-process runs)."""
    d = tmp_path_factory.mktemp("torch_multihost")
    one, four = str(d / "one.npz"), str(d / "four.npz")
    procs = _launch(1, 1, one) + _launch(1, 4, four)
    _wait(procs)
    return np.load(one), np.load(four)


def _assert_equal(want, got, skip=()):
    assert set(want.files) == set(got.files)
    for k in want.files:
        if k.split("/")[0] == "gated" and k.split("/")[-1] in skip:
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n_procs,per_proc", [(2, 2), (4, 1)])
def test_processes_match_single(single, tmp_path, n_procs, per_proc):
    """2 processes x 2 devices and 4 x 1 (every collective crosses the
    process boundary) equal the single controller over 4 devices on every
    output and state field of every frame, and one device everywhere but
    the gate's own bookkeeping."""
    one, four = single
    out = str(tmp_path / "multi.npz")
    _wait(_launch(n_procs, per_proc, out))
    multi = np.load(out)
    _assert_equal(four, multi)
    _assert_equal(one, multi, skip=GATE_BOOKKEEPING)
    assert int(multi["canvas/state/n_arch"]) > 0  # frames scrolled


def test_single_process_matches_jax(single):
    """The single-device demo against the JAX package's merge_frame (its
    in-program scroll) on the same frames, every output and field."""
    one, _ = single
    for case in CASES.split(","):
        cfg = jcfg.scan2d_config(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2,
                                 fast_mode=False, cutoff_dist=2.0,
                                 max_blocks=1024, for_motion_planner=False,
                                 **demo.DEMO_CASES[case])
        st = JaxState.create(cfg)
        M = cfg.max_ext_obs
        fence = (jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
                 jnp.zeros((M,), jnp.bool_), jnp.int32(0))
        for i in range(FRAMES):
            inst, pvt = demo.demo_frame(demo.demo_config(case), i)
            origin_blk, _, off = jax_canvas_geometry(cfg, pvt)
            st, out = jpipe.merge_frame(
                st, jnp.asarray(inst), jnp.zeros(cfg.local_size, jnp.int32),
                jnp.asarray(pvt), jnp.asarray(origin_blk), jnp.asarray(off),
                *fence, cfg=cfg, input_pointcloud=False)
            for k in demo.OUTPUTS:
                np.testing.assert_array_equal(one[f"{case}/{i}/{k}"],
                                              np.asarray(out[k]),
                                              err_msg=f"{case} frame {i} {k}")
        for k in FIELDS:
            np.testing.assert_array_equal(one[f"{case}/state/{k}"],
                                          np.asarray(getattr(st, k)),
                                          err_msg=f"{case} state {k}")


def test_cli_from_torchrun_environment(monkeypatch, capsys):
    """cli.main under torchrun's environment (here a world of one gloo
    process driving --mesh 2 CPU devices) makes the process group and the
    mesh over it, prints the same counts as --cpu alone, and leaves no
    group behind."""
    import json

    import torch
    import torch.distributed as dist

    from gie_mapping_tpu_torch import cli as tcli
    from gie_mapping_tpu_torch.utils import config as tcfg

    real = tcfg.load_config
    monkeypatch.setattr(tcli, "load_config", lambda case: real(
        case, local_size_m=(4.0, 4.0, 1.6), voxel_width=0.2, cutoff_dist=1.0,
        max_blocks=2048))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = tcli.main(["cow_lady", "--frames", "3", "--cpu"])
        capsys.readouterr()
        for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_port())).items():
            monkeypatch.setenv(k, v)
        made = []
        real_make = tcli.make_mesh
        monkeypatch.setattr(tcli, "make_mesh",
                            lambda *a, **kw: made.append(real_make(*a, **kw))
                            or made[-1])
        got = tcli.main(["cow_lady", "--frames", "3", "--cpu", "--mesh", "2"])
    finally:
        torch.set_num_threads(n)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert made and made[0].group is not None and made[0].size == 2
    assert not dist.is_initialized()
    keys = ("frames", "occupied_voxels", "frontier_voxels", "mirror_blocks",
            "arch_dropped")
    assert {k: got[k] for k in keys} == {k: one[k] for k in keys}
    assert one["occupied_voxels"] > 0
