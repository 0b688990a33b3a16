"""The port's CLI (gie_mapping_tpu_torch/cli.py) against the JAX package's:
the synthetic frames of every case, main() end to end on the CPU at
reduced windows (summary, checkpoint, CSV), the refused options, and the
two point-cloud presets no other test drives (ugv_corridor,
uav_raycast_fine) through both mappers."""
import json

import jax
import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch import cli as tcli
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.utils import config as tcfg

CASES = ("scan2D", "cow_lady", "ugv_corridor", "depthcam", "laser3D",
         "uav_raycast_fine")
# windows small enough for the CPU, each case's own sensor and engine
REDUCED = {
    "scan2D": dict(local_size_m=(4.0, 4.0, 1.2), voxel_width=0.2,
                   max_blocks=2048),
    "cow_lady": dict(local_size_m=(4.0, 4.0, 1.6), voxel_width=0.2,
                     cutoff_dist=1.0, max_blocks=2048),
    "ugv_corridor": dict(local_size_m=(2.0, 2.0, 0.8), max_blocks=4096),
    "uav_raycast_fine": dict(local_size_m=(4.0, 4.0, 1.6), max_blocks=2048),
    "laser3D": dict(local_size_m=(6.0, 6.0, 1.6), max_blocks=2048),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcli():
    """The JAX package's CLI module, with the persistent compilation cache
    it turns on at import turned off again, so this process writes no
    cache."""
    import gie_mapping_tpu.cli as mod

    jax.config.update("jax_compilation_cache_dir", None)
    return mod


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _payload_same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_payload_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return _same(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", CASES)
def test_synthetic_frames_match_jax(jcli, case):
    cfg_t, cfg_j = tcfg.load_config(case), jcfg.load_config(case)
    tf = list(tcli.synthetic_frames(cfg_t, 2))
    jf = list(jcli.synthetic_frames(cfg_j, 2))
    assert len(tf) == len(jf) == 2
    for (tp, (tk, tpl)), (jp, (jk, jpl)) in zip(tf, jf):
        assert tk == jk
        assert _same(tp.rot.numpy(), jp.rot) and _same(tp.trans.numpy(), jp.trans)
        assert _payload_same(tpl, jpl), case


def _reduce(monkeypatch, module, pkg):
    real = pkg.load_config
    monkeypatch.setattr(module, "load_config",
                        lambda case: real(case, **REDUCED[case]))


def _summary_without_times(s):
    return {k: v for k, v in s.items() if k not in ("wall_s", "ms_per_frame")}


@pytest.mark.parametrize("case,extra", [
    ("scan2D", ["--profile"]),
    ("cow_lady", ["--batch", "3"]),
    ("laser3D", ["--gate", "off", "--p1-cache", "off"]),
    ("uav_raycast_fine", ["--staged", "--frames", "6"]),
])
def test_main_end_to_end_matches_jax(jcli, monkeypatch, capsys, tmp_path,
                                     case, extra):
    _reduce(monkeypatch, tcli, tcfg)
    _reduce(monkeypatch, jcli, jcfg)
    runs = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        argv = [case, "--frames", "3", "--save", str(d / "map.npz"),
                "--log", str(d / "log.csv"), "--cpu", *extra]
        if name == "port":
            got = tcli.main(argv)
            line = capsys.readouterr().out.strip().splitlines()[-1]
            assert json.loads(line) == got
        else:
            monkeypatch.setattr("sys.argv", ["gie-tpu-run", *argv])
            jcli.main()
            got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[name] = (got, d)
    (ts, td), (js, jd) = runs["port"], runs["jax"]
    assert list(ts) == list(js)
    assert _summary_without_times(ts) == _summary_without_times(js)
    with np.load(td / "map.npz") as a, np.load(jd / "map.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert _same(a[k], b[k]), k
    rows = lambda d: [ln.split(",")[2:] for ln in
                      (d / "log.csv").read_text().strip().splitlines()[1:]]
    assert rows(td) == rows(jd)
    # staged: 4 warm frames, then three timed passes over the rest
    n = 4 + 3 * ts["frames"] if "--staged" in extra else ts["frames"]
    assert len(rows(td)) == n
    if "--profile" in extra:
        assert all(float(r[0]) >= 0 for r in rows(td))


def test_refused_options(monkeypatch):
    _reduce(monkeypatch, tcli, tcfg)
    for flag, value in (("--phase1", "xla"), ("--mid", "off"),
                        ("--gate-pmode", "voxel"), ("--env-variant", "mono")):
        with pytest.raises(NotImplementedError, match="not ported"):
            tcli.main(["scan2D", "--cpu", "--frames", "1", flag, value])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["scan2D", "--frames", "1"])  # the card is the default
    # --mesh N on the card takes the first N cards: none here
    with pytest.raises(RuntimeError, match="2 CUDA devices"):
        tcli.main(["scan2D", "--frames", "1", "--mesh", "2"])


@pytest.mark.parametrize("case", ["ugv_corridor", "uav_raycast_fine"])
def test_point_cloud_presets_match_jax(jcli, case):
    """Two frames of each preset's synthetic run at a reduced window, every
    window output and the whole state after each frame."""
    cfg_t = tcfg.load_config(case, **REDUCED[case])
    cfg_j = jcfg.load_config(case, **REDUCED[case])
    assert cfg_t.fast_mode and cfg_t.raycast_mode == "projective"
    tm = TorchMapper(cfg_t, device="cpu")
    jm = JaxMapper(cfg_j)
    for i, (p, (kind, pts)) in enumerate(tcli.synthetic_frames(cfg_t, 2)):
        to = tm.process_pointcloud(p, pts)
        jo = jm.process_pointcloud(
            jgeo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy()), pts)
        for k in ("edt", "glb_type", "dist_sq", "coc", "fnt_count",
                  "gate_level"):
            np.testing.assert_array_equal(np.asarray(getattr(to, k)),
                                          np.asarray(getattr(jo, k)),
                                          err_msg=f"{case} frame {i}: {k}")
        st = state_to_numpy(tm.state)
        for name in FIELDS:
            np.testing.assert_array_equal(
                st[name], np.asarray(getattr(jm.state, name)),
                err_msg=f"{case} frame {i}: state.{name}")
    assert (to.glb_type == 2).sum() > 0


# sensor heights on voxel centres whose products c_z * w are inexact: the
# two rules of scan_sensors._sensor_offsets give other inst_types there
HEIGHT_CASES = {
    "scan2D": dict(local_size_m=(4.0, 4.0, 3.0), max_blocks=2048),
    "depthcam": dict(local_size_m=(4.0, 4.0, 3.0), cutoff_dist=1.0,
                     max_blocks=2048),
    "laser3D": dict(local_size_m=(6.0, 6.0, 1.5), max_blocks=2048),
}


@pytest.mark.parametrize("case", list(HEIGHT_CASES))
def test_sensor_height_rounding_matches_jax_online(jcli, case):
    """The CLI's synthetic frames put the sensor at 0.4 of the window's
    height, on a voxel centre.  The JAX per-frame program subtracts the
    sensor's z from the rounded voxel height (scan_sensors._sensor_offsets);
    the port's online frames equal JAX's there, every voxel of every frame
    and the state."""
    from gie_mapping_tpu_torch.models.pipeline import SENSORS

    kw = dict(HEIGHT_CASES[case], display_glb_edt=False, display_glb_ogm=False)
    cfg_t, cfg_j = tcfg.load_config(case, **kw), jcfg.load_config(case, **kw)
    frames = list(tcli.synthetic_frames(cfg_t, 5))
    kind = frames[0][1][0]
    tm, jm = TorchMapper(cfg_t, device="cpu"), JaxMapper(cfg_j)
    exposed = 0
    for i, (p, (_, pl)) in enumerate(frames):
        to = tcli.dispatch(tm, p, kind, pl)
        jo = {"scan": jm.process_scan2d, "depth": jm.process_depth,
              "multiscan": jm.process_multiscan}[kind](
            jgeo.Projection(rot=p.rot.numpy(), trans=p.trans.numpy()), *pl)
        for k in ("glb_type", "dist_sq", "coc"):
            np.testing.assert_array_equal(getattr(to, k), np.asarray(getattr(jo, k)),
                                          err_msg=f"{case} frame {i}: {k}")
        # the pose tells the per-frame rule from the replay's
        sc = np.zeros((2, 3), np.float32)
        for j, v in enumerate(pl[1:]):
            sc[j // 3, j % 3] = v
        insts = [SENSORS[kind](torch.as_tensor(pl[0], dtype=torch.float32),
                               p.rot.numpy(), p.trans.numpy(), sc[0], sc[1],
                               to.pvt, cfg=cfg_t, replay=r)[0]
                 for r in (False, True)]
        exposed += int((insts[0] != insts[1]).sum())
    st = state_to_numpy(tm.state)
    for name in FIELDS:
        np.testing.assert_array_equal(st[name], np.asarray(getattr(jm.state, name)),
                                      err_msg=f"{case}: state.{name}")
    # the 2-D LiDAR's planar test flips on the rule at these heights; the
    # depth and ring models only where a pixel or bin border falls (the
    # voxel-face poses of test_torch_depth's model tests)
    assert exposed > 0 or kind != "scan"
