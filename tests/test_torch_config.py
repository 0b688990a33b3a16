"""The PyTorch port's configuration and package boundary.

The port copies the JAX package's MapConfig, presets and constants (the JAX
copies import JAX); these tests hold the copies equal field by field, and
check that importing any module of the port leaves JAX unloaded.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import gie_mapping_tpu.utils.config as jcfg
import gie_mapping_tpu.utils.constants as jconst
import gie_mapping_tpu_torch.utils.config as tcfg
import gie_mapping_tpu_torch.utils.constants as tconst

DERIVED = ("local_size", "map_volume", "max_width", "max_loc_dist_sq",
           "cutoff_grids_sq", "robot_r2_grids", "is_2d", "halo_grids",
           "canvas_blocks", "canvas_size", "relax_iters", "stream_capacity")


@pytest.mark.parametrize("case", sorted(jcfg.PRESETS))
def test_presets_match_field_by_field(case):
    j = jcfg.load_config(case)
    t = tcfg.load_config(case)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for name in DERIVED:
        assert getattr(j, name) == getattr(t, name), name


def test_defaults_fields_and_constants_match():
    assert [f.name for f in dataclasses.fields(jcfg.MapConfig)] == \
        [f.name for f in dataclasses.fields(tcfg.MapConfig)]
    assert dataclasses.asdict(jcfg.MapConfig()) == dataclasses.asdict(tcfg.MapConfig())
    for name in dir(jconst):
        if name.isupper():
            assert getattr(jconst, name) == getattr(tconst, name), name
    np.testing.assert_array_equal(jcfg.T_V_C, tcfg.T_V_C)
    np.testing.assert_array_equal(jcfg.DEFAULT_FENCE_LL, tcfg.DEFAULT_FENCE_LL)
    np.testing.assert_array_equal(jcfg.DEFAULT_FENCE_UR, tcfg.DEFAULT_FENCE_UR)
    from gie_mapping_tpu.ops.edt_batch import _ENV_VARIANTS

    assert sorted(_ENV_VARIANTS) == sorted(tcfg._ENV_VARIANTS)


def test_validation_matches():
    for bad in (dict(merge_mode="x"), dict(edt_env_variant="x"),
                dict(edt_phase1="x"), dict(edt_gate_pmode="x")):
        with pytest.raises(ValueError):
            jcfg.MapConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.MapConfig(**bad)


@pytest.mark.parametrize("override", [
    dict(edt_env_variant="mono"), dict(edt_env_variant="cf"), dict(edt_mid=False),
    dict(edt_phase1="xla"), dict(edt_env_variant="base"),
    dict(edt_gate_pmode="voxel"), dict(edt_env_variant="mono+fusepay"),
    dict(edt_env_variant="cf_base"),
])
def test_unported_options_are_refused(override):
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    kw = dict(display_glb_edt=False, display_glb_ogm=False)
    kw.update(override)
    cfg = tcfg.cow_lady_config(**kw)
    assert tcfg.unported_options(cfg)
    with pytest.raises(NotImplementedError):
        VolumetricMapper(cfg)


@pytest.mark.parametrize("flag", ["profile_loc_rms", "profile_glb_rms"])
def test_profile_flags_are_ported(flag):
    """The ground-truth RMSE checks run in the port: either flag builds a
    mapper with a checker and a CSV log."""
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    cfg = tcfg.scan2d_config(**{flag: True})
    assert not tcfg.unported_options(cfg)
    m = VolumetricMapper(cfg, device="cpu")
    assert m.gt_checker is not None and m.logger is not None


def test_cow_lady_defaults_construct():
    """The cow-lady preset at its own defaults (streaming on) is on the
    ported path."""
    from gie_mapping_tpu_torch import create_mapper

    m = create_mapper("cow_lady", device="cpu")
    assert m.cfg.display_glb_edt and m.cfg.display_glb_ogm
    assert not tcfg.unported_options(m.cfg)


def test_scan2d_defaults_construct():
    """The scan2D preset at its own defaults (the canvas engine, fast_mode
    and for_motion_planner on), and its true 2-D map on the relax engine,
    are on the ported path."""
    from gie_mapping_tpu_torch import create_mapper

    m = create_mapper("scan2D", device="cpu")
    assert m.cfg == tcfg.scan2d_config()
    assert m.cfg.fast_mode and m.cfg.for_motion_planner
    assert m.device.type == "cpu" and m.state.vox_type.device.type == "cpu"
    flat = tcfg.scan2d_config(local_size_m=(10.0, 10.0, 0.1), merge_mode="relax")
    assert flat.is_2d and not tcfg.unported_options(flat)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """Without device=..., the mapper runs on the card; with no card it
    raises instead of carrying on on the CPU."""
    import torch

    from gie_mapping_tpu_torch import create_mapper
    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_mapper("scan2D")
    with pytest.raises(RuntimeError, match="CUDA"):
        VolumetricMapper(tcfg.cow_lady_config(), device="cuda")


def test_state_constructors_default_to_the_card(monkeypatch):
    """MapState.create and state_from_numpy run on the card unless told
    otherwise, and raise without one, as the mapper does."""
    import torch

    from gie_mapping_tpu_torch import map_state as ms

    cfg = tcfg.cow_lady_config(local_size_m=(4.0, 4.0, 1.6), max_blocks=64)
    st = ms.state_to_numpy(ms.MapState.create(cfg, device="cpu"))
    assert ms.state_from_numpy(st, device="cpu").vox_type.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ms.MapState.create(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ms.state_from_numpy(st)


def _around_limit(axis, limit, merge_mode, flat=False):
    """scan2D configs whose EDT grid (the canvas, or the relax engine's
    window) along `axis` is the largest within `limit` and the smallest
    above it, the window grown one voxel at a time; `flat`: a one-voxel-deep
    window (Z == 1)."""
    size = [10.0, 10.0, 0.1 if flat else 3.0]
    under = None
    for n in range(1, 2 * limit):
        size[axis] = round(n * 0.1, 6)
        cfg = tcfg.scan2d_config(local_size_m=tuple(size), merge_mode=merge_mode)
        grid = cfg.canvas_size if merge_mode == "canvas_edt" else cfg.local_size
        if grid[axis] > limit:
            return under, cfg
        under = cfg
    raise AssertionError("limit not reached")


@pytest.mark.parametrize("axis,limit,merge_mode", [
    (0, "packed", "canvas_edt"), (1, "phase1", "canvas_edt"),
    (2, "mid", "canvas_edt"), (0, "packed", "relax"), (2, "mid", "relax"),
    (0, "flat", "relax")])
def test_configs_beyond_the_kernels_limits_are_refused(monkeypatch, axis, limit,
                                                       merge_mode):
    """On a CUDA device the mapper refuses, when it is built, a config whose
    EDT grid is beyond a kernel's limit (phase 1: Y <= 1024; the phase-2
    envelope: X sites; the phase-3 one: Z sites; on a Z == 1 window the
    generic envelope: X sites), instead of raising inside the first EDT; a
    config just within the limits passes that check."""
    import torch

    from gie_mapping_tpu_torch.models.mapper import VolumetricMapper
    from gie_mapping_tpu_torch.models.pipeline import kernel_limits
    from gie_mapping_tpu_torch.ops.kernels import envelope as tenv

    n = {"packed": tenv.ENVELOPE_PACKED_MAX_N, "phase1": 1024,
         "mid": tenv.ENVELOPE_MID_MAX_N, "flat": tenv.ENVELOPE_MID_MAX_N}[limit]
    under, over = _around_limit(axis, n, merge_mode, flat=limit == "flat")
    if limit == "flat":
        assert under.local_size[2] == over.local_size[2] == 1
        assert (under.local_size[0], over.local_size[0]) == (n, n + 1)
    assert kernel_limits(under) == [] and len(kernel_limits(over)) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NotImplementedError, match="limits"):
        VolumetricMapper(over, device="cuda")
    with pytest.raises(NotImplementedError, match="limits"):
        VolumetricMapper(over)
    with pytest.raises(RuntimeError, match="CUDA"):  # past the check: no card
        VolumetricMapper(under, device="cuda")


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import gie_mapping_tpu_torch as pkg
        names = [m.name for m in
                 pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        rt = pkg.__name__ + ".runtime."
        want = [pkg.__name__ + ".cli", pkg.__name__ + ".graft_entry",
                pkg.__name__ + ".parallel.mesh",
                pkg.__name__ + ".parallel.multihost_demo"] + [
            pkg.__name__ + ".bench." + m
            for m in ("common", "headline", "suite", "scaling", "parts",
                      "teleport", "ab")] + [
            rt + m for m in (
            "native", "rings", "clustering", "gt_checker", "logger",
            "profiler", "lz4f", "rosbag", "rosbag_writer", "sync", "viz",
            "datasets", "host_mirror", "synthetic_bag")]
        missing = sorted(set(want) - set(names))
        assert not missing, missing
        # neither JAX, nor the JAX package, nor its scripts (examples/, the
        # root harnesses and the root entry points)
        bad = sorted(k for k in sys.modules
                     if k in ("jax", "gie_mapping_tpu", "bench", "bench_suite",
                              "bench_scaling", "run_case",
                              "make_synthetic_bag", "__graft_entry__")
                     or k.startswith(("jax.", "jaxlib", "gie_mapping_tpu.",
                                      "examples")))
        print(bad)
        assert not bad, bad
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_modules_never_import_jax():
    """chip_smoke.py and the test modules it imports on the card (the
    numpy-only case modules) import nothing of JAX."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, "tests")
        import chip_smoke
        import test_torch_carve_cases, test_torch_envelope_cases
        import test_torch_phase1_cases, test_torch_scenario_cases
        bad = sorted(k for k in sys.modules
                     if k in ("jax", "gie_mapping_tpu")
                     or k.startswith(("jax.", "jaxlib", "gie_mapping_tpu.")))
        assert not bad, bad
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stdout + r.stderr
