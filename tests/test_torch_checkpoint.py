"""Checkpoints of the port (VolumetricMapper.save / load) against the JAX
package's: the same file format both ways, the reset on load, the older
[B, 512, 3] archive shape, and the refusal of other versions."""
import warnings

import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.map_state import FIELDS, state_to_numpy
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld, scroll_trajectory
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo
from gie_mapping_tpu_torch.utils.constants import EMPTY_VALUE

# cow-lady at a small window, streaming on; the path scrolls in x and z and
# teleports 12 m out (the whole canvas goes to the archive) and back
KW = dict(local_size_m=(4.0, 4.0, 1.6), max_raycast_points=4096,
          edt_gate_min_vox=0, stream_k_cols=16)
WORLD = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
POSES = scroll_trajectory(n_yaw=2, step_x=0.5, n_out=3, dz=1.0, n_back=2,
                          teleport_x=12.0, n_after=0)
SAVE_AFTER = 9  # frames 0-8: the last one is the teleport out
OUTPUTS = ("edt", "glb_type", "dist_sq", "coc", "gate_level", "fnt_count",
           "arch_dropped")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(i):
    return WORLD.pointcloud(tgeo.Projection.from_pose(*POSES[i]), n_rays=4096,
                            max_range=8.0, seed=i)


def _frame(m, i):
    pose = POSES[i]
    if isinstance(m, JaxMapper):
        return m.process_pointcloud(jgeo.Projection.from_pose(*pose), _cloud(i)).fetch()
    return m.process_pointcloud(tgeo.Projection.from_pose(*pose), _cloud(i)).fetch()


def _jax_state(m):
    return {name: np.asarray(getattr(m.state, name)) for name in FIELDS}


def _assert_states(a, b, msg):
    for name in FIELDS:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype, (msg, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{msg}: {name}")


def _assert_outputs(a, b, msg):
    for k in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)),
                                      err_msg=f"{msg}: {k}")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both mappers over frames 0-8, each saved: (jax file, port file,
    port state as numpy, map_ct)."""
    d = tmp_path_factory.mktemp("ckpt")
    jm = JaxMapper(jcfg.cow_lady_config(**KW))
    tm = TorchMapper(tcfg.cow_lady_config(**KW), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(SAVE_AFTER):
            _frame(jm, i)
            _frame(tm, i)
    jf, tf = str(d / "jax.npz"), str(d / "port.npz")
    jm.save(jf)
    tm.save(tf)
    return jf, tf, state_to_numpy(tm.state), tm.map_ct


def test_round_trip_across_a_scroll_with_archive_rows(saved):
    _, tf, st, map_ct = saved
    assert int(st["n_arch"]) > 0  # the teleport archived the canvas
    m = TorchMapper(tcfg.cow_lady_config(**KW), device="cpu")
    fresh_p1c = m.state.p1c
    m._origin = np.zeros(3, np.int32)
    assert m.load(tf) is m
    got = state_to_numpy(m.state)
    for name in TorchMapper.CHECKPOINT_FIELDS:
        assert got[name].dtype == st[name].dtype
        np.testing.assert_array_equal(got[name], st[name], err_msg=name)
    assert (got["dmax_cell"] == EMPTY_VALUE).all()
    assert got["dmax_cell"].shape == st["dmax_cell"].shape
    assert not got["p1c_ok"]
    assert m.state.p1c is fresh_p1c  # kept, marked stale
    assert m.map_ct == map_ct == SAVE_AFTER and m._origin is None
    assert m.state.a_packed.dtype == torch.int32
    assert all(t.device.type == "cpu" for t in vars(m.state).values())


def test_file_format_equals_jax(saved):
    jf, tf, _, _ = saved
    with np.load(jf) as j, np.load(tf) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["state/a_packed"].dtype == np.uint32
        assert t["state/coc"].dtype == np.int16
        assert t["state/present"].dtype == np.bool_
        assert int(t["meta/version"]) == 3


def test_checkpoints_load_across_packages(saved):
    """Each package loads each package's file; the next frame (the teleport
    back, which fetches archived rows) is equal in all four."""
    jf, tf, _, _ = saved
    runs = {}
    for name, cls, path in (("jax<-jax", JaxMapper, jf), ("jax<-port", JaxMapper, tf),
                            ("port<-jax", TorchMapper, jf),
                            ("port<-port", TorchMapper, tf)):
        if cls is JaxMapper:
            m = cls(jcfg.cow_lady_config(**KW)).load(path)
            assert m.state.a_packed.dtype == np.uint32
        else:
            m = cls(tcfg.cow_lady_config(**KW), device="cpu").load(path)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = _frame(m, SAVE_AFTER)
        st = _jax_state(m) if cls is JaxMapper else state_to_numpy(m.state)
        runs[name] = (out, st, m.map_ct)
    ref_out, ref_st, ref_ct = runs["jax<-jax"]
    assert ref_ct == SAVE_AFTER + 1
    for name, (out, st, ct) in runs.items():
        _assert_outputs(out, ref_out, name)
        _assert_states(st, ref_st, name)
        assert ct == ref_ct


def test_old_archive_shape_is_read(saved, tmp_path):
    _, tf, st, _ = saved
    with np.load(tf) as raw:
        arrays = {k: raw[k] for k in raw.files}
    B = arrays["state/a_packed"].shape[0]
    arrays["state/a_packed"] = arrays["state/a_packed"].reshape(B, 512, 3)
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **arrays)
    m = TorchMapper(tcfg.cow_lady_config(**KW), device="cpu").load(old)
    got = state_to_numpy(m.state)
    np.testing.assert_array_equal(got["a_packed"], st["a_packed"])
    j = JaxMapper(jcfg.cow_lady_config(**KW)).load(old)
    np.testing.assert_array_equal(np.asarray(j.state.a_packed), got["a_packed"])


@pytest.mark.parametrize("version", [None, 1, 2, 4])
def test_other_versions_are_refused(saved, tmp_path, version):
    _, tf, _, _ = saved
    with np.load(tf) as raw:
        arrays = {k: raw[k] for k in raw.files if k != "meta/version"}
    if version is not None:
        arrays["meta/version"] = np.asarray(version)
    p = str(tmp_path / "v.npz")
    np.savez_compressed(p, **arrays)
    with pytest.raises(ValueError) as jerr:
        JaxMapper(jcfg.cow_lady_config(**KW)).load(p)
    with pytest.raises(ValueError) as terr:
        TorchMapper(tcfg.cow_lady_config(**KW), device="cpu").load(p)
    assert str(terr.value) == str(jerr.value)
    assert f"v{version or 1} not supported" in str(terr.value)
