"""The PyTorch port's FrameOutput against the JAX package's on the same
frame: the CostMap message (payload8 byte for byte), the planner queries
(query_distance, debug_voxel) and both clouds; and `fetch`, which brings
every field to the host at once."""
import hashlib

import numpy as np
import pytest
import torch

from gie_mapping_tpu.models.mapper import FrameOutput as JaxFrameOutput
from gie_mapping_tpu.models.mapper import VolumetricMapper as JaxMapper
from gie_mapping_tpu.utils import config as jcfg
from gie_mapping_tpu.utils import geometry as jgeo
from gie_mapping_tpu_torch.models.mapper import FrameOutput
from gie_mapping_tpu_torch.models.mapper import VolumetricMapper as TorchMapper
from gie_mapping_tpu_torch.runtime.datasets import BoxWorld, yaw_then_translate
from gie_mapping_tpu_torch.utils import config as tcfg
from gie_mapping_tpu_torch.utils import geometry as tgeo

SMALL = dict(local_size_m=(4.0, 4.0, 1.6), max_raycast_points=4096,
             display_glb_edt=False, display_glb_ogm=False, edt_gate_min_vox=0)
VW = 0.1


@pytest.fixture(scope="module")
def frames():
    """The JAX and the port's FrameOutput of the third frame of one run."""
    jm = JaxMapper(jcfg.cow_lady_config(**SMALL))
    tm = TorchMapper(tcfg.cow_lady_config(**SMALL), device="cpu")
    world = BoxWorld.corridor(seed=11, n_pillars=8, extent=4.0, height=2.5)
    for i, pose in enumerate(yaw_then_translate(n_yaw=2, n_move=1)):
        pts = world.pointcloud(tgeo.Projection.from_pose(*pose), n_rays=4096,
                               max_range=8.0, seed=i)
        jo = jm.process_pointcloud(jgeo.Projection.from_pose(*pose), pts)
        to = tm.process_pointcloud(tgeo.Projection.from_pose(*pose), pts)
    return jo, to


def test_cost_map_msg_payload8_bytes(frames):
    jo, to = frames
    jmsg, tmsg = jo.cost_map_msg(VW), to.cost_map_msg(VW)
    assert tmsg["payload8"] == jmsg["payload8"]
    assert hashlib.sha256(tmsg["payload8"]).hexdigest() == \
        hashlib.sha256(jmsg["payload8"]).hexdigest()
    assert {k: v for k, v in tmsg.items() if k != "payload8"} == \
        {k: v for k, v in jmsg.items() if k != "payload8"}
    assert FrameOutput.PAYLOAD8_DTYPE == JaxFrameOutput.PAYLOAD8_DTYPE
    rec = np.frombuffer(tmsg["payload8"], dtype=FrameOutput.PAYLOAD8_DTYPE)
    X, Y, Z = to.edt.shape
    assert (rec["o"] != 0).any() and (rec["d"] > 0).any()
    np.testing.assert_array_equal(rec["d"].reshape(Z, Y, X),
                                  to.edt.transpose(2, 1, 0))


def _probe_points(to, n, seed):
    """World points across the window: voxel centres, faces and points
    just outside it."""
    rng = np.random.default_rng(seed)
    shape = np.asarray(to.edt.shape)
    g = rng.uniform(-1.5, shape + 0.5, (n, 3))
    g[: n // 4] = np.round(g[: n // 4])
    g[n // 4: n // 2] = np.floor(g[n // 4: n // 2]) + 0.5
    return (g + to.pvt) * VW


def test_query_distance_matches_jax(frames):
    jo, to = frames
    pts = _probe_points(to, 4096, 1)
    for a, b in zip(to.query_distance(pts, VW), jo.query_distance(pts, VW)):
        np.testing.assert_array_equal(a, b)
    _, _, valid = to.query_distance(pts, VW)
    assert valid.any() and not valid.all()
    # a [..., 3] batch keeps its leading shape
    d, g, v = to.query_distance(pts[:60].reshape(3, 20, 3), VW)
    assert d.shape == (3, 20) and g.shape == (3, 20, 3) and v.shape == (3, 20)


def test_debug_voxel_matches_jax(frames):
    jo, to = frames
    pts = _probe_points(to, 512, 2)
    got = [to.debug_voxel(p, VW) for p in pts]
    assert got == [jo.debug_voxel(p, VW) for p in pts]
    assert any(g is None for g in got) and any(g is not None for g in got)
    assert any(g is not None and g["type"] == 2 for g in got)


def test_clouds_match_jax(frames):
    jo, to = frames
    occ = to.local_occupied_cloud(VW)
    np.testing.assert_array_equal(occ, jo.local_occupied_cloud(VW))
    assert len(occ) > 0
    for a, b in zip(to.local_edt_cloud(VW), jo.local_edt_cloud(VW)):
        np.testing.assert_array_equal(a, b)


def test_fetch_brings_every_field_at_once(frames):
    _, to = frames
    fresh = FrameOutput(to.raw, origin=to.origin, pvt=to.pvt)
    assert fresh.fetch() is fresh
    assert set(fresh._cache) == set(FrameOutput._FIELDS)
    for k in FrameOutput._FIELDS:
        v = to.raw[k]
        want = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
        got = fresh._cache[k]
        if want.ndim == 0:  # scalars come back as Python numbers
            assert type(got) is type(want.item()) and got == want.item(), k
        else:
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        assert fresh.device(k) is v
        # the attribute path gives the same
        np.testing.assert_array_equal(np.asarray(getattr(to, k)), np.asarray(got))
