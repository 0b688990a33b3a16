"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA card and skip without one.  This file imports no
JAX, so on a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch.ops import edt_batch as eb
from gie_mapping_tpu_torch.ops import raycast as rc
from gie_mapping_tpu_torch.ops.kernels import carve as kc
from gie_mapping_tpu_torch.ops.kernels import envelope as ke
from gie_mapping_tpu_torch.ops.kernels import phase1 as kp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _types(shape, frac, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.where(rng.random(shape) < frac, 2,
                                     rng.integers(0, 2, shape)).astype(np.int8))


@pytest.mark.parametrize("shape", [(152, 152, 80), (9, 33, 7)])
def test_phase1_kernel_matches_plain(dev, shape):
    t = _types(shape, 0.03, 1).to(dev)
    got = kp.phase1_packed(t, sum(shape))
    assert torch.equal(got, kp.phase1_packed_plain(t, sum(shape)))


def test_envelope_kernels_match_plain(dev):
    t = _types((40, 33, 12), 0.05, 2).to(dev)
    w = kp.phase1_packed_plain(t, 85).permute(0, 2, 1).contiguous()
    yb = kp.phase1_pack_bits(33)
    for a, b in zip(ke.envelope_packed(w, yb), ke.envelope_packed_plain(w, yb)):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(3)
    f = torch.randint(0, 300, (6, 21, 37), generator=g, dtype=torch.int32)
    f[:, :, ::4] = 1 << 28
    pay = torch.randint(0, 1 << 20, f.shape, generator=g, dtype=torch.int32)
    f, pay = f.to(dev), pay.to(dev)
    for a, b in zip(ke.envelope_mid(f, pay), ke.envelope_mid_plain(f, pay)):
        assert torch.equal(a, b)


def test_batch_edt_on_gpu_matches_cpu(dev):
    t = _types((32, 40, 16), 0.01, 4)
    ref = eb.batch_edt(t, 88)
    got = eb.batch_edt(t.to(dev), 88)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k])
    ref = eb.batch_edt_slab(t, 8, 16, sx=16, sy=24, max_width=88)
    got = eb.batch_edt_slab(t.to(dev), 8, 16, sx=16, sy=24, max_width=88)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k])


def test_carve_kernel_matches_plain(dev):
    rng = np.random.default_rng(5)
    pts = torch.from_numpy((rng.normal(size=(8192, 3)) * 2
                            + [0.3, -0.2, 1.2]).astype(np.float32)).to(dev)
    valid = torch.ones(8192, dtype=torch.bool, device=dev)
    local = (40, 40, 16)
    origin = np.asarray([0.31, -0.17, 1.13], np.float32)
    pvt = np.asarray([-17, -22, 0], np.int32)
    nt, np_ = rc.panorama_bins(local)
    depth, cnt = rc.panorama(pts, valid, origin, n_theta=nt, n_phi=np_,
                             local_size=local, voxel_width=0.1)
    ep = rc.endpoint_counts(pts, valid, pvt, local_size=local, voxel_width=0.1,
                            ogm_min_h=0.0, ogm_max_h=2.5)
    kw = dict(local_size=local, voxel_width=0.1, n_theta=nt, n_phi=np_,
              for_motion_planner=True, robot_r2_grids=16)
    for a, b in zip(kc.carve(depth, cnt, ep, pvt, origin, **kw),
                    kc.carve_plain(depth, cnt, ep, pvt, origin, **kw)):
        assert torch.equal(a, b)
