"""The JAX package's every-preset scenario (tests/test_all_cases.py) on
the port: each case's own sensor at a reduced window, run on both packages
from the same numpy inputs (tests/test_torch_scenario_cases.py); the
port's record is held to the JAX package's bit for bit (every frame's
outputs, the final MapState, capacity_report(), warning texts), and then
the JAX test's own assertions are applied to the port's results."""
import numpy as np
import pytest
import torch

import test_torch_scenario_cases as sc
from test_torch_scenario_jax import both
from gie_mapping_tpu_torch.utils.constants import VOX_OCCUPIED


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tests/test_all_cases.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sc.CASES)
def test_case_end_to_end(case):
    """Every preset through its own sensor at a reduced window: occupied
    voxels with zero EDT, no archive drop."""
    cfg, m, rec, _ = both(sc.case_end_to_end, case=case)
    out = rec["frames"][-1]
    occ = out["glb_type"] == VOX_OCCUPIED
    assert occ.sum() > 0
    assert np.allclose(out["edt"][occ], 0.0)
    assert out["arch_dropped"] == 0
