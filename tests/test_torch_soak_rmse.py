"""The JAX package's 500-frame soak (tests/test_soak_rmse.py) on the port:
the same trajectory, worlds and fence churn
(tests/test_torch_scenario_cases.py's soak_rmse, which chip_smoke.py's
bench phase runs on the card), held to the JAX test's own assertions:
every frame's published EDT within one voxel of the exact 1-NN over the
believed-occupied set (canvas and archive), its RMSE within one voxel
width, no CapacityWarning, no archive drop, and the oracle run on more
than 90 % of the frames."""
import pytest
import torch

import test_torch_scenario_cases as sc


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_soak_500_frames_rmse_floor():
    rec = sc.soak_rmse(sc.port_api("cpu"))
    vw = sc.SOAK_VW
    for row in rec["curve"]:
        assert row["rmse_m"] <= vw, (row["frame"], row["rmse_m"])
        assert row["max_err_m"] <= vw * (1.0 + 1e-6), (row["frame"],
                                                       row["max_err_m"])
    assert rec["capacity"]["arch_dropped"] == 0
    assert len(rec["curve"]) > sc.SOAK_FRAMES * 0.9
    assert sc.soak_rmse_faults(rec) == []
