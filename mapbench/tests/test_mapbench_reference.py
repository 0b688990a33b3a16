"""The plain reference against the engine's CPU path at a tiny size, and
its EDT against scipy."""
import numpy as np
import pytest
import torch

from conftest import CELLS, tiny_cell
from mapbench.reference.edt import exact_edt
from mapbench.run import run_cell


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: ".".join(c))
@pytest.mark.parametrize("gate", [True, False])
def test_reference_matches_engine(cell, gate):
    config, tr = tiny_cell(cell, gate)
    result, checks, info = run_cell(config, tr, seed=2147483701, seconds=0,
                                    device="cpu", max_frames=14)
    assert result["correct"], (checks, info)
    assert all(v == 0 for _, v, _ in checks)
    if tr["path"]["laps"]:
        assert info["scrolls_replayed"] > 5 and info["archived_blocks"] > 0
    assert info["mirror_blocks"] > 0


def test_edt_distances_match_scipy():
    ndimage = pytest.importorskip("scipy.ndimage")
    rng = np.random.default_rng(4)
    sites = rng.random((19, 23, 11)) < 0.02
    e = exact_edt(torch.from_numpy(sites), 1000)
    d = ndimage.distance_transform_edt(~sites, return_distances=True)
    assert e["valid"].all()
    assert np.array_equal(e["dist_sq"].numpy(), np.rint(d ** 2).astype(np.int64))
    coc = e["coc"].numpy()
    assert sites[coc[..., 0], coc[..., 1], coc[..., 2]].all()
    idx = np.indices(sites.shape).transpose(1, 2, 3, 0)
    assert np.array_equal(((idx - coc) ** 2).sum(-1), e["dist_sq"].numpy())


def test_edt_tie_rule():
    """Two sites at equal distance: pass 2 and pass 3 take the smaller
    coordinate, pass 1 the lower y."""
    s = torch.zeros(5, 5, 5, dtype=torch.bool)
    s[0, 2, 2] = s[4, 2, 2] = True
    assert exact_edt(s, 100)["coc"][2, 2, 2].tolist() == [0, 2, 2]
    s = torch.zeros(5, 5, 5, dtype=torch.bool)
    s[2, 0, 2] = s[2, 4, 2] = True
    assert exact_edt(s, 100)["coc"][2, 2, 2].tolist() == [2, 0, 2]
    s = torch.zeros(5, 5, 5, dtype=torch.bool)
    s[2, 2, 0] = s[2, 2, 4] = True
    assert exact_edt(s, 100)["coc"][2, 2, 2].tolist() == [2, 2, 0]
