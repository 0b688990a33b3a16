"""The port's sharded dry run (graft_entry.dryrun_multichip) over 2, 4 and 8
CPU shards against the root __graft_entry__.py's dryrun_multichip on as
many virtual CPU devices: every merge and the replay, call for call, bit
for bit (tests/fixtures/torch_port_entry_ref.npz, written by
make_torch_port_ref.py --only entry), the printed line and its numbers,
and the JAX function's five assertions."""
import os

import numpy as np
import pytest
import torch

from gie_mapping_tpu_torch import graft_entry as ge
from gie_mapping_tpu_torch.models import pipeline as tpipe

REF = os.path.join(os.path.dirname(__file__), "fixtures",
                   "torch_port_entry_ref.npz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small operations: one intra-op thread
    runs them as fast as eight alone, and does not fight the suite's other
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_matches_jax(n, capsys):
    ref = np.load(REF)
    pre = f"dry{n}/"
    calls = []
    res = ge.dryrun_multichip(n, devices=["cpu"] * n,
                              on_call=ge.recorder(calls))
    line = capsys.readouterr().out.strip()
    assert line == str(ref[pre + "line"])
    assert len(calls) == int(ref[pre + "calls"]) == 8
    for i, rec in enumerate(calls):
        want = {k[len(f"{pre}{i}/"):]: ref[k] for k in ref.files
                if k.startswith(f"{pre}{i}/")}
        assert set(rec) == set(want), i
        for k, v in rec.items():
            assert np.asarray(v).tolist() == want[k].tolist(), (i, k)
    for k in ("relax_iters", "present", "replay_frames", "scrolls",
              "raise_probe", "raise_after"):
        assert res[k] == ref[pre + k].item(), k
    assert res["gate_levels"] == ref[pre + "gate_levels"].tolist()
    # the JAX function's assertions, on the port's numbers (the dist_sq
    # shape is asserted inside: a failed one would have raised)
    n_menu = len(tpipe._slab_menu(ge.dryrun_config(n).canvas_size))
    levels = res["gate_levels"]
    assert res["raise_after"] > res["raise_probe"]
    assert any(0 <= g < n_menu for g in levels)
    assert any(0 < g < n_menu for g in levels)
    assert res["relax_iters"] > 0
    # the replay is one call; the others are single merges
    kinds = ["pf_gate_level" in rec for rec in calls]
    assert kinds == [False, True] + [False] * 6
