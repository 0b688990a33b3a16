"""The control (the reference in bfloat16 in the engine's place) and the
faults that the comparison must see, at a tiny size on the CPU."""
import pytest

from conftest import CELLS, tiny_cell
from mapbench.control import control_checks
from mapbench.run import run_cell


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: ".".join(c))
def test_control_is_not_correct(cell):
    config, tr = tiny_cell(cell)
    checks = control_checks(config, tr, seed=3, frames=20, device="cpu")
    assert any(v > lim for _, v, lim in checks), checks


def _run(config, tr):
    result, checks, info = run_cell(config, tr, seed=77, seconds=0, device="cpu",
                                    max_frames=8)
    return result, dict((k, v) for k, v, _ in checks)


def test_state_left_unchanged(monkeypatch, tiny_flight):
    """One window frame whose merge returns the map it was given."""
    import gie_mapping_tpu_torch.models.mapper as mm
    real = mm.merge_frame
    calls = []

    def merge(state, *a, **kw):
        out_state, out = real(state, *a, **kw)
        calls.append(1)
        return (state if len(calls) == 15 else out_state), out
    monkeypatch.setattr(mm, "merge_frame", merge)
    result, checks = _run(*tiny_flight)
    assert not result["correct"] and checks["canvas_diff"] > 0


def test_distance_altered_where_produced(monkeypatch, tiny_flight):
    """From the fourteenth frame on, the EDT gives every voxel a distance
    one larger."""
    import gie_mapping_tpu_torch.models.pipeline as pl
    calls = []

    def wrap(f):
        def g(*a, **kw):
            out = f(*a, **kw)
            calls.append(1)
            if len(calls) >= 14:
                out = dict(out, dist_sq=out["dist_sq"] + out["valid"].int())
            return out
        return g
    monkeypatch.setattr(pl, "batch_edt", wrap(pl.batch_edt))
    monkeypatch.setattr(pl, "batch_edt_slab", wrap(pl.batch_edt_slab))
    result, checks = _run(*tiny_flight)
    assert not result["correct"], checks


def test_streamed_block_lost(monkeypatch, tiny_flight):
    """The mirror drops the first block of each tick's rows from the
    twelfth tick on."""
    from gie_mapping_tpu_torch.runtime.host_mirror import HostMirror
    real = HostMirror.ingest_rows
    calls = []

    def ingest(self, col_ids, col_valid, rows, blk_mask, origin_blk):
        calls.append(1)
        if len(calls) >= 12 and blk_mask.any():
            blk_mask = blk_mask.copy()
            k, j = next(zip(*blk_mask.nonzero()))
            blk_mask[k, j] = False
        return real(self, col_ids, col_valid, rows, blk_mask, origin_blk)
    monkeypatch.setattr(HostMirror, "ingest_rows", ingest)
    result, checks = _run(*tiny_flight)
    assert not result["correct"] and checks["mirror_diff"] > 0


def test_archive_that_drops_blocks(tiny_flight):
    """With max_blocks reached both sides drop blocks alike: they agree, and
    the guarantee that the archive drops nothing is broken all the same."""
    config, tr = tiny_flight
    config["deployment"]["max_blocks"] = 4
    config["overrides"]["max_blocks"] = 4
    result, checks = _run(config, tr)
    assert not result["correct"] and checks["archive_dropped"] > 0
