"""HostMirror.ingest_rows unpacks only the rows it serves: held against the
JAX package's ingest (unpack every handed row, then keep the changed blocks
of valid columns), block for block and digest for digest."""
from types import SimpleNamespace

import numpy as np
import pytest

from gie_mapping_tpu.runtime.host_mirror import HostMirror as JaxHostMirror
from gie_mapping_tpu_torch.map_state import COC_INVALID16
from gie_mapping_tpu_torch.runtime import host_mirror
from gie_mapping_tpu_torch.runtime.host_mirror import HostMirror, mirror_digest

CB = (5, 4, 3)  # the canvas's blocks; the mirror reads nothing else of a config
K = 6
W = 8


def _tick(rng, cols, valid, mask, origin, stray=None):
    """One tick's stream_extract outputs as the host gets them: column ids
    (0 where invalid), packed rows (random bits, some cocs the sentinel) and
    a block mask AND-ed with the valid columns, as stream_extract gives it;
    `stray` sets bits in invalid columns besides, which the ingest's own
    valid-column test has to drop."""
    col_ids = np.where(valid, cols, 0).astype(np.int32)
    rows = rng.integers(0, 2**32, (K * CB[2], W**3, 3), dtype=np.uint32)
    inv = rng.random(rows.shape[:2]) < 0.3
    rows[inv, 1] = (rows[inv, 1] & 0xFFFF0000) | np.uint32(COC_INVALID16)
    blk_mask = np.asarray(mask, bool) & np.asarray(valid)[:, None]
    if stray is not None:
        blk_mask[stray] = True
    return (col_ids, np.asarray(valid), rows, blk_mask,
            np.asarray(origin, np.int32))


def _partial(rng):
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    mask = rng.random((K, CB[2])) < 0.4
    mask[0] = [0, 1, 0]
    return [_tick(rng, [3, 17, 0, 8, 0, 11], valid, mask, (-7, 2, 5),
                  stray=2)]


def _every_row(rng):
    return [_tick(rng, [0, 4, 9, 13, 18, 19], np.ones(K, bool),
                  np.ones((K, CB[2]), bool), (1, -3, 0))]


def _empty(rng):
    return [_tick(rng, [2, 5, 0, 0, 0, 0], np.array([1, 1, 0, 0, 0, 0], bool),
                  np.zeros((K, CB[2]), bool), (0, 0, 0))]


def _overwrite(rng):
    valid = np.array([1, 1, 1, 0, 0, 0], bool)
    first = _tick(rng, [6, 7, 12, 0, 0, 0], valid,
                  [[1, 1, 0], [0, 1, 1], [1, 0, 1]] + [[0] * 3] * 3, (4, 4, -2))
    second = _tick(rng, [12, 6, 1, 0, 0, 0], valid,
                   [[1, 1, 1], [1, 0, 0], [0, 0, 1]] + [[0] * 3] * 3, (4, 4, -2))
    return [first, second]


@pytest.mark.parametrize("ticks", [_partial, _every_row, _empty, _overwrite],
                         ids=["partial_columns", "every_row_served",
                              "empty_mask", "overwrite_keys"])
def test_ingest_rows_unpacks_served_rows_only(ticks, monkeypatch):
    cfg = SimpleNamespace(canvas_blocks=CB)
    got, want = HostMirror(cfg), JaxHostMirror(cfg)
    seen = []
    real = host_mirror.np_unpack_voxels

    def counting(rows):
        seen.append(len(rows))
        return real(rows)

    for i, tick in enumerate(ticks(np.random.default_rng(21))):
        n_want = want.ingest_rows(*tick)
        monkeypatch.setattr(host_mirror, "np_unpack_voxels", counting)
        seen.clear()
        n_got = got.ingest_rows(*tick)
        monkeypatch.setattr(host_mirror, "np_unpack_voxels", real)
        # blk_mask.sum() wherever the mask is stream_extract's own
        served = int(tick[3][tick[1]].sum())
        assert n_got == n_want == served, i
        assert seen == ([served] if served else []), i
        assert list(got.blocks) == list(want.blocks), i
        assert got.digest() == mirror_digest(want.blocks), i
        for key, blk in want.blocks.items():
            for name, a in blk.items():
                b = got.blocks[key][name]
                assert (b.dtype, b.shape) == (a.dtype, a.shape), (key, name)
                assert b.flags.c_contiguous, (key, name)
                np.testing.assert_array_equal(b, a, err_msg=f"{key} {name}")
    assert len(got) == len(want)
