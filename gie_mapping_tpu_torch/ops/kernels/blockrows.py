"""Block-row copies between the packed canvas, archive rows and the archive:
kernel wrappers + plain versions.

Counterparts of gie_mapping_tpu/ops/pallas/blockrows.py (gather_block_rows,
scatter_block_rows, gather_archive_rows, scatter_archive_rows); the CUDA
kernels are csrc/blockrows.cu.  A block's row is 1536 int32 words, viewed
[512, 3] per voxel or [8, 8, 24] as (x, y, z * 3): it holds exactly the
canvas words packed.reshape(X, Y, Z * 3)[8bx:8bx+8, 8by:8by+8, 24j:24j+24].
Canvas entries come by (x, y) block-COLUMN (bx * cby + by) with all cbz
z-blocks of the column; row k * cbz + j is (column entry k, z-block j).

Invalid entries are skipped (no parking column, no ordering constraint);
valid targets must be unique.  The scatters update their first argument in
place and return it.
"""
from __future__ import annotations

import torch

from . import _build

VB = 8
ROW_WORDS = VB ** 3 * 3


def _canvas_blocks(packed, canvas_blocks):
    X, Y, Z, _ = packed.shape
    cbx, cby, cbz = canvas_blocks
    if (X, Y, Z) != (cbx * VB, cby * VB, cbz * VB):
        raise ValueError(f"canvas {tuple(packed.shape)} does not match "
                         f"blocks {tuple(canvas_blocks)}")
    return cbx, cby, cbz


def _entries(col_ids, cbz, cby):
    """(bx, by, j) int64 per row of the column entries."""
    c = col_ids.to(torch.int64).repeat_interleave(cbz)
    j = torch.arange(cbz, device=col_ids.device).repeat(col_ids.shape[0])
    return c // cby, c % cby, j


def gather_block_rows_plain(packed, col_ids, canvas_blocks):
    """Plain version of gather_block_rows."""
    cbx, cby, cbz = _canvas_blocks(packed, canvas_blocks)
    v = packed.reshape(cbx, VB, cby, VB, cbz, 3 * VB)
    bx, by, j = _entries(col_ids, cbz, cby)
    return v[bx, :, by, :, j, :].reshape(-1, VB ** 3, 3)


def scatter_block_rows_plain(packed, rows, col_ids, valid, canvas_blocks):
    """Plain version of scatter_block_rows."""
    cbx, cby, cbz = _canvas_blocks(packed, canvas_blocks)
    v = packed.view(cbx, VB, cby, VB, cbz, 3 * VB)
    bx, by, j = _entries(col_ids, cbz, cby)
    m = valid != 0
    v[bx[m], :, by[m], :, j[m], :] = rows.reshape(-1, VB, VB, 3 * VB)[m]
    return packed


def gather_archive_rows_plain(a_packed, ids):
    """Plain version of gather_archive_rows."""
    return a_packed[ids.to(torch.int64)].reshape(-1, VB ** 3, 3)


def scatter_archive_rows_plain(a_packed, rows, ids, valid):
    """Plain version of scatter_archive_rows."""
    m = valid != 0
    a_packed[ids.to(torch.int64)[m]] = rows.reshape(-1, ROW_WORDS)[m]
    return a_packed


# The checks run on every launch, so each takes the cheap form: tensor
# properties rather than device objects, no copy of a contiguous tensor.
def _cuda_args(name, *ts):
    d = ts[0].get_device()
    for t in ts:
        if not t.is_cuda or t.get_device() != d:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
    out = [t if t.is_contiguous() else t.contiguous() for t in ts]
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return out


def _int32(name, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} wants int32 tensors, got {t.dtype}")


def _device_of(name, t):
    if t.is_cuda:
        return "cuda"
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return "cpu"


def gather_block_rows(packed, col_ids, canvas_blocks):
    """Rows [S * cbz, 512, 3] of the canvas block-columns col_ids [S] (in
    range; entries may repeat) of the packed canvas [X, Y, Z, 3].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _int32("gather_block_rows", packed, col_ids)
    if _device_of("gather_block_rows", packed) == "cpu":
        return gather_block_rows_plain(packed, col_ids, canvas_blocks)
    cbx, cby, cbz = _canvas_blocks(packed, canvas_blocks)
    cv, ids = _cuda_args("gather_block_rows", packed, col_ids)
    X, Y, Z, _ = packed.shape
    S = ids.shape[0]
    out = torch.empty((S * cbz, VB ** 3, 3), dtype=torch.int32,
                      device=packed.device)
    with _build.on_device_of(cv):
        rc = _build.fn("gie_gather_block_rows")(
            cv.data_ptr(), ids.data_ptr(), out.data_ptr(), S, X, Y, 3 * Z, cbz,
            _build.stream_of(cv))
    gather_block_rows.launches += 1
    _build.check("gie_gather_block_rows", rc)
    return out


def scatter_block_rows(packed, rows, col_ids, valid, canvas_blocks):
    """In place: canvas block (col_ids[k], j) := rows[k * cbz + j] wherever
    valid[k * cbz + j] != 0.  packed [X, Y, Z, 3] must be contiguous; rows
    [S * cbz, 512, 3]; col_ids [S]; valid [S * cbz].  Returns packed.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _int32("scatter_block_rows", packed, rows, col_ids, valid)
    if not packed.is_contiguous():
        raise ValueError("scatter_block_rows: the canvas must be contiguous")
    cbx, cby, cbz = _canvas_blocks(packed, canvas_blocks)
    S = col_ids.shape[0]
    if rows.numel() != S * cbz * ROW_WORDS or valid.numel() != S * cbz:
        raise ValueError("scatter_block_rows: rows/valid do not match col_ids")
    if _device_of("scatter_block_rows", packed) == "cpu":
        return scatter_block_rows_plain(packed, rows, col_ids, valid,
                                        canvas_blocks)
    cv, rs, ids, val = _cuda_args("scatter_block_rows", packed, rows, col_ids,
                                  valid)
    X, Y, Z, _ = packed.shape
    with _build.on_device_of(cv):
        rc = _build.fn("gie_scatter_block_rows")(
            cv.data_ptr(), rs.data_ptr(), ids.data_ptr(), val.data_ptr(), S, X, Y,
            3 * Z, cbz, _build.stream_of(cv))
    scatter_block_rows.launches += 1
    _build.check("gie_scatter_block_rows", rc)
    return packed


def gather_archive_rows(a_packed, ids):
    """Rows [K, 512, 3] of the flat archive a_packed [B, 1536] at ids [K]
    (in range).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _int32("gather_archive_rows", a_packed, ids)
    if _device_of("gather_archive_rows", a_packed) == "cpu":
        return gather_archive_rows_plain(a_packed, ids)
    if a_packed.dim() != 2 or a_packed.shape[1] != ROW_WORDS:
        raise ValueError("gather_archive_rows: the archive must be [B, 1536]")
    a, i = _cuda_args("gather_archive_rows", a_packed, ids)
    K = i.shape[0]
    out = a.new_empty((K, VB ** 3, 3))
    with _build.on_device_of(a):
        rc = _build.fn("gie_gather_archive_rows")(
            a.data_ptr(), i.data_ptr(), out.data_ptr(), K, a.shape[0],
            _build.stream_of(a))
    gather_archive_rows.launches += 1
    _build.check("gie_gather_archive_rows", rc)
    return out


def scatter_archive_rows(a_packed, rows, ids, valid):
    """In place: a_packed[ids[k]] := rows[k] wherever valid[k] != 0 (valid
    targets unique).  a_packed [B, 1536] contiguous; rows [K, 512, 3].
    Returns a_packed.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _int32("scatter_archive_rows", a_packed, rows, ids, valid)
    if not a_packed.is_contiguous() or a_packed.shape[-1] != ROW_WORDS:
        raise ValueError("scatter_archive_rows: the archive must be a "
                         "contiguous [B, 1536]")
    K = ids.shape[0]
    if rows.numel() != K * ROW_WORDS or valid.numel() != K:
        raise ValueError("scatter_archive_rows: rows/valid do not match ids")
    if _device_of("scatter_archive_rows", a_packed) == "cpu":
        return scatter_archive_rows_plain(a_packed, rows, ids, valid)
    a, rs, i, val = _cuda_args("scatter_archive_rows", a_packed, rows, ids,
                               valid)
    with _build.on_device_of(a):
        rc = _build.fn("gie_scatter_archive_rows")(
            a.data_ptr(), rs.data_ptr(), i.data_ptr(), val.data_ptr(), K,
            a.shape[0], _build.stream_of(a))
    scatter_archive_rows.launches += 1
    _build.check("gie_scatter_archive_rows", rc)
    return a_packed


gather_block_rows.launches = 0
scatter_block_rows.launches = 0
gather_archive_rows.launches = 0
scatter_archive_rows.launches = 0
