"""The card's published peaks and the work each of the engine's kernels
must do, counted from the shapes of its call.

Peaks: one NVIDIA H100 SXM (data sheet, dense, 700 W): 3.35 TB/s of HBM
and 67 TFLOP/s of float32 outside the tensor cores (the integer rate is no
higher, so a bound from it stays a lower bound).  A call's bound is the
larger of its bytes over the bandwidth and its operations over the rate.
Bytes count each input byte read once and each output byte written once;
operations are per element of what the function needs (an exact 1-D
envelope is O(N) per line), not what a kernel happens to do.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
ENV_OPS_PER_SITE = 10
P1_OPS_PER_VOXEL = 12
CARVE_OPS_PER_VOXEL = 150
PANORAMA_OPS_PER_POINT = 250
ROW_BYTES = 512 * 3 * 4  # one packed block row: 512 voxels of three words

# kernel wrapper -> (modules whose attribute of that name calls it, the
# CUDA kernels it launches: a device record belongs to it where its name
# holds one of these)
KERNELS = {
    "phase1_packed": (("ops.edt_batch", "models.pipeline"), ("phase1_bits_kernel",)),
    "envelope_packed": (("ops.edt_batch",), ("envelope_packed_fh_kernel",)),
    "envelope_mid": (("ops.edt_batch",), ("envelope_mid_fh_kernel",)),
    "shift_canvas": (("map_state",), ("shift_canvas_kernel",)),
    "gather_block_rows": (("map_state",), ("gather_block_rows_kernel",)),
    "scatter_block_rows": (("map_state",), ("scatter_block_rows_kernel",)),
    "gather_archive_rows": (("map_state",), ("gather_archive_rows_kernel",)),
    "scatter_archive_rows": (("map_state",), ("scatter_archive_rows_kernel",)),
    "panorama": (("ops.raycast",), ("panorama_init", "panorama_points")),
    "carve": (("ops.raycast",), ("carve_kernel",)),
}
EDT_KERNELS = ("phase1_packed", "envelope_packed", "envelope_mid")


def _n(t) -> int:
    return int(t.numel())


def work(kernel: str, args: tuple, kw: dict | None = None) -> tuple:
    """(bytes, operations, mask) of one call, `mask` a tensor whose count
    of nonzero entries scales the bytes (rows a masked copy really moves),
    or None."""
    kw = kw or {}
    if kernel == "phase1_packed":       # int8 type in, int32 word out
        n = _n(args[0])
        return 5 * n, P1_OPS_PER_VOXEL * n, None
    if kernel == "envelope_packed":     # word in; key and payload out
        n = _n(args[0])
        return 12 * n, ENV_OPS_PER_SITE * n, None
    if kernel == "envelope_mid":        # cost and payload in; key, payload out
        n = _n(args[0])
        return 16 * n, ENV_OPS_PER_SITE * n, None
    if kernel == "shift_canvas":        # every packed word read and written
        return 8 * _n(args[0]), 0, None
    if kernel == "gather_block_rows":   # rows of every listed column
        cbz = int(args[2][2])
        return 2 * ROW_BYTES * _n(args[1]) * cbz, 0, None
    if kernel == "scatter_block_rows":  # the valid rows, read and written
        return 2 * ROW_BYTES, 0, args[3]
    if kernel == "gather_archive_rows":  # every listed slot
        return 2 * ROW_BYTES * _n(args[1]), 0, None
    if kernel == "scatter_archive_rows":  # the valid rows
        return 2 * ROW_BYTES, 0, args[3]
    if kernel == "panorama":            # points and validity in; the bin
        X, Y, Z = kw["local_size"]      # tables and endpoint counts out
        n = _n(args[1])
        return (13 * n + 4 * (2 * kw["n_theta"] * kw["n_phi"] + X * Y * Z),
                PANORAMA_OPS_PER_POINT * n, None)
    if kernel == "carve":               # the tables and endpoint counts in;
        n = _n(args[2])                 # a ray count and a type out
        return (4 * (_n(args[0]) + _n(args[1])) + 9 * n,
                CARVE_OPS_PER_VOXEL * n, None)
    raise KeyError(kernel)


def bound_s(bytes_: float, ops: float) -> float:
    return max(bytes_ / HBM_BYTES_PER_S, ops / OPS_PER_S)
