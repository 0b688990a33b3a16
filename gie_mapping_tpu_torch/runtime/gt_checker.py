"""Online EDT ground-truth checker (the reference's Gnd_truth_checker,
gt_checker.h:13-88).

A copy of gie_mapping_tpu/runtime/gt_checker.py for the PyTorch port:
exact 1-NN distances from the occupied cloud, in the native library's
KD-tree, are compared with the engine's EDT; RMSE and max error accumulate
and print every 10 checks.
"""
from __future__ import annotations

import numpy as np

from ..utils.constants import VOX_OCCUPIED, VOX_UNKNOWN
from .native import get_lib, ptr


def knn_errors(occupied_pts, query_pts, edt_dists_m):
    """(rmse, max_err, mean_abs) of edt_dists_m against the exact 1-NN
    distances of query_pts to occupied_pts (all in metres; -1.0 each when
    either cloud is empty)."""
    occ = np.ascontiguousarray(occupied_pts, np.float32)
    q = np.ascontiguousarray(query_pts, np.float32)
    edt = np.ascontiguousarray(edt_dists_m, np.float32)
    if len(occ) == 0 or len(q) == 0:
        return -1.0, -1.0, -1.0
    out = np.zeros(3, np.float32)
    get_lib().gie_gt_check(ptr(occ), len(occ), ptr(q), len(q), ptr(edt),
                           ptr(out))
    return float(out[0]), float(out[1]), float(out[2])


class GroundTruthChecker:
    """Accumulating checker with the reference's every-10-checks report."""

    def __init__(self, report_every: int = 10):
        self.report_every = report_every
        self.rms_sum = 0.0
        self.rms_cnt = 0
        self.last = None
        self.last_global = None

    def check_frame(self, out, voxel_width: float, logger=None):
        """profile_loc_rms: one FrameOutput's window EDT against the 1-NN
        distances to the window's occupied voxels.  Fetches the output's
        fields once."""
        out.fetch()
        types = out.glb_type
        occ_idx = np.argwhere(types == VOX_OCCUPIED)
        valid = (types != VOX_UNKNOWN) & (out.dist_sq < 900000)
        q_idx = np.argwhere(valid)
        if len(occ_idx) == 0 or len(q_idx) == 0:
            return None
        occ_pts = (occ_idx + out.pvt) * voxel_width
        q_pts = (q_idx + out.pvt) * voxel_width
        edt_m = out.edt[valid] * voxel_width
        rmse, mx, mean_abs = knn_errors(occ_pts, q_pts, edt_m)
        self.last = (rmse, mx, mean_abs)
        if rmse >= 0:
            self.rms_sum += rmse
            self.rms_cnt += 1
            if self.rms_cnt >= self.report_every:
                avg = self.rms_sum / self.rms_cnt
                print(f"max_error is {mx:.6f},  rms_err is {avg:.6f}")
                self.rms_sum = 0.0
                self.rms_cnt = 0
        if logger is not None:
            logger.log_rmse(rmse)
        return self.last

    def check_global(self, mirror, voxel_width: float, logger=None):
        """profile_glb_rms: the streamed GLOBAL map, the host mirror's EDT
        cloud against its own occupied cloud (what consumers of the stream
        receive).  With both profile flags on, this RMSE is the one the CSV
        records (it is logged last)."""
        occ_pts = mirror.occupied_cloud(voxel_width)
        q_pts, edt_m = mirror.edt_cloud(voxel_width)
        if len(occ_pts) == 0 or len(q_pts) == 0:
            return None
        rmse, mx, mean_abs = knn_errors(occ_pts, q_pts, edt_m)
        self.last_global = (rmse, mx, mean_abs)
        if logger is not None and rmse >= 0:
            logger.log_rmse(rmse)
        return self.last_global
