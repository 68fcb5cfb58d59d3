"""Plain reference of SGBM (the port's ``matchers/registry.py:sgbm_match``
default branch): x-Sobel prefilter, Birchfield-Tomasi costs, box sum over
the window, N-path SGM, WTA with uniqueness and subpixel, the LR check,
the speckle filter and the median where the configuration has it."""

from __future__ import annotations

import torch

from portbench.reference import ops


def match(l: torch.Tensor, r: torch.Tensor, cfg: dict,
          dtype=torch.float32):
    """(1, H, W) float32 rectified pair -> ((1, H, W) disparity, valid).
    ``dtype`` is the precision of the WTA's subpixel step."""
    min_d, D = int(cfg["min_disparity"]), int(cfg["disparity_range"])
    lf = ops.xsobel_prefilter(l, int(cfg["prefilter_cap"]))
    rf = ops.xsobel_prefilter(r, int(cfg["prefilter_cap"]))
    C, valid_cv = ops.bt_cost_volume(lf, rf, min_d, D)
    C = ops.box_aggregate(C, valid_cv, int(cfg["window_size"]))
    del valid_cv
    dirs = {4: ops.DIRECTIONS_4, 8: ops.DIRECTIONS_8}[
        int(cfg["num_directions"])]
    S = ops.sgm_aggregate(C, float(cfg["p1"]), float(cfg["p2"]), dirs)
    del C
    disp, valid = ops.wta_disparity(
        S, min_d, uniqueness_ratio=float(cfg["uniqueness_ratio"]),
        subpixel=bool(cfg["subpixel"]), dtype=dtype)
    lr = float(cfg["disp12_max_diff"])
    if lr >= 0:
        valid = ops.lr_consistency(disp, valid, S, min_d,
                                   lr if lr > 0 else 1.0)
    del S
    valid = ops.speckle_filter(disp, valid,
                               max_size=int(cfg["speckle_size"]),
                               max_diff=float(cfg["speckle_range"]),
                               downsample=int(cfg["speckle_downsample"]))
    if cfg["median_filter"]:
        disp = ops.median3x3_masked(disp, valid)
    return disp, valid
