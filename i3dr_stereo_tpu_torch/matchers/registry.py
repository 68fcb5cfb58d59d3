"""Matcher backends keyed by the reference's algorithm enum (torch port of
``i3dr_stereo_tpu.matchers.registry``).

| enum | reference                          | here                                |
|------|------------------------------------|-------------------------------------|
| 0    | MatcherOpenCVBlock (cv::StereoBM)  | bm_match — SAD block matching       |
| 1    | MatcherOpenCVSGBM (cv::StereoSGBM) | sgbm_match — BT + 8/5/4-path SGM    |
| 2    | MatcherI3DRSGM (Phobos engine)     | i3drsgm_match — census pyramid SGM, |
|      |                                    | or dense census SGM (D <= 64)       |
| 3    | MatcherOpenCVBlockCuda             | bm_match                            |
| 4    | MatcherOpenCVBPCuda                | bp_match — hierarchical min-sum BP  |
| 5    | MatcherOpenCVCSBPCuda              | csbp_match — constant-space BP      |

Every backend takes (H, W) or (B, H, W) float32 images and returns a
MatchResult. The SGM of SGBM and dense I3DRSGM is
:func:`~i3dr_stereo_tpu_torch.ops.sgm.sgm_aggregate` (the ``sgm_volume``
kernel on a CUDA tensor), with the semantics of the TPU's default
backend. The reference's backend switch (``I3DR_SGM_BACKEND``) is one
keyword here, ``lean`` (default False), on every backend and on
:func:`compute_disparity`: ``lean=True`` computes what the reference
computes under ``I3DR_SGM_BACKEND=pallas`` — the fused cost + SGM path of
:mod:`~i3dr_stereo_tpu_torch.ops.fused_cost_sgm` in the pyramid and in
SGBM with the BT cost at ``window_size <= 1``; everything else is the
same on both, as in the reference. The hole-filling options follow the
reference: ``interp`` is the backward-match-driven WLS fill
(:func:`_interp_backward_wls`) in BM and SGBM, ``interpolate_missing``
the plain WLS fill, and dense I3DRSGM takes the plain WLS fill for
either (the ``wls_lines`` kernel on a CUDA tensor). BP and CSBP are
:mod:`~i3dr_stereo_tpu_torch.matchers.bp` (kernels ``bp_messages`` and
``bp_planes`` on a CUDA tensor); they have no SGM, so ``lean`` changes
nothing there.
"""

from __future__ import annotations

import math
import warnings

import torch

from i3dr_stereo_tpu_torch.config.params import (
    Algorithm,
    CostFunction,
    MatcherConfig,
)
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.matchers.bp import belief_propagation_match
from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match
from i3dr_stereo_tpu_torch.ops.census import (census_cost_volume,
                                            census_transform_pair)
from i3dr_stereo_tpu_torch.ops.block_gather import pad_edge
from i3dr_stereo_tpu_torch.ops.cost import (
    box_aggregate,
    bt_box_cost_volume,
    bt_cost_volume,
    normalized_response_prefilter,
    sad_cost_volume,
    texture_response,
    xsobel_prefilter,
)
from i3dr_stereo_tpu_torch.ops.fused_cost_sgm import fused_bt_sgm
from i3dr_stereo_tpu_torch.ops.lr_check import (lr_consistency,
                                                right_cost_volume)
from i3dr_stereo_tpu_torch.ops.median import median3x3_masked
from i3dr_stereo_tpu_torch.ops.sgm import (
    DIRECTIONS_4,
    DIRECTIONS_5,
    DIRECTIONS_8,
    sgm_aggregate,
)
from i3dr_stereo_tpu_torch.ops.speckle import speckle_filter
from i3dr_stereo_tpu_torch.ops.wls import wls_fill, wls_fill_lr
from i3dr_stereo_tpu_torch.ops.wta import wta_disparity


def _interp_backward_wls(disp, valid, S, cfg: MatcherConfig, left):
    """The reference's full interp path: a right-anchored backward match
    feeding LR-confidence-weighted WLS (matcherOpenCVBlock.cpp:22-33),
    the backward match taken from the aggregated volume (no second match
    pass)."""
    SR = right_cost_volume(S, cfg.min_disparity)
    disp_r, ok_r = wta_disparity(SR, cfg.min_disparity, uniqueness_ratio=0.0,
                                 subpixel=cfg.subpixel)
    return wls_fill_lr(disp, valid, disp_r, ok_r, left)


def _fill_holes(disp, valid, S, cfg: MatcherConfig, left):
    """BM's and SGBM's hole filling: ``interp`` the backward WLS fill,
    ``interpolate_missing`` the plain WLS fill."""
    if cfg.interp:
        return _interp_backward_wls(disp, valid, S, cfg, left)
    if cfg.interpolate_missing:
        return wls_fill(disp, valid, left)
    return disp, valid


def _batched(left, right):
    left, right = torch.as_tensor(left), torch.as_tensor(right)
    batched = left.ndim == 3
    l = (left if batched else left[None]).float()
    r = (right if right.ndim == 3 else right[None]).float()
    return l, r, batched


def _result(disp, valid, batched: bool) -> MatchResult:
    if not batched:
        disp, valid = disp[0], valid[0]
    return MatchResult(disparity=disp, valid=valid)


def _directions(cfg: MatcherConfig):
    return {4: DIRECTIONS_4, 5: DIRECTIONS_5, 8: DIRECTIONS_8}[
        cfg.num_directions]


def _cost_volume(left, right, cfg: MatcherConfig):
    """Pixel costs by the configured cost function, pre-aggregation."""
    if cfg.cost == CostFunction.CENSUS:
        cl, cr = census_transform_pair(left, right, cfg.census_height,
                                       cfg.census_width)
        return census_cost_volume(cl, cr, cfg.min_disparity,
                                  cfg.disparity_range)
    lf = xsobel_prefilter(left, cfg.prefilter_cap)
    rf = xsobel_prefilter(right, cfg.prefilter_cap)
    volume = bt_cost_volume if cfg.cost == CostFunction.BT else sad_cost_volume
    return volume(lf, rf, cfg.min_disparity, cfg.disparity_range)


def _speckle(disp, valid, cfg: MatcherConfig):
    if cfg.speckle_size <= 0:
        return valid
    return speckle_filter(disp, valid, max_size=cfg.speckle_size,
                          max_diff=cfg.speckle_range,
                          downsample=cfg.speckle_downsample)


def _postprocess(disp, valid, S, cfg: MatcherConfig, left):
    """The shared post-match chain of SGBM: LR check, speckle, median,
    hole filling."""
    if cfg.disp12_max_diff >= 0 and cfg.algorithm != Algorithm.BM:
        disp, valid = lr_consistency(
            disp, valid, S, cfg.min_disparity,
            cfg.disp12_max_diff if cfg.disp12_max_diff > 0 else 1.0)
    valid = _speckle(disp, valid, cfg)
    if cfg.median_filter:
        disp = median3x3_masked(disp, valid)
    return _fill_holes(disp, valid, S, cfg, left)


def bm_match(left, right, cfg: MatcherConfig, *,
             lean: bool = False) -> MatchResult:
    """Block matching (cv::StereoBM semantics): x-Sobel or
    normalized-response prefilter, SAD over the correlation window, WTA
    with texture and uniqueness checks, speckle filter, subpixel, hole
    filling. It has no SGM, so ``lean`` changes nothing."""
    l, r, batched = _batched(left, right)
    if cfg.prefilter_type == "normalized_response":
        pl = normalized_response_prefilter(l, cfg.prefilter_size,
                                           cfg.prefilter_cap)
        pr = normalized_response_prefilter(r, cfg.prefilter_size,
                                           cfg.prefilter_cap)
    else:
        pl = xsobel_prefilter(l, cfg.prefilter_cap)
        pr = xsobel_prefilter(r, cfg.prefilter_cap)
    C, valid_cv = sad_cost_volume(pl, pr, cfg.min_disparity,
                                  cfg.disparity_range)
    S = box_aggregate(C, valid_cv, cfg.window_size)
    disp, valid = wta_disparity(S, cfg.min_disparity,
                                uniqueness_ratio=cfg.uniqueness_ratio,
                                subpixel=cfg.subpixel)
    if cfg.texture_threshold > 0:
        tex = texture_response(pl, cfg.window_size, cfg.prefilter_cap)
        valid = valid & (tex >= cfg.texture_threshold * cfg.window_size)
    valid = _speckle(disp, valid, cfg)
    disp, valid = _fill_holes(disp, valid, S, cfg, l)
    return _result(disp, valid, batched)


def sgbm_match(left, right, cfg: MatcherConfig, *,
               lean: bool = False) -> MatchResult:
    """Semi-global block matching (cv::StereoSGBM semantics): BT costs on
    the prefiltered pair, box sum over the window, N-path SGM, WTA with
    uniqueness, LR check, speckle, parabolic subpixel. With the BT cost the
    cost and its box sum are one ``bt_box_cost`` launch on the card.

    ``lean=True`` with the BT cost and ``window_size <= 1`` takes the
    reference's lean branch: pixelwise BT in doubled units fused with the
    forward pass (kernel ``fused_bt_fwd``), a uint8 volume and int16
    partials for the other directions. With any other cost or window it
    falls through to the default branch, as the reference does."""
    l, r, batched = _batched(left, right)
    if lean and cfg.cost == CostFunction.BT and cfg.window_size <= 1:
        H, W = l.shape[-2:]
        H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8
        lp = pad_edge(xsobel_prefilter(l, cfg.prefilter_cap), H8, W8)
        rp = pad_edge(xsobel_prefilter(r, cfg.prefilter_cap), H8, W8)
        S, C = fused_bt_sgm(lp.contiguous(), rp.contiguous(),
                            cfg.disparity_range, min_disp=cfg.min_disparity,
                            p1=cfg.p1, p2=cfg.p2, directions=_directions(cfg))
        S, C = S[:, :H, :W], C[:, :H, :W]
        disp, valid = wta_disparity(S, cfg.min_disparity,
                                    uniqueness_ratio=cfg.uniqueness_ratio,
                                    subpixel=cfg.subpixel)
        valid = valid & (C.amin(-1) < 255)
        disp, valid = _postprocess(disp, valid, S.to(torch.float32), cfg, l)
        return _result(disp, valid, batched)
    if cfg.cost == CostFunction.BT:
        C = bt_box_cost_volume(xsobel_prefilter(l, cfg.prefilter_cap),
                               xsobel_prefilter(r, cfg.prefilter_cap),
                               cfg.min_disparity, cfg.disparity_range,
                               cfg.window_size)
    else:
        C = box_aggregate(*_cost_volume(l, r, cfg), cfg.window_size)
    S = sgm_aggregate(C, cfg.p1, cfg.p2, _directions(cfg))
    disp, valid = wta_disparity(S, cfg.min_disparity,
                                uniqueness_ratio=cfg.uniqueness_ratio,
                                subpixel=cfg.subpixel)
    disp, valid = _postprocess(disp, valid, S, cfg, l)
    return _result(disp, valid, batched)


def i3drsgm_match(left, right, cfg: MatcherConfig, *,
                  lean: bool = False) -> MatchResult:
    """Census SGM with the Phobos-profile feature set: census window, 4
    path directions, backmatching check, speckle, median 3x3, and the WLS
    fill with ``interp`` or ``interpolate_missing``. With
    ``cfg.pyramid`` the coarse-to-fine schedule runs
    (:mod:`~i3dr_stereo_tpu_torch.matchers.pyramid`), its lean levels
    with ``lean=True``. The dense path is the same on both backends and
    covers at most 64 disparities, as on the TPU: a wider range warns and
    takes the pyramid, deep enough for the range at the engine's 31
    disparities per level (at least two levels)."""
    if cfg.pyramid:
        return pyramid_sgm_match(left, right, cfg, lean=lean)
    if cfg.disparity_range > 64:
        n = max(2, math.ceil(math.log2(max(cfg.disparity_range, 32)
                                       / 31.0)) + 1)
        warnings.warn(
            f"disparity_range={cfg.disparity_range} exceeds the dense "
            f"kernels' D<=64 ceiling; falling back to the pyramid "
            f"schedule ({n} levels — the engine's route to wide "
            f"ranges). Set pyramid=True to choose this explicitly, "
            f"or disparity_range<=64 for the dense path.", stacklevel=2)
        return pyramid_sgm_match(
            left, right, cfg.replace(pyramid=True, max_pyramid_level=n),
            lean=lean)
    l, r, batched = _batched(left, right)
    C, _ = _cost_volume(l, r, cfg)
    S = sgm_aggregate(C, cfg.p1, cfg.p2, _directions(cfg))
    disp, valid = wta_disparity(S, cfg.min_disparity,
                                uniqueness_ratio=cfg.uniqueness_ratio,
                                subpixel=cfg.subpixel)
    if cfg.backmatch_distance >= 0:
        disp, valid = lr_consistency(disp, valid, S, cfg.min_disparity,
                                     cfg.backmatch_distance)
    valid = _speckle(disp, valid, cfg)
    if cfg.median_filter:
        disp = median3x3_masked(disp, valid)
    if cfg.interp or cfg.interpolate_missing:
        disp, valid = wls_fill(disp, valid, l)
    return _result(disp, valid, batched)


def bp_match(left, right, cfg: MatcherConfig, *,
             lean: bool = False) -> MatchResult:
    """Hierarchical min-sum belief propagation
    (cv::cuda::StereoBeliefPropagation analog, matcherOpenCVBPCuda.cpp)."""
    return belief_propagation_match(left, right, cfg, constant_space=False)


def csbp_match(left, right, cfg: MatcherConfig, *,
               lean: bool = False) -> MatchResult:
    """Constant-space BP (cv::cuda::StereoConstantSpaceBP analog,
    matcherOpenCVCSBPCuda.cpp): coarse to fine on K candidate planes a
    pixel, then the speckle filter."""
    return belief_propagation_match(left, right, cfg, constant_space=True)


MATCHER_REGISTRY = {
    Algorithm.BM: bm_match,
    Algorithm.SGBM: sgbm_match,
    Algorithm.I3DRSGM: i3drsgm_match,
    Algorithm.BM_GPU: bm_match,
    Algorithm.BP_GPU: bp_match,
    Algorithm.CSBP_GPU: csbp_match,
}


def compute_disparity(left, right, cfg: MatcherConfig, *,
                      lean: bool = False) -> MatchResult:
    """Pure functional entry: dispatch on cfg.algorithm."""
    return MATCHER_REGISTRY[cfg.algorithm](left, right, cfg.sanitize(),
                                           lean=lean)
