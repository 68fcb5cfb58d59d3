"""Coarse-to-fine pyramid census SGM (torch port of
``i3dr_stereo_tpu.matchers.pyramid``): by default the flagship branch —
the ``pallas_t`` branch the TPU runs: block-anchor warp, residual-window
census SGM, true backmatching — and with ``lean=True`` the reference's
second backend (its ``I3DR_SGM_BACKEND=pallas`` branch), made one
argument.

Each level matches over a narrow residual window (31 disparities, the
engine's "Number Of Disparities = 31", ini/quick.param:128) around the
median-smoothed, upsampled prediction of the coarser level; the coarsest
level searches from the configured minimum disparity. Per level:

1. edge-pad both images to multiples of 128 (the reference computes on
   that padding; keeping it keeps the census of the warped image at the
   bottom and right edges identical);
2. warp the right image by the prediction, clamped to +-16 of its
   (8x128)-block anchor (``block_shift_gather``, the ``row_gather``
   kernel);
3. census both, then ``census_sgm_wta`` (kernels ``census_cost``,
   ``sgm_sweep`` three times, ``sgm_sweep_wta``: a running int16 sum
   updated in place, the WTA inside the last sweep);
4. true backmatching against the right-anchored WTA of the same cost
   volume, looked up with ``block_shift_gather``;
5. where the level has it (level 0 under :func:`profile_from_config`,
   every level of the engine's profiles), the speckle filter at
   ``cfg.speckle_downsample`` (``speckle_filter``, the ``speckle_ccl``
   kernel);
6. where the level has it, occlusion detection
   (:mod:`~i3dr_stereo_tpu_torch.ops.occlusion`), then the occluded
   pixels filled from the background side or dropped from ``valid``;
7. masked 3x3 median; between levels, invalid pixels take the local
   median; at level 0 with ``interpolate_gaps``, the level's hole filler
   (:func:`_fill_gaps`: the 32-direction Gauss fill, kernel
   ``gauss_rays``, or the WLS fill, kernel ``wls_lines``).

A profile's ``... Subpix`` passes refine the current estimate at half-pel
steps (:func:`~i3dr_stereo_tpu_torch.ops.subpix.halfpel_refine`), after
a 2x upsample when the level changed.

A lean level (:func:`_match_level_lean`) replaces 1-4: edge-pad to
multiples of 8, warp the right image by the whole prediction with a
plain gather, so the residual window is uniform (base -K/2); census
both; ``fused_census_sgm`` (kernel ``fused_census_fwd``, then
``sgm_volume`` over the uint8 volume, folded into its int16 plane); plain WTA
on the int32 sums; and backmatching by a forward splat of the absolute
map (:func:`_roundtrip_check`).

On a CUDA tensor the whole match, levels and hole fill included, runs as
one CUDA graph once its key has been seen (:class:`PyramidGraphs`,
:func:`graph_key`): a key's first call runs eagerly, its second is
captured and replayed, and every later call copies its two images into
the graph's inputs and replays it, so the host issues none of the
pyramid's ~3,300 launches a frame. A CPU tensor, or ``plain=True``, runs
eagerly on every call.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
from typing import Optional

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.config.params import MatcherConfig
from i3dr_stereo_tpu_torch.config.profile import PyramidLevelConfig, SGMProfile
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.ops.block_gather import (
    block_anchors,
    block_shift_gather,
    block_shift_gather_plain,
    pad_edge,
)
from i3dr_stereo_tpu_torch.ops.census import census_transform_pair
from i3dr_stereo_tpu_torch.ops.fused_cost_sgm import fused_census_sgm
from i3dr_stereo_tpu_torch.ops.gauss_interp import gauss_interpolate
from i3dr_stereo_tpu_torch.ops.median import median3x3, median3x3_masked
from i3dr_stereo_tpu_torch.ops.occlusion import (detect_occlusions,
                                                 fill_occlusions)
from i3dr_stereo_tpu_torch.ops.resize import resize_nearest
from i3dr_stereo_tpu_torch.ops.sgm import DIRECTIONS_4, DIRECTIONS_8
from i3dr_stereo_tpu_torch.ops.sgm_fused_t import (
    census_sgm_wta,
    right_disparity_from_C,
)
from i3dr_stereo_tpu_torch.ops.speckle import speckle_filter
from i3dr_stereo_tpu_torch.ops.subpix import halfpel_refine
from i3dr_stereo_tpu_torch.ops.wls import wls_fill
from i3dr_stereo_tpu_torch.ops.wta import wta_disparity
from i3dr_stereo_tpu_torch.utils.metrics import _OFF
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS as METRICS


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 area downsample of (B, H, W): lane-pair sums, then row-pair
    sums, then x0.25 — the reference's summation order."""
    B, H, W = img.shape
    H2, W2 = H // 2 * 2, W // 2 * 2
    x = img[:, :H2, :W2]
    x = x.reshape(B, H2, W2 // 2, 2).sum(-1)
    x = x.reshape(B, H2 // 2, 2, W2 // 2).sum(2)
    return x * 0.25


def _upsample2_disp(d: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Upsample a disparity map to (H, W) and double its values."""
    return 2.0 * resize_nearest(d, H, W)


def profile_from_config(cfg: MatcherConfig) -> SGMProfile:
    """The quick-profile schedule with the flat config's census, penalty
    and filter values on every level (speckle on the finest level only)."""
    n = max(1, int(cfg.max_pyramid_level))
    levels = []
    for lv in range(n - 1, -1, -1):
        levels.append(PyramidLevelConfig(
            level=lv,
            enabled=True,
            subpix_pass=False,
            num_disparities=31,
            census_w=cfg.census_width,
            census_h=cfg.census_height,
            p1=(cfg.p1,) * 4,
            p2=(cfg.p2,) * 4,
            backmatch=cfg.backmatch_distance >= 0,
            backmatch_dist=(cfg.backmatch_distance
                            if cfg.backmatch_distance >= 0 else 0.0),
            median=cfg.median_filter,
            speckle=cfg.speckle_size > 0 and lv == 0,
            speckle_max_diff=cfg.speckle_range,
            speckle_max_region=cfg.speckle_size,
            subpixel=cfg.subpixel,
            interpolate_gaps=cfg.interp or cfg.interpolate_missing,
            interpolate_occlusions=cfg.occlusion_interp,
            occlusion_detection=cfg.occlusion_detection,
            prediction_shift=0.0,
            uniqueness_ratio=cfg.uniqueness_ratio,
            interpolator_mode="wls" if cfg.interp else "gauss",
        ))
    return SGMProfile(name="from_config", levels=tuple(levels))


def pyramid_sgm_match(left, right, cfg: MatcherConfig,
                      profile: Optional[SGMProfile] = None, *,
                      lean: bool = False,
                      plain: bool = False) -> MatchResult:
    """Full coarse-to-fine match of (H, W) or (B, H, W) images.

    ``lean=True`` takes the fused cost + SGM levels (module docstring);
    the default is the flagship branch. ``plain=True`` runs the kernels'
    plain torch twins on whatever device the images are on (the
    reference run on the card); by default a CPU tensor takes the twins
    and a CUDA tensor the kernels, captured as a CUDA graph at the key's
    second call and replayed from then on (:data:`GRAPHS`). The span
    ``pyramid.match`` says which of ``eager``, ``capture`` and
    ``replay`` the call was."""
    if profile is None:
        profile = profile_from_config(cfg)
    left, right = torch.as_tensor(left), torch.as_tensor(right)
    match = functools.partial(_match, cfg=cfg, profile=profile, lean=lean,
                              plain=plain)
    key = graph_key(left, right, cfg, profile, lean=lean, plain=plain)
    if key is None:
        with METRICS.span("pyramid.match", graph="eager"):
            return match(left, right)
    return GRAPHS.run(key, left, right, match)


def graph_key(left: torch.Tensor, right: torch.Tensor, cfg: MatcherConfig,
              profile: SGMProfile, *, lean: bool, plain: bool):
    """Everything the host reads to decide what a match launches and with
    which scalars: the device, both images' shapes and dtypes, the config
    (P1/P2, backmatch distance and speckle values reach the kernels by
    value), the profile and ``lean``. None where the call runs eagerly
    every time: ``plain``, or images that are not both on one CUDA
    device."""
    if plain or left.device.type != "cuda" or right.device != left.device:
        return None
    return (left.device, tuple(left.shape), left.dtype, tuple(right.shape),
            right.dtype, cfg, profile, bool(lean))


@dataclasses.dataclass(eq=False)
class _Captured:
    """One captured match: the graph, the static images it reads, the
    static result it writes, the kernel launches a replay makes and the
    bytes of the graph's memory pool that no live tensor holds (where a
    replay's intermediates live)."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    result: MatchResult
    launches: dict
    pool_free: int = 0


def _capture(match, left: torch.Tensor, right: torch.Tensor) -> _Captured:
    """Capture ``match`` of copies of the two images into a graph with a
    memory pool of its own. The kernels launched meanwhile stay counted in
    ``_build.LAUNCHES`` once, for the frame the capture serves. The pool's
    free bytes are what the capture reserved less what its result holds
    (the allocator's counts, on the host)."""
    inputs = (left.clone(), right.clone())
    before = dict(_build.LAUNCHES)
    dev = left.device
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        # counted inside: entering the capture empties the allocator's cache
        reserved, allocated = (torch.cuda.memory_reserved(dev),
                               torch.cuda.memory_allocated(dev))
        result = match(*inputs)
    launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                if n != before[k]}
    pool_free = ((torch.cuda.memory_reserved(dev) - reserved)
                 - (torch.cuda.memory_allocated(dev) - allocated))
    return _Captured(graph, inputs, result, launches, max(pool_free, 0))


GRAPH_KEYS = 4   # the keys a PyramidGraphs holds, captured or not


class PyramidGraphs:
    """The matches captured as CUDA graphs, :data:`GRAPH_KEYS` keys at
    most (:func:`graph_key`), the least recently used dropped first with
    its graph's memory pool.

    A key's first call runs eagerly: lazily loaded modules load, the
    device tables the ops cache are built and the allocator fills, all
    outside any capture. Its second call is captured and replayed; every
    later call copies the two images into the graph's inputs (two copies
    on the device) and replays. Each call returns clones of the graph's
    outputs, so a result held across the next replay keeps its values,
    and adds the captured launches to ``_build.LAUNCHES``, so a replayed
    frame counts what an eager one does. A changed config is a new key:
    one eager frame, one captured, then replays. A key whose eager call
    raises is forgotten, so it is never captured.

    Each call runs under the span ``span`` (``graph``: the stage). On a
    CUDA device it counts ``held_bytes``: what the allocator holds for
    tensors at its end, and from the capture on the free bytes of the
    graph's pool too, which the graph keeps for its intermediates."""

    def __init__(self, span: str = "pyramid.match"):
        self.span = span
        self._held = collections.OrderedDict()  # key -> _Captured or None
        self._lock = threading.Lock()

    def keys(self) -> list:
        """The keys held, least recently used first."""
        return list(self._held)

    def stage(self, key) -> str:
        """``eager``, ``capture`` or ``replay``: what the call of ``key``
        does. The key becomes the most recently used; keys beyond
        :data:`GRAPH_KEYS` go, least recently used first."""
        if key in self._held:
            self._held.move_to_end(key)
            stage = "capture" if self._held[key] is None else "replay"
        else:
            self._held[key] = None
            stage = "eager"
        while len(self._held) > GRAPH_KEYS:
            _, old = self._held.popitem(last=False)
            if old is not None:
                old.graph.reset()
        return stage

    def run(self, key, left: torch.Tensor, right: torch.Tensor,
            match) -> MatchResult:
        """``match(left, right)`` for ``key``: eagerly, captured, or
        replayed (class docstring)."""
        with self._lock:
            stage = self.stage(key)
            with METRICS.span(self.span, graph=stage) as span:
                pool_free = 0
                if stage == "eager":
                    try:
                        res = match(left, right)
                    except BaseException:
                        del self._held[key]
                        raise
                else:
                    if stage == "capture":
                        cap = self._held[key] = _capture(match, left, right)
                    else:
                        cap = self._held[key]
                        cap.inputs[0].copy_(left)
                        cap.inputs[1].copy_(right)
                        for k, n in cap.launches.items():
                            _build.LAUNCHES[k] += n
                    cap.graph.replay()
                    valid = cap.result.valid
                    res = MatchResult(
                        disparity=cap.result.disparity.clone(),
                        valid=None if valid is None else valid.clone())
                    pool_free = cap.pool_free
                if span is not _OFF and left.device.type == "cuda":
                    span.set(held_bytes=torch.cuda.memory_allocated(
                        left.device) + pool_free)
                return res


GRAPHS = PyramidGraphs()


def _match(left: torch.Tensor, right: torch.Tensor, *, cfg: MatcherConfig,
           profile: SGMProfile, lean: bool, plain: bool) -> MatchResult:
    """The match itself, eagerly: what a capture records."""
    batched = left.ndim == 3
    l = (left if batched else left[None]).to(torch.float32)
    r = (right if batched else right[None]).to(torch.float32)
    B, H, W = l.shape

    passes = profile.enabled_levels
    if not passes:
        raise ValueError("profile has no enabled pyramid levels")
    # clamp levels to what the image size supports (coarsest >= ~32 px)
    max_by_size = max(0, min(H, W).bit_length() - 6)
    passes = [dataclasses.replace(p, level=min(p.level, max_by_size))
              for p in passes]
    deepest = max(p.level for p in passes)

    pyr_l, pyr_r = [l], [r]
    for _ in range(deepest):
        pyr_l.append(_downsample2(pyr_l[-1]))
        pyr_r.append(_downsample2(pyr_r[-1]))

    n_dirs = 4 if cfg.num_directions == 4 else 8
    dirs = DIRECTIONS_4 if n_dirs == 4 else DIRECTIONS_8
    disp = valid = cur_level = None
    for p in passes:
        with METRICS.span("pyramid.level", level=p.level):
            ll, rr = pyr_l[p.level], pyr_r[p.level]
            Bh, Hh, Wh = ll.shape
            if p.subpix_pass:
                if disp is None:
                    continue
                if cur_level != p.level:
                    disp = _upsample2_disp(disp, Hh, Wh)
                    cur_level = p.level
                    valid = None
                disp = halfpel_refine(ll, rr, disp,
                                      torch.ones_like(disp, dtype=torch.bool),
                                      step_size=p.step_size)
                continue
            # odd profile count -> even window
            K = max(8, p.num_disparities + 1)
            pens = tuple((p.p1[min(i, 3)], p.p2[min(i, 3)])
                         for i in range(n_dirs))
            if disp is None:
                base_val = int(round(cfg.min_disparity / (2 ** p.level)
                                     + p.prediction_shift))
                pred_int = None
            else:
                pred = disp
                while cur_level > p.level:
                    pred = _upsample2_disp(pred, pyr_l[cur_level - 1].shape[1],
                                           pyr_l[cur_level - 1].shape[2])
                    cur_level -= 1
                pred = median3x3(pred)
                pred_int = torch.round(pred).to(torch.int32).clamp(0, Wh - 1)
                base_val = 0
            level_kw = dict(subpixel=(p.level == 0 and p.subpixel),
                            uniqueness_ratio=p.uniqueness_ratio, plain=plain)
            if lean:
                disp, valid = _match_level_lean(
                    ll, rr, pred_int, base_val, K, pens, dirs,
                    (p.census_h, p.census_w), **level_kw)
            else:
                disp, valid, bm = _match_level_fused_t(
                    ll, rr, pred_int, base_val, K, pens, n_dirs,
                    (p.census_h, p.census_w), want_backmatch=p.backmatch,
                    **level_kw)
            cur_level = p.level
            # matched right column must land inside the image
            xs = torch.arange(Wh, dtype=torch.int32, device=disp.device)
            rcol = xs - torch.round(disp).to(torch.int32)
            valid = valid & (rcol >= 0) & (rcol < Wh)
            if p.backmatch and lean:
                valid = _roundtrip_check(disp, valid, p.backmatch_dist)
            elif p.backmatch:
                valid = _backmatch_check_true(valid, bm, p.backmatch_dist, K,
                                              plain=plain)
            if p.speckle and p.speckle_max_region > 0:
                valid = speckle_filter(disp, valid,
                                       max_size=p.speckle_max_region,
                                       max_diff=p.speckle_max_diff,
                                       downsample=cfg.speckle_downsample,
                                       plain=plain)
            if p.occlusion_detection:
                occ = detect_occlusions(disp, valid)
                if p.interpolate_occlusions:
                    disp, valid = fill_occlusions(disp, valid, occ)
                else:
                    valid = valid & ~occ
            if p.median:
                disp = median3x3_masked(disp, valid)
            if p.level != 0:
                disp = torch.where(valid, disp, median3x3(disp))
            elif p.interpolate_gaps:
                disp, valid = _fill_gaps(p, disp, valid, ll, plain=plain)

    # bring the estimate to full resolution if the finest enabled level
    # was coarser than 0
    while cur_level > 0:
        Hn, Wn = pyr_l[cur_level - 1].shape[1:]
        disp = _upsample2_disp(disp, Hn, Wn)
        valid = resize_nearest(valid, Hn, Wn)
        cur_level -= 1

    if not batched:
        # valid is None where a subpix pass changed the level last, as in
        # the reference
        disp, valid = disp[0], None if valid is None else valid[0]
    return MatchResult(disparity=disp, valid=valid)


def _fill_gaps(p: PyramidLevelConfig, disp, valid, ll, *, plain: bool):
    """Hole filling by the level's "Interpolator Mode": the engine's
    32-direction Gauss interpolator (quick.param:111-117) or the WLS
    diffusion of the flat config's ``interp``."""
    if p.interpolator_mode == "gauss":
        return gauss_interpolate(disp, valid,
                                 n_directions=p.interp_directions,
                                 min_elements=p.interp_min_elements,
                                 plain=plain)
    return wls_fill(disp, valid, ll, plain=plain)


def _float32(v) -> float:
    """``v`` rounded to float32, as a Python float: a float32 tensor
    compares with it in float32, as with a float32 tensor of ``v``, and
    nothing is copied to the device."""
    return float(np.float32(v))


def _ceil_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _match_level_fused_t(ll, rr, pred_int, base_val: int, K: int, pens,
                         num_directions: int, census_hw, *, subpixel: bool,
                         uniqueness_ratio=0.0, want_backmatch: bool = False,
                         plain: bool = False):
    """One pyramid level: block-anchor warp, census, cost + SGM + WTA.
    Returns (absolute disparity, valid, backmatch_info) where
    backmatch_info = (residual disparity, its validity, d_right,
    valid_right, bpm) on the padded grid, or None."""
    gather = block_shift_gather_plain if plain else block_shift_gather
    B, Hh, Wh = ll.shape
    K8 = _ceil_to(max(K, 8), 8)
    Hp, Wp = _ceil_to(Hh, 128), _ceil_to(Wh, 128)
    llp = pad_edge(ll, Hp, Wp).contiguous()
    rrp = pad_edge(rr, Hp, Wp).contiguous()

    if pred_int is None:
        rw = rrp
        bpm = int(base_val)
        offset = float(base_val)
    else:
        pred_p = pad_edge(pred_int, Hp, Wp)
        q = block_anchors(pred_p)
        q_up = q.repeat_interleave(8, 1).repeat_interleave(128, 2)
        pred_eff = torch.minimum(torch.maximum(pred_p, q_up - K8 // 2),
                                 q_up + K8 // 2).contiguous()
        rw = gather(rrp, pred_eff, q, K8 // 2)
        bpm = -(K8 // 2)
        offset = (pred_eff[:, :Hh, :Wh] + bpm).to(torch.float32)

    ch, cw = census_hw
    cl, cr = census_transform_pair(llp, rw, ch, cw, plain=plain)
    disp_p, C = census_sgm_wta(cl, cr, K8, bpm=bpm, W_real=Wh, H_real=Hh,
                               pens=pens, directions=num_directions,
                               subpixel=subpixel,
                               uniqueness_ratio=uniqueness_ratio, plain=plain)
    disp_res = disp_p[:, :Hh, :Wh]
    valid = disp_res > -1.0e8
    disp = torch.where(valid, disp_res, float(K8 // 2)) + offset
    bm = None
    if want_backmatch:
        valid_p = disp_p > -1.0e8
        r_res = torch.where(valid_p, disp_p + float(bpm), 0.0)
        d_r, v_r = right_disparity_from_C(C, bpm, Wh)
        bm = (r_res, valid_p, d_r, v_r, bpm)
    return disp, valid, bm


def _backmatch_check_true(valid, bm, max_diff, K: int, *,
                          plain: bool = False):
    """LR check against the right-anchored match of the level's own cost
    volume ("Compute Backmatching" + "Maximum Backmatching Distance",
    ini/quick.param:121-122), in warped (residual) space: left pixel x
    matched right pixel x - r(x) is consistent iff
    |r(x) - d_R(x - round(r(x)))| <= max_diff. The gather anchor is the
    constant window midpoint, so radius K8//2 + 1 covers every residual."""
    gather = block_shift_gather_plain if plain else block_shift_gather
    r_res, valid_p, d_r, v_r, bpm = bm
    B, Hh, Wh = valid.shape
    _, Hp, Wp = r_res.shape
    K8 = _ceil_to(max(K, 8), 8)
    rr_int = torch.round(r_res).to(torch.int32)     # in [bpm, bpm + K8]
    q = torch.full((B, Hp // 8, (Wp + 127) // 128), int(bpm) + K8 // 2,
                   dtype=torch.int32, device=r_res.device)
    d_r_m = torch.where(v_r, d_r, 1.0e9)            # invalid right -> fail
    d_at = gather(d_r_m, rr_int, q, K8 // 2 + 1)[:, :Hh, :Wh]
    xs = torch.arange(Wh, dtype=torch.int32, device=r_res.device)
    xw = xs - rr_int[:, :Hh, :Wh]
    in_w = (xw >= 0) & (xw < Wh)
    consistent = (d_at - r_res[:, :Hh, :Wh]).abs() <= _float32(max_diff)
    return valid & in_w & consistent


def _match_level_lean(ll, rr, pred_int, base_val: int, K: int, pens, dirs,
                      census_hw, *, subpixel: bool, uniqueness_ratio=0.0,
                      plain: bool = False):
    """One lean pyramid level: the right image warped by the whole
    prediction (a plain gather of ``clip(x - pred, 0, W-1)``), so the
    residual window is the uniform ``-(K // 2)``; the coarsest level is
    unwarped and searches from ``base_val``. Census on the images
    edge-padded to multiples of 8, the fused cost + SGM with int16
    partials, plain WTA. Returns (absolute disparity, valid)."""
    B, Hh, Wh = ll.shape
    if pred_int is None:
        rw = rr
        fused_base = int(base_val)
        offset = float(base_val)
    else:
        xs = torch.arange(Wh, dtype=torch.int64, device=ll.device)
        rw = rr.gather(2, (xs - pred_int).clamp(0, Wh - 1))
        fused_base = -(K // 2)
        offset = (pred_int + fused_base).to(torch.float32)
    H8, W8 = _ceil_to(Hh, 8), _ceil_to(Wh, 8)
    ch, cw = census_hw
    cl, cr = census_transform_pair(pad_edge(ll, H8, W8),
                                   pad_edge(rw, H8, W8), ch, cw, plain=plain)
    S, C = fused_census_sgm(cl, cr, K, base=fused_base,
                            per_direction_penalties=pens, directions=dirs,
                            out_dtype=torch.int16, plain=plain)
    S, C = S[:, :Hh, :Wh], C[:, :Hh, :Wh]
    dk, ok = wta_disparity(S, 0, uniqueness_ratio=uniqueness_ratio,
                           subpixel=subpixel)
    return dk + offset, ok & (C.amin(-1) < 255)


def _roundtrip_check(disp: torch.Tensor, valid: torch.Tensor, max_diff):
    """Backmatching on the absolute map through an exact forward-splat
    right map (the engine's "Compute Backmatching"): the right view's
    disparity at column xr is the largest disparity of any left pixel
    landing there (the nearest surface wins), and pixel x is consistent
    iff |d_R(x - round(d)) - d(x)| <= max_diff. The splat is a
    scatter-max, so it does not depend on the order of the writes."""
    W = disp.shape[-1]
    d_int = torch.round(disp).to(torch.int64)
    xr = torch.arange(W, dtype=torch.int64, device=disp.device) - d_int
    in_img = (xr >= 0) & (xr < W)
    xr_c = xr.clamp(0, W - 1)
    src = torch.where(valid & in_img, disp, -1.0e9)
    d_right = torch.full_like(disp, -1.0e9).scatter_reduce_(
        2, xr_c, src, "amax", include_self=True)
    consistent = (d_right.gather(2, xr_c) - disp).abs() <= _float32(max_diff)
    return valid & in_img & consistent
