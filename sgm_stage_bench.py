#!/usr/bin/env python3
"""The flagship SGM stage, the census-cost kernels, the volume SGM
aggregation, the speckle filter, the BT forward pass, the row gather, the
post-match kernels, both flagship frames, the SGBM frames, the
post-match frames and the mapping path's ICP of one or more checkouts of
the PyTorch + CUDA port, measured in turns on one NVIDIA GPU.

    python3 sgm_stage_bench.py [--only SECTION,...] [ROOT ...]

Each ROOT is a directory that holds an ``i3dr_stereo_tpu_torch`` package
(this checkout when none is given). To compare a change with its parent,
unpack the parent beside the change (``git archive <commit> | tar -x -C
DIR``) and name the roots in turns: ``DIR . . DIR``. Every ROOT runs in a
process of its own, builds its own kernels and prints one JSON line; the
scene, the level-0 inputs, the timing and the profile window are
``chip_smoke.py``'s of this checkout, so only the package differs.

Per ROOT, with the card's name and power limit, in fourteen sections
(``--only`` names those to run, comma-separated; all by default):

- ``level0``: level 0 of the flagship pyramid (2448x2048 padded to
  2560x2048, D = 32, 4 paths): ``census_cost`` alone and
  ``census_sgm_wta`` whole (CUDA events, median of 10), their difference
  (the SGM stage, whatever kernels the checkout runs it in), and the
  peak memory of one call above what was allocated before it;
- ``lean_level0``: level 0 of the lean pyramid (2448x2048, D = 32, base
  -16): ``fused_census_fwd`` with float32 path costs (median of 10) and
  a digest of its C and S; ``fused_census_sgm`` whole there (4 paths,
  the int16 mode the lean frame runs): ms (median of 10) and a digest of
  its S and C;
- ``sgbm_aggregate``: ``sgm_aggregate`` at the SGBM frame's shape
  (1x1024x1280x128 float32 costs from a seed, 8 paths, P1/P2 200/400):
  ms (median of 10), the peak memory of one call above what was
  allocated before it, a digest of S;
- ``speckle``: ``speckle_keep`` on the flagship frame's level-0
  disparities after the downsample-2 front-end (1224x1024, S = 25): ms
  (median of 10) and a digest of the keep-mask;
- ``bt_fwd``: ``fused_bt_horizontal`` (K) at the lean window-1 SGBM
  frame's shape (1x1024x1280x128, that frame's prefiltered scene, base
  0, P1/P2 400/800 in doubled units), int16 and float32 path costs: ms
  (median of 10), ms a call of 10 back to back
  (``chip_smoke.back_to_back_ms``) and a digest of C and S in each mode;
- ``row_gather``: ``block_shift_gather`` (E) at level 0 of the flagship
  pyramid: the warp of the right image (radius 16) and the backmatch
  lookup (radius 17, on level 0's right-anchored disparities): ms (median
  of 10), ms a call of its C entry 50 back to back (the wrapper's host
  work outlasts the kernel) and a digest of both outputs;
- ``census``: the census transform of level 0's two images (the left
  image and the right one warped by the row gather, 2048x2560, 9x9)
  through ``census_transform_pair`` (``census_transform`` on each image
  where the checkout has no pair entry: the plain torch transform before
  the kernel): ms (median of 10), ms a call of 20 back to back and a
  digest of the words;
- ``remap``: ``rectify_pair`` at 2448x2048 uint8 cubic on
  ``chip_smoke.py``'s distorted rig: ms (median of 10), ms a call of 20
  back to back and a digest of both outputs;
- ``frames``: the flagship frame, the lean flagship frame (raw uint8 ->
  rectify -> pyramid with speckle -> depth, cloud, crop), the SGBM frame
  (``accuracy_bench.py``'s 1280x1024 scene and config) and that frame at
  window 1 through ``lean=True`` (the BT forward pass): ms/frame (median
  of 10), peak memory, ``chip_smoke.py``'s five-frame profile (device
  busy, idle share, device activities a frame, the census-cost kernels',
  the census transform's, the remap's, the volume SGM kernels' and the
  BT forward pass's time a frame) and a digest of the disparity and
  valid mask;
- ``gauss``: ``gauss_interpolate`` (32 directions, radius 64) on the
  flagship frame's level-0 disparities and valid mask, as
  ``chip_smoke.py:phase_postmatch`` makes them: ms (median of 10), ms a
  call of 10 back to back, a digest of both outputs; and back to back on
  two halves of its holes: those of the left border band (the columns
  left of the first one with fewer than half its pixels holes; holes
  wider than the radius) and the rest (scattered holes), with each
  half's hole count;
- ``wls``: ``thomas_lines`` of the WLS fill's first pass (lam = 3047.6)
  on that frame's mask, guide and disparities at 2448x2048, horizontal
  and vertical: ms (median of 10), ms a call of 10 back to back, a
  digest, the largest difference from a float64 Thomas solve of the
  same system on the card; one line of 2448 alone and 64 such lines
  (the chain); ``wls_fill`` whole (6 launches);
- ``bp``: ``bp_iterate`` one iteration at the BP frame's level 0
  (1x1024x1280x128, that frame's data cost, messages from a seed): ms
  (median of 5), ms a call of 10 back to back and a digest of the
  messages; the BP and the CSBP frame (``chip_smoke.py:bp_pipe``: the
  SGBM frame's scene and rig, raw uint8, the BP / CSBP defaults at 128
  disparities): ms/frame (median of 5), the five-frame profile (busy,
  idle share, activities, ``bp_messages`` and ``bp_planes`` time a
  frame) and a digest of the disparity and valid mask;
- ``icp``: the ICP of ``chip_smoke.py``'s moving rig (frames 0 and 1 at
  2448x2048, packed by the checkout's ``pack_maps`` into 3 levels): one
  ``icp_step`` call at each level (ms by events, median of 10, and a
  call of 50 back to back), a whole track on the ready maps (4 / 7 / 10
  steps, ``_track``: by events, median of 10, and a track of 20 back to
  back), the host's time to issue a step call and a track call (no sync
  among 200), sum w of the first level-0 step from the identity (held
  equal across roots: the same pixels pair), a digest of the track's
  state (reported, not held equal: the sums' order is the kernel's),
  ``pack_maps`` of a frame already on the card (ms by events, median of
  10) and ``DepthOdometry.track`` over the rig's 10 frames forward, back
  and forward again with numpy depth in (ms a frame by events, the median
  of the 29 tracked);
- ``postmatch_frames``: the engine facade at ``quick_profile()``
  (rectified float32 in) and the flagship frame with ``interp``,
  occlusion detection and fill: ms/frame (median of 10), the five-frame
  profile (busy, idle share, activities, ``gauss_rays`` and
  ``wls_lines`` time a frame) and a digest of the disparity and valid
  mask.

The last line says whether all roots gave the same digests. The WLS
digests (``wls_digest``, ``interp_frame_digest``) are reported beside
it, not held equal: a redesign of the line solve may round differently,
and ``wls_f64_err_*`` says how far each root is from the float64
solve.

Every entry point is called with its device (``device="cuda"``), so a
checkout whose defaults differ is measured on the card all the same.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the census-cost kernels' names in a profile: census_cost, and the fused
# census forward pass in any of its kernels
CENSUS_SYMBOLS = ("census_cost_kernel", "census32_kernel", "CensusCost",
                  "census_fwd_kernel")
# the volume SGM kernels' names: the per-direction kernel and the sum pass
# a parent may have
VOLUME_SYMBOLS = ("sgm_volume_kernel", "sgm_volume_sum_kernel")
# the BT forward pass: its kernel, or a parent's census-or-BT kernel at BT
BT_SYMBOLS = ("bt_fwd_kernel", "BtCost")
# the census transform's kernels (a parent without them runs it in plain
# torch: elementwise kernels no symbol here names)
TRANSFORM_SYMBOLS = ("census_fixed_kernel", "census_any_kernel")
REMAP_SYMBOLS = ("remap_kernel",)
POSTMATCH_SYMBOLS = {"gauss": "gauss_rays", "wls": "wls_lines"}
# BP's kernels: every instance of bp_messages (one kernel in a parent,
# bp_messages_kernel) and bp_planes
BP_SYMBOLS = {"bp_messages": "bp_messages_", "bp_planes": "bp_planes_"}
SECTIONS = ("level0", "lean_level0", "sgbm_aggregate", "speckle", "bt_fwd",
            "row_gather", "census", "remap", "frames", "gauss", "wls",
            "postmatch_frames", "bp", "icp")
DIGESTS = ("frame_digest", "lean_frame_digest", "sgbm_frame_digest",
           "lean_sgbm1_frame_digest", "level0_digest", "lean_level0_digest",
           "lean_level0_sgm_digest", "sgbm_aggregate_digest",
           "speckle_digest", "bt_fwd_int16_digest", "bt_fwd_float32_digest",
           "row_gather_digest", "census_digest", "remap_digest",
           "gauss_digest", "facade_frame_digest", "bp_messages_digest",
           "bp_frame_digest", "csbp_frame_digest", "icp_pairs_digest")
# reported, not held equal across roots (see the docstring)
ROUNDING_DIGESTS = ("wls_digest", "interp_frame_digest", "icp_track_digest")


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def measure(root: Path, sections) -> dict:
    sys.path.insert(0, str(root))
    import torch

    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import speckle as sp

    card = cs.card_line()
    _build.library()
    cfg = cs.flagship_cfg(params)
    sc = layered_scene(cs.H_FULL, cs.W_FULL, **cs.SCENE)
    out = {"root": str(root), "card": card}

    if "level0" in sections:
        level0(out, cs, cfg, sc)
    if "lean_level0" in sections:
        lean_level0(out, cs, cfg, sc)
    if "sgbm_aggregate" in sections:
        sgbm_aggregate(out, cs)
    if "speckle" in sections:
        # the speckle filter at the flagship frame's ds2 shape
        _, _, _, (dd, vv, S2, md2) = cs.speckle_inputs(sc, cfg)
        keep = lambda: sp.speckle_keep(dd, vv, S2, md2)
        out["speckle_ms"] = cs.gpu_ms(keep)
        out["speckle_digest"] = digest(keep())
        del dd, vv
        torch.cuda.empty_cache()
    if "bt_fwd" in sections:
        bt_fwd(out, cs)
    if "row_gather" in sections:
        row_gather(out, cs, cfg, sc)
    if "census" in sections:
        census(out, cs, cfg, sc)
    if "remap" in sections:
        remap(out, cs)
    if "frames" in sections:
        frames(out, cs, card, root.name)
    if "gauss" in sections or "wls" in sections:
        l, d, v = postmatch_inputs(cs, cfg, sc)
        if "gauss" in sections:
            gauss(out, cs, d, v)
        if "wls" in sections:
            wls_lines(out, cs, l, d, v)
        del l, d, v
        torch.cuda.empty_cache()
    if "postmatch_frames" in sections:
        postmatch_frames(out, cs, card, root.name)
    if "bp" in sections:
        bp(out, cs, card, root.name)
    if "icp" in sections:
        icp(out, cs)
    return out


def level0(out, cs, cfg, sc):
    """Level 0 as the pyramid builds it: census_cost and the SGM stage."""
    import torch
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops import sgm_fused_t as sf
    from i3dr_stereo_tpu_torch.ops.census import census_transform

    _, lp, rp, pred, q, bpm, Hh, Wh = next(cs.flagship_levels(cfg, sc))
    rw = bg.block_shift_gather(rp, pred, q, 16)
    cl = census_transform(lp, cfg.census_height, cfg.census_width)
    cr = census_transform(rw, cfg.census_height, cfg.census_width)
    del lp, rp, rw, pred
    kw = dict(bpm=bpm, H_real=Hh, W_real=Wh)
    skw = dict(pens=[(cfg.p1, cfg.p2)] * 4, directions=4, subpixel=True,
               uniqueness_ratio=cfg.uniqueness_ratio, **kw)
    out["census_cost_ms"] = cs.gpu_ms(lambda: sf.census_cost(cl, cr, 32, **kw))
    out["census_sgm_wta_ms"] = cs.gpu_ms(
        lambda: sf.census_sgm_wta(cl, cr, 32, **skw))
    out["stage_ms"] = out["census_sgm_wta_ms"] - out["census_cost_ms"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d, _ = sf.census_sgm_wta(cl, cr, 32, **skw)
    torch.cuda.synchronize()
    out["level0_peak_gib"] = (torch.cuda.max_memory_allocated()
                              - before) / 2**30
    out["level0_digest"] = digest(d)
    del d
    del cl, cr
    torch.cuda.empty_cache()


def lean_level0(out, cs, cfg, sc):
    """Level 0 of the lean pyramid: J alone and fused_census_sgm whole."""
    import torch
    from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs

    _, cl, cr, base, _, _ = next(cs.lean_levels(cfg, sc))
    clw, crw = fcs.census_word_planes(cl), fcs.census_word_planes(cr)
    H8 = cl.shape[1]
    bases = torch.full((H8 // fcs.row_tile(H8),), base, dtype=torch.int32,
                       device=cs.DEVICE)
    fused = lambda: fcs.fused_census_horizontal(
        clw, crw, bases, 32, cfg.p1, cfg.p2, out_dtype=torch.float32)
    out["fused_census_fwd_ms"] = cs.gpu_ms(fused)
    out["lean_level0_digest"] = digest(*fused())
    del clw, crw
    sgm_call = lambda: fcs.fused_census_sgm(
        cl, cr, 32, base=base, per_direction_penalties=[(cfg.p1, cfg.p2)] * 4,
        directions=((0, 1), (0, -1), (1, 0), (-1, 0)))
    out["lean_level0_sgm_ms"] = cs.gpu_ms(sgm_call)
    out["lean_level0_sgm_digest"] = digest(*sgm_call())
    del cl, cr
    torch.cuda.empty_cache()


def sgbm_aggregate(out, cs):
    """The SGBM aggregation: float32 costs from a seed, 8 paths."""
    import torch
    from i3dr_stereo_tpu_torch.ops import sgm

    rng = torch.Generator(device=cs.DEVICE).manual_seed(7)
    C = torch.rand((1, cs.H_SGBM, cs.W_SGBM, 128), generator=rng,
                   device=cs.DEVICE) * 60
    C[torch.rand(C.shape, generator=rng, device=cs.DEVICE) < 0.03] = 1e9
    agg = lambda: sgm.sgm_aggregate(C, 200.0, 400.0, sgm.DIRECTIONS_8)
    out["sgbm_aggregate_ms"] = cs.gpu_ms(agg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["sgbm_aggregate_digest"] = digest(agg())
    out["sgbm_aggregate_peak_gib"] = (torch.cuda.max_memory_allocated()
                                      - before) / 2**30
    del C
    torch.cuda.empty_cache()


def bt_fwd(out, cs):
    """K at the lean window-1 SGBM frame's shape, both modes."""
    import torch
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs
    from i3dr_stereo_tpu_torch.ops.cost import xsobel_prefilter

    ssc = layered_scene(cs.H_SGBM, cs.W_SGBM, **cs.SGBM_SCENE)
    lp, rp = (xsobel_prefilter(torch.tensor(cs.raw_u8(img), device=cs.DEVICE)
                               .float()[None], 31).contiguous()
              for img in (ssc.left, ssc.right))
    base = torch.zeros((cs.H_SGBM // fcs.row_tile(cs.H_SGBM),),
                       dtype=torch.int32, device=cs.DEVICE)
    for od in (torch.int16, torch.float32):
        call = lambda: fcs.fused_bt_horizontal(lp, rp, base, 128, 400.0,
                                               800.0, out_dtype=od)
        name = str(od)[6:]
        out[f"bt_fwd_{name}_ms"] = cs.gpu_ms(call)
        out[f"bt_fwd_{name}_b2b_ms"] = cs.back_to_back_ms(call, iters=10)
        out[f"bt_fwd_{name}_digest"] = digest(*call())
    del lp, rp
    torch.cuda.empty_cache()


def row_gather(out, cs, cfg, sc):
    """E at level 0 of the flagship pyramid: the warp and the backmatch
    lookup, as the pyramid makes them."""
    import torch
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops import sgm_fused_t as sf
    from i3dr_stereo_tpu_torch.ops.census import census_transform

    _, lp, rp, pred, q, bpm, Hh, Wh = next(cs.flagship_levels(cfg, sc))
    warp = lambda: bg.block_shift_gather(rp, pred, q, 16)
    out["row_gather_warp_ms"] = cs.gpu_ms(warp)
    rw = warp()
    out["row_gather_warp_b2b_ms"] = cs.back_to_back_ms(
        cs.row_gather_entry(rp, pred, q, 16, torch.empty_like(rp)))
    cl = census_transform(lp, cfg.census_height, cfg.census_width)
    cr = census_transform(rw, cfg.census_height, cfg.census_width)
    d, C = sf.census_sgm_wta(cl, cr, 32, bpm=bpm, H_real=Hh, W_real=Wh,
                             pens=[(cfg.p1, cfg.p2)] * 4, directions=4,
                             subpixel=True,
                             uniqueness_ratio=cfg.uniqueness_ratio)
    del cl, cr
    # the lookup as matchers/pyramid.py:_backmatch_check_true makes it
    d_r, v_r = sf.right_disparity_from_C(C, bpm, Wh)
    src = torch.where(v_r, d_r, 1.0e9).contiguous()
    idx = torch.round(torch.where(d > -1e8, d + float(bpm), 0.0)).to(
        torch.int32).contiguous()
    qb = torch.full(q.shape, bpm + 16, dtype=torch.int32, device=cs.DEVICE)
    lookup = lambda: bg.block_shift_gather(src, idx, qb, 17)
    out["row_gather_backmatch_ms"] = cs.gpu_ms(lookup)
    out["row_gather_backmatch_b2b_ms"] = cs.back_to_back_ms(
        cs.row_gather_entry(src, idx, qb, 17, torch.empty_like(src)))
    out["row_gather_digest"] = digest(rw, lookup())
    del C, lp, rp, rw, src, idx
    torch.cuda.empty_cache()


def census(out, cs, cfg, sc):
    """The census transform of level 0's two images, as the pyramid makes
    them."""
    import torch
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops import census as ce

    _, lp, rp, pred, q, _, _, _ = next(cs.flagship_levels(cfg, sc))
    rw = bg.block_shift_gather(rp, pred, q, 16)
    hw = (cfg.census_height, cfg.census_width)
    pair = getattr(ce, "census_transform_pair", None)
    call = ((lambda: pair(lp, rw, *hw)) if pair else
            (lambda: (ce.census_transform(lp, *hw),
                      ce.census_transform(rw, *hw))))
    out["census_ms"] = cs.gpu_ms(call)
    out["census_b2b_ms"] = cs.back_to_back_ms(call, iters=20)
    out["census_digest"] = digest(*call())
    del lp, rp, rw, pred
    torch.cuda.empty_cache()


def remap(out, cs):
    """Both cameras of the distorted rig through rectify_pair."""
    import numpy as np
    import torch
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.ops import rectify

    rig = cs.distorted_rig(camera)
    ml, mr = (rectify.make_rectify_map(c, device=cs.DEVICE)
              for c in (rig.left, rig.right))
    rng = np.random.default_rng(5)
    sl, sr = (torch.tensor(rng.integers(0, 256, (cs.H_FULL, cs.W_FULL),
                                        dtype=np.uint8), device=cs.DEVICE)
              for _ in range(2))
    call = lambda: rectify.rectify_pair(sl, sr, ml, mr)
    out["remap_pair_ms"] = cs.gpu_ms(call)
    out["remap_pair_b2b_ms"] = cs.back_to_back_ms(call, iters=20)
    out["remap_digest"] = digest(*call())


def frames(out, cs, card, label):
    """The flagship frame, the lean flagship frame, the SGBM frame and the
    lean window-1 SGBM frame."""
    import torch
    from i3dr_stereo_tpu_torch import _build

    for name, make in (("frame", cs.flagship_pipe),
                       ("lean_frame", lambda: cs.flagship_pipe(lean=True)),
                       ("sgbm_frame", cs.sgbm_pipe),
                       ("lean_sgbm1_frame",
                        lambda: cs.sgbm_pipe(window_size=1, lean=True))):
        pipe, left, right, sc, cfg, _ = make()
        torch.cuda.reset_peak_memory_stats()
        res = cs.drive_frame(pipe, left, right, sc, (), f"{label} {name}",
                             {})
        out[f"{name}_launches"] = dict(_build.LAUNCHES)
        out[f"{name}_digest"] = digest(res.disparity, res.valid)
        out[f"{name}_ms"] = cs.gpu_ms(lambda: pipe.process(left, right),
                                      iters=10, warmup=1)
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        prof = cs.phase_profile(pipe, left, right, card,
                                label=f"{label} {name}")
        out[f"{name}_busy_ms"] = prof["busy_ms"]
        out[f"{name}_idle_share"] = prof["idle_share"]
        out[f"{name}_activities"] = prof["activities"]
        for key, symbols in (("census", CENSUS_SYMBOLS),
                             ("transform", TRANSFORM_SYMBOLS),
                             ("remap", REMAP_SYMBOLS),
                             ("volume", VOLUME_SYMBOLS), ("bt", BT_SYMBOLS)):
            out[f"{name}_{key}_kernels_ms"] = sum(
                ms for k, ms in prof["names_ms"].items()
                if any(sym in k for sym in symbols))
        del pipe, res
        torch.cuda.empty_cache()


def postmatch_inputs(cs, cfg, sc):
    """The flagship frame's level-0 result, as phase_postmatch makes it:
    (left image (1, H, W), disparities, valid mask)."""
    import torch
    from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match

    l = torch.tensor(sc.left, device=cs.DEVICE)[None]
    r = torch.tensor(sc.right, device=cs.DEVICE)[None]
    res = pyramid_sgm_match(l, r, cfg)
    return l, res.disparity.contiguous(), res.valid.contiguous()


def gauss(out, cs, d, v):
    """The Gauss fill at level 0, whole and on two halves of its holes."""
    import torch
    from i3dr_stereo_tpu_torch.ops import gauss_interp as gi

    call = lambda: gi.gauss_interpolate(d, v)
    out["gauss_ms"] = cs.gpu_ms(call)
    out["gauss_b2b_ms"] = cs.back_to_back_ms(call, iters=10)
    out["gauss_digest"] = digest(*call())
    # the left border band: columns left of the first with fewer than
    # half its pixels holes
    col_holes = (~v[0]).float().mean(0)
    band = int(torch.nonzero(col_holes < 0.5)[0, 0])
    x = torch.arange(v.shape[-1], device=v.device)
    out["gauss_band_columns"] = band
    for name, keep in (("band", x < band), ("scattered", x >= band)):
        vv = (v | ~keep).contiguous()
        out[f"gauss_{name}_holes"] = int((~vv).sum())
        out[f"gauss_{name}_b2b_ms"] = cs.back_to_back_ms(
            lambda: gi.gauss_interpolate(d, vv), iters=10)


def thomas_f64(a, w, d, lam):
    """The 1-D WLS system along the last axis in float64 on the card, by
    Thomas's algorithm (no pivot is 0 in float64)."""
    import torch

    a, w, d = (x.double() for x in (a, w, d))
    z = torch.zeros_like(d[..., :1])
    wl, wr = torch.cat([z, w], -1), torch.cat([w, z], -1)
    diag = a + lam * (wl + wr) + 1e-8
    cp, dp = torch.empty_like(d), torch.empty_like(d)
    c = p = torch.zeros_like(d[..., 0])
    for i in range(d.shape[-1]):
        den = diag[..., i] + lam * wl[..., i] * c
        c = -lam * wr[..., i] / den
        p = (a[..., i] * d[..., i] + lam * wl[..., i] * p) / den
        cp[..., i], dp[..., i] = c, p
    u, un = torch.empty_like(d), torch.zeros_like(d[..., 0])
    for i in range(d.shape[-1] - 1, -1, -1):
        un = dp[..., i] - cp[..., i] * un
        u[..., i] = un
    return u


def wls_lines(out, cs, l, d, v):
    """The WLS line solve at 2448x2048, both passes, and the fill."""
    import torch
    from i3dr_stereo_tpu_torch.ops import wls

    lam = 1.5 * 8000.0 * 4.0 ** 2 / (4.0 ** 3 - 1.0)    # the first pass's
    a = v.float()
    gn = wls.div_const(l, 255.0)
    outs = []
    for vertical, name in ((False, "h"), (True, "v")):
        w = wls._edge_weights(gn, 0.15, -2 if vertical else -1).contiguous()
        call = lambda: wls.thomas_lines(a, w, d, lam, vertical=vertical)
        out[f"wls_{name}_ms"] = cs.gpu_ms(call)
        out[f"wls_{name}_b2b_ms"] = cs.back_to_back_ms(call, iters=10)
        u = call()
        outs.append(u)
        t = (lambda x: x.transpose(-1, -2)) if vertical else (lambda x: x)
        want = t(thomas_f64(t(a), t(w), t(d), lam))
        out[f"wls_f64_err_{name}"] = (u.double() - want).abs().max().item()
        del want
    out["wls_digest"] = digest(*outs)
    N = d.shape[-1]
    for lines in (1, 64):
        la = torch.rand((1, lines, N), device=cs.DEVICE)
        lw = torch.rand((1, lines, N - 1), device=cs.DEVICE)
        out[f"wls_{lines}_lines_ms"] = cs.gpu_ms(
            lambda: wls.thomas_lines(la, lw, la, lam))
    out["wls_fill_ms"] = cs.gpu_ms(lambda: wls.wls_fill(d, v, l))


def postmatch_frames(out, cs, card, label):
    """The facade at quick_profile() and the flagship frame with interp
    and occlusion handling."""
    from types import SimpleNamespace

    import torch
    from i3dr_stereo_tpu_torch.config.profile import quick_profile
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.i3drsgm import I3DRSGM

    sc = layered_scene(cs.H_FULL, cs.W_FULL, **cs.SCENE)
    l = torch.tensor(sc.left, device=cs.DEVICE)
    r = torch.tensor(sc.right, device=cs.DEVICE)
    facade = I3DRSGM(profile=quick_profile(), device=cs.DEVICE)
    pipe, left, right, _, _, _ = cs.flagship_pipe()
    pipe.update_config(interp=True, occlusion_detection=True,
                       occlusion_interp=True)
    for name, process, a, b in (("facade_frame", facade.match, l, r),
                                ("interp_frame", pipe.process, left, right)):
        res = process(a, b)
        out[f"{name}_digest"] = digest(res.disparity, res.valid)
        out[f"{name}_ms"] = cs.gpu_ms(lambda: process(a, b), iters=10,
                                      warmup=1)
        prof = cs.phase_profile(SimpleNamespace(process=process), a, b, card,
                                label=f"{label} {name}")
        out[f"{name}_busy_ms"] = prof["busy_ms"]
        out[f"{name}_idle_share"] = prof["idle_share"]
        out[f"{name}_activities"] = prof["activities"]
        for key, sym in POSTMATCH_SYMBOLS.items():
            out[f"{name}_{key}_kernel_ms"] = sum(
                ms for k, ms in prof["names_ms"].items() if sym in k)
        del res
    del facade, pipe
    torch.cuda.empty_cache()


def bp(out, cs, card, label):
    """One BP iteration at level 0, then the BP and CSBP frames."""
    import torch
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers import bp as mbp

    sc = layered_scene(cs.H_SGBM, cs.W_SGBM, **cs.SGBM_SCENE)
    l = torch.tensor(sc.left, device=cs.DEVICE)[None]
    r = torch.tensor(sc.right, device=cs.DEVICE)[None]
    data = mbp.data_cost(l, r, 0, 128)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(12)
    msgs = 0.3 * torch.randn((4,) + data.shape, device=cs.DEVICE,
                             generator=gen)
    call = lambda: mbp.bp_iterate(data, msgs, 1, 1.0, 1.7)
    out["bp_messages_ms"] = cs.gpu_ms(call, iters=5)
    out["bp_messages_b2b_ms"] = cs.back_to_back_ms(call, iters=10, warmup=2)
    out["bp_messages_digest"] = digest(call())
    del data, msgs
    torch.cuda.empty_cache()
    for name, alg in (("bp_frame", params.Algorithm.BP_GPU),
                      ("csbp_frame", params.Algorithm.CSBP_GPU)):
        pipe, left, right, psc, _ = cs.bp_pipe(alg)
        res = cs.drive_frame(pipe, left, right, psc, (), f"{label} {name}",
                             {}, max_med=cs.BP_MAX_MEDIAN_ERR)
        out[f"{name}_digest"] = digest(res.disparity, res.valid)
        out[f"{name}_ms"] = cs.gpu_ms(lambda: pipe.process(left, right),
                                      iters=5, warmup=1)
        prof = cs.phase_profile(pipe, left, right, card,
                                label=f"{label} {name}")
        out[f"{name}_busy_ms"] = prof["busy_ms"]
        out[f"{name}_idle_share"] = prof["idle_share"]
        out[f"{name}_activities"] = prof["activities"]
        for key, sym in BP_SYMBOLS.items():
            out[f"{name}_{key}_kernel_ms"] = sum(
                ms for k, ms in prof["names_ms"].items() if sym in k)
        del pipe, res
        torch.cuda.empty_cache()


def host_us(fn, n=200) -> float:
    """The host's time to issue one call of ``fn`` (no sync among n)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def icp(out, cs):
    """The moving rig's ICP: a step at each level, a whole track, the
    tracker over the rig's frames. A checkout of one of two layouts: the
    two (H, W, 4) maps of the previous frame and a step a launch, or the
    record and a track a launch (``odometry.icp_track``)."""
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from i3dr_stereo_tpu_torch.mapping import (DepthOdometry,
                                               render_plane_depth)
    from i3dr_stereo_tpu_torch.mapping import odometry as odo

    with ThreadPoolExecutor(5) as pool:
        depths = list(pool.map(lambda T: render_plane_depth(
            cs.MAP_K, T, cs.MAP_SCENE, cs.H_FULL, cs.W_FULL),
            cs.map_trajectory()))
    prev, cur = (odo.pack_maps(torch.tensor(d, device=cs.DEVICE), cs.MAP_K,
                               3) for d in depths[:2])
    one_launch = hasattr(odo, "icp_track")
    scratch = None if one_launch else torch.empty(odo.ICP_PARTIALS,
                                                  device=cs.DEVICE)
    state = torch.zeros(odo.STATE, device=cs.DEVICE)

    def reset():
        state.zero_()
        state[:16] = torch.eye(4, device=cs.DEVICE).reshape(-1)

    def step_fn(li):
        Kl = odo.level_intrinsics(cs.MAP_K, li)
        cam = (Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2])
        if one_launch:
            return lambda: odo.icp_step(cur[li][0], prev[li][1], cam, state,
                                        0.5)
        return lambda: odo.icp_step(cur[li][0], *prev[li], cam, state, 0.5,
                                    scratch=scratch)

    reset()
    step_fn(0)()
    out["icp_pairs_digest"] = digest(state[61:62])
    for li in range(3):
        reset()
        out[f"icp_step{li}_ms"] = cs.gpu_ms(step_fn(li))
        reset()
        out[f"icp_step{li}_b2b_ms"] = cs.back_to_back_ms(step_fn(li))
    T0 = torch.eye(4, device=cs.DEVICE)
    track = lambda: odo._track(prev, cur, cs.MAP_K, T0)
    out["icp_track_digest"] = digest(track())
    out["icp_track_ms"] = cs.gpu_ms(track)
    out["icp_track_b2b_ms"] = cs.back_to_back_ms(track, iters=20)
    reset()
    out["icp_step_host_us"] = host_us(step_fn(2))
    out["icp_track_host_us"] = host_us(track, n=50)
    d1 = torch.tensor(depths[1], device=cs.DEVICE)
    out["icp_pack_ms"] = cs.gpu_ms(lambda: odo.pack_maps(d1, cs.MAP_K, 3))
    rig = DepthOdometry(K=cs.MAP_K, device=cs.DEVICE)
    rig.track(depths[0])
    rig = DepthOdometry(K=cs.MAP_K, device=cs.DEVICE)
    # the trajectory forward, back and forward again: 29 tracked frames
    ms = [cs.timed(lambda: rig.track(d).copy())[1]
          for d in depths + depths[::-1] + depths]
    out["icp_track_frame_ms"] = statistics.median(ms[1:])
    del prev, cur
    torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    sections = SECTIONS
    if args[:1] == ["--only"]:
        sections, args = tuple(args[1].split(",")), args[2:]
        unknown = set(sections) - set(SECTIONS)
        if unknown:
            print(f"unknown sections {sorted(unknown)}; known: {SECTIONS}")
            return 2
    if args[:1] == ["--one"]:
        print("RESULT " + json.dumps(measure(Path(args[1]).resolve(),
                                             sections)), flush=True)
        return 0
    roots = [Path(a).resolve() for a in args] or [HERE]
    results = []
    for root in roots:
        print(f"=== {root}", flush=True)
        run = subprocess.run([sys.executable, __file__, "--only",
                              ",".join(sections), "--one", str(root)],
                             capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], flush=True)
            return 1
        results.append(json.loads(
            [l for l in run.stdout.splitlines()
             if l.startswith("RESULT ")][-1][7:]))
    for r in results:
        print(f"{r['root']} [{r['card']}]:", flush=True)
        for k, v in r.items():
            if isinstance(v, float):
                print(f"  {k} {v:.4f}", flush=True)
    digests = [k for k in DIGESTS if k in results[0]]
    unequal = [k for k in digests if len({r[k] for r in results}) != 1]
    for k in ROUNDING_DIGESTS:
        if k in results[0]:
            print(f"{k} (not held equal): "
                  f"{', '.join(r[k] for r in results)}", flush=True)
    print(f"digests of all roots bit-equal ({', '.join(digests)}): "
          f"{not unequal}" + (f"; differ: {unequal}" if unequal else ""),
          flush=True)
    return 0 if not unequal else 1

if __name__ == "__main__":
    sys.exit(main())
