"""Plain reference of the I3DRSGM pyramid (the port's
``matchers/pyramid.py`` default branch under ``profile_from_config``):
levels of 31-disparity residual windows around the median-smoothed,
upsampled coarser estimate; each level edge-padded to multiples of 128,
the right image warped by the prediction clamped to its (8 x 128) block
anchor, census, cost + SGM + WTA, true backmatching, speckle at level 0,
masked median, and the between-level fill."""

from __future__ import annotations

import torch

from portbench.reference import ops


def _ceil_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _level(ll, rr, pred_int, base_val: int, K: int, pens, n_dirs: int,
           census_hw, *, subpixel: bool, uniqueness_ratio, dtype):
    B, Hh, Wh = ll.shape
    K8 = _ceil_to(max(K, 8), 8)
    Hp, Wp = _ceil_to(Hh, 128), _ceil_to(Wh, 128)
    llp = ops.pad_edge(ll, Hp, Wp).contiguous()
    rrp = ops.pad_edge(rr, Hp, Wp).contiguous()
    if pred_int is None:
        rw, bpm, offset = rrp, int(base_val), float(base_val)
    else:
        pred_p = ops.pad_edge(pred_int, Hp, Wp)
        q = ops.block_anchors(pred_p)
        q_up = q.repeat_interleave(8, 1).repeat_interleave(128, 2)
        pred_eff = torch.minimum(torch.maximum(pred_p, q_up - K8 // 2),
                                 q_up + K8 // 2).contiguous()
        rw = ops.block_shift_gather(rrp, pred_eff, q, K8 // 2)
        bpm = -(K8 // 2)
        offset = (pred_eff[:, :Hh, :Wh] + bpm).to(torch.float32)
    ch, cw = census_hw
    cl = ops.census_transform(llp, ch, cw)
    cr = ops.census_transform(rw, ch, cw)
    disp_p, C = ops.census_sgm_wta(
        cl, cr, K8, bpm=bpm, W_real=Wh, H_real=Hh, pens=pens,
        directions=n_dirs, subpixel=subpixel,
        uniqueness_ratio=uniqueness_ratio, dtype=dtype)
    disp_res = disp_p[:, :Hh, :Wh]
    valid = disp_res > -1.0e8
    disp = torch.where(valid, disp_res, float(K8 // 2)) + offset
    valid_p = disp_p > -1.0e8
    r_res = torch.where(valid_p, disp_p + float(bpm), 0.0)
    d_r, v_r = ops.right_disparity_from_C(C, bpm, Wh)
    return disp, valid, (r_res, d_r, v_r, bpm, K8)


def _backmatch(valid, bm, max_diff):
    r_res, d_r, v_r, bpm, K8 = bm
    B, Hh, Wh = valid.shape
    _, Hp, Wp = r_res.shape
    rr_int = torch.round(r_res).to(torch.int32)
    q = torch.full((B, Hp // 8, (Wp + 127) // 128), int(bpm) + K8 // 2,
                   dtype=torch.int32, device=r_res.device)
    d_r_m = torch.where(v_r, d_r, 1.0e9)
    d_at = ops.block_shift_gather(d_r_m, rr_int, q, K8 // 2 + 1)[:, :Hh, :Wh]
    xs = torch.arange(Wh, dtype=torch.int32, device=r_res.device)
    xw = xs - rr_int[:, :Hh, :Wh]
    in_w = (xw >= 0) & (xw < Wh)
    md = torch.as_tensor(max_diff, dtype=torch.float32, device=r_res.device)
    consistent = (d_at - r_res[:, :Hh, :Wh]).abs() <= md
    return valid & in_w & consistent


def match(l: torch.Tensor, r: torch.Tensor, cfg: dict,
          dtype=torch.float32):
    """(1, H, W) float32 rectified pair -> ((1, H, W) disparity, valid).
    ``dtype`` is the precision of the WTA's subpixel step (the control
    takes bfloat16)."""
    n = max(1, int(cfg["max_pyramid_level"]))
    B, H, W = l.shape
    max_by_size = max(0, min(H, W).bit_length() - 6)
    levels = [min(lv, max_by_size) for lv in range(n - 1, -1, -1)]
    pyr_l, pyr_r = [l], [r]
    for _ in range(max(levels)):
        pyr_l.append(ops.downsample2(pyr_l[-1]))
        pyr_r.append(ops.downsample2(pyr_r[-1]))
    n_dirs = 4 if int(cfg["num_directions"]) == 4 else 8
    K = 32  # max(8, 31 + 1): the engine's 31 disparities a level
    pens = ((float(cfg["p1"]), float(cfg["p2"])),) * n_dirs
    backmatch = float(cfg["backmatch_distance"]) >= 0
    disp = valid = cur = None
    for lv in levels:
        ll, rr = pyr_l[lv], pyr_r[lv]
        _, Hh, Wh = ll.shape
        if disp is None:
            base_val = int(round(cfg["min_disparity"] / 2 ** lv))
            pred_int = None
        else:
            pred = disp
            while cur > lv:
                Hn, Wn = pyr_l[cur - 1].shape[1:]
                pred = 2.0 * ops.resize_nearest(pred, Hn, Wn)
                cur -= 1
            pred = ops.median3x3(pred)
            pred_int = torch.round(pred).to(torch.int32).clamp(0, Wh - 1)
            base_val = 0
        disp, valid, bm = _level(
            ll, rr, pred_int, base_val, K, pens, n_dirs,
            (int(cfg["census_height"]), int(cfg["census_width"])),
            subpixel=(lv == 0 and bool(cfg["subpixel"])),
            uniqueness_ratio=float(cfg["uniqueness_ratio"]), dtype=dtype)
        cur = lv
        xs = torch.arange(Wh, dtype=torch.int32, device=disp.device)
        rcol = xs - torch.round(disp).to(torch.int32)
        valid = valid & (rcol >= 0) & (rcol < Wh)
        if backmatch:
            valid = _backmatch(valid, bm, float(cfg["backmatch_distance"]))
        del bm
        if lv == 0 and int(cfg["speckle_size"]) > 0:
            valid = ops.speckle_filter(
                disp, valid, max_size=int(cfg["speckle_size"]),
                max_diff=float(cfg["speckle_range"]),
                downsample=int(cfg["speckle_downsample"]))
        if cfg["median_filter"]:
            disp = ops.median3x3_masked(disp, valid)
        if lv != 0:
            disp = torch.where(valid, disp, ops.median3x3(disp))
    while cur > 0:
        Hn, Wn = pyr_l[cur - 1].shape[1:]
        disp = 2.0 * ops.resize_nearest(disp, Hn, Wn)
        valid = ops.resize_nearest(valid, Hn, Wn)
        cur -= 1
    return disp, valid
