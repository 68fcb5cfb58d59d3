"""Left-right consistency ("backmatching") without a second match (torch
port of ``i3dr_stereo_tpu.ops.lr_check``).

The right-image cost volume is a re-indexing of the aggregated left
volume, ``S_R(y, x_r, d) = S_L(y, x_r + d, d)`` — one gather, no second
SGM (cv::StereoSGBM's internal disp2). Plain torch on every device.
"""

from __future__ import annotations

import torch

BIG = 1.0e9


def right_cost_volume(S: torch.Tensor, min_disparity: int = 0) -> torch.Tensor:
    """(B, H, W, D) or (H, W, D) left-aggregated costs -> right-anchored
    costs, BIG where x_r + d leaves the image."""
    batched = S.ndim == 4
    Sb = S if batched else S[None]
    B, H, W, D = Sb.shape
    src = (torch.arange(W, device=S.device)[:, None]
           + torch.arange(D, device=S.device)[None, :] + int(min_disparity))
    valid = (src >= 0) & (src < W)
    out = Sb.gather(2, src.clamp(0, W - 1).expand(B, H, W, D))
    out = torch.where(valid, out, BIG)
    return out if batched else out[0]


def lr_consistency(disp: torch.Tensor, valid: torch.Tensor, S: torch.Tensor,
                   min_disparity: int = 0, max_diff=1.0):
    """Invalidate pixels failing |d_R(x - d_L(x)) - d_L(x)| <= max_diff on
    rounded (half to even) disparities; d_R is the WTA of the re-indexed
    volume. Returns (disp, valid)."""
    batched = disp.ndim == 3
    dispb = disp if batched else disp[None]
    validb = valid if batched else valid[None]
    Sb = S if batched else S[None]
    W = dispb.shape[-1]

    SR = right_cost_volume(Sb, min_disparity)
    rmin, rbest = SR.min(-1)
    rbest = rbest + int(min_disparity)
    rvalid = rmin < BIG / 2

    d_int = torch.round(dispb).to(torch.int64)
    xr = torch.arange(W, device=disp.device) - d_int
    in_img = (xr >= 0) & (xr < W)
    xr_c = xr.clamp(0, W - 1)
    r_at = rbest.gather(2, xr_c)
    r_ok = rvalid.gather(2, xr_c)
    consistent = (r_at - d_int).abs() <= float(max_diff)
    ok = validb & in_img & r_ok & consistent
    return disp, (ok if batched else ok[0])
