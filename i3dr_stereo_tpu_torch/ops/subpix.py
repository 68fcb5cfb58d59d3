"""Half-pel disparity refinement, the subpix profile's extra pass (torch
port of ``i3dr_stereo_tpu.ops.subpix``).

The reference's subpix.param runs a final DSI pass with ``Disparity Step
Size = 0.5`` and parabolic interpolation. Here: around the current
estimate, sample an absolute-difference cost at half-pixel shifts (the
right image linearly interpolated), sum it over a 3x3 edge-padded box,
take the first minimum and a parabola over the best triple, clamped to
+-0.5 step. Plain torch on every device (about 40 launches a call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BIG = 1.0e9


def _sample_right(right: torch.Tensor, xsrc: torch.Tensor) -> torch.Tensor:
    """Linear samples of right (B, H, W) at fractional columns xsrc
    (B, H, W, K), the columns clamped into the image."""
    W = right.shape[-1]
    x0 = torch.floor(xsrc)
    frac = xsrc - x0
    i0 = x0.to(torch.int64).clamp(0, W - 1)
    i1 = (i0 + 1).clamp(0, W - 1)
    B, H, _, K = xsrc.shape
    src = right[..., None].expand(B, H, W, K)
    r0 = src.gather(2, i0)
    r1 = src.gather(2, i1)
    return r0 * (1.0 - frac) + r1 * frac


def _box_sum(cost: torch.Tensor, window: int) -> torch.Tensor:
    """Sum of (B, H, W, K) over an edge-padded ``window`` x ``window`` box,
    added in ``lax.reduce_window``'s order on the CPU: from 0, the window's
    rows top to bottom, each row's columns left to right."""
    r = window // 2
    H, W = cost.shape[1:3]
    p = F.pad(cost.permute(0, 3, 1, 2), (r, r, r, r),
              mode="replicate").permute(0, 2, 3, 1)
    acc = torch.zeros_like(cost)
    for dy in range(window):
        for dx in range(window):
            acc = acc + p[:, dy:dy + H, dx:dx + W]
    return acc


def halfpel_refine(left: torch.Tensor, right: torch.Tensor,
                   disp: torch.Tensor, valid: torch.Tensor, *,
                   steps: int = 5, step_size: float = 0.5,
                   window: int = 3) -> torch.Tensor:
    """Refine (B, H, W) disparities: costs at disp + step_size * (k -
    steps // 2), box-summed, parabola over the minimum. Returns the refined
    disparity where ``valid``, ``disp`` elsewhere."""
    W = left.shape[-1]
    K = steps
    dev = left.device
    offs = (torch.arange(K, dtype=torch.float32, device=dev) - K // 2) \
        * step_size
    xs = torch.arange(W, dtype=torch.float32, device=dev)[:, None]
    xsrc = xs - (disp[..., None] + offs)
    cost = (_sample_right(right, xsrc) - left[..., None]).abs()
    if window > 1:
        cost = _box_sum(cost, window)
    in_img = (xsrc >= 0) & (xsrc <= W - 1)
    cost = torch.where(in_img, cost, BIG)

    cb, best = cost.min(-1)
    bm = (best - 1).clamp(0, K - 1)
    bp = (best + 1).clamp(0, K - 1)
    cm = cost.gather(-1, bm[..., None])[..., 0]
    cp = cost.gather(-1, bp[..., None])[..., 0]
    denom = cm + cp - 2.0 * cb
    frac = torch.where(denom > 1e-9, (cm - cp) / (2.0 * denom), 0.0)
    frac = frac.clamp(-0.5, 0.5)
    interior = (best > 0) & (best < K - 1)
    delta = ((best - K // 2) + torch.where(interior, frac, 0.0)) * step_size
    return torch.where(valid, disp + delta, disp)
