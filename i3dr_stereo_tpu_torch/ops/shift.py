"""Disparity-shifted gathers shared by the cost functions (torch port of
``i3dr_stereo_tpu.ops.shift``).

Pairs left pixel (y, x) with right pixel (y, x - d) for every d in
[min_disparity, min_disparity + D).
"""

from __future__ import annotations

import torch


def gather_disparity_shifted(right: torch.Tensor, min_disparity: int,
                             disparity_range: int):
    """right: (B, H, W) or (B, H, W, F) -> ((B, H, W, D[, F]) gathered,
    (B, H, W, D) bool valid).

    valid[b, h, w, d] is True iff 0 <= w - (min_disparity + d) < W.
    Out-of-range taps are clamped (the caller masks them with ``valid``).
    """
    B, H, W = right.shape[:3]
    src = (torch.arange(W, device=right.device)[:, None]
           - torch.arange(disparity_range, device=right.device)[None, :]
           - int(min_disparity))                                   # (W, D)
    valid = (src >= 0) & (src < W)
    out = right[:, :, src.clamp(0, W - 1)]          # (B, H, W, D[, F])
    return out, valid.expand(B, H, W, disparity_range)
