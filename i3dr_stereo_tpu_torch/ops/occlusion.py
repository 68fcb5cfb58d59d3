"""Occlusion detection and background fill (torch port of
``i3dr_stereo_tpu.ops.occlusion``): the engine's "Occlusion Detection" /
"Interpolate Occlusions" switches (I3DRSGM.cpp:566-628).

Left pixel x is occluded when the right-image column it lands on,
x - round(d(x)), is claimed by a nearer surface: a right-image z-buffer
(the largest disparity landing on each right column, one scatter-max)
holds a disparity more than ``step`` above its own. An occluded pixel is
filled from the background side: the farther (smaller) of the nearest
valid disparities to its left and to its right on its row.

Plain torch on every device, a handful of launches a call: the scatter
is ``scatter_reduce(..., "amax")`` and the nearest-valid scans of the
reference (a ``lax.scan`` over W) are running indices of the last valid
pixel by ``cummax`` / ``cummin``.
"""

from __future__ import annotations

import torch

BIG = 1.0e9


def detect_occlusions(disp: torch.Tensor, valid: torch.Tensor,
                      step: float = 1.1) -> torch.Tensor:
    """Bool mask of occluded pixels (a subset of ``valid``) of (B, H, W)
    absolute disparities: valid, landing inside the right image, and the
    z-buffer at its right column above ``disp + step``."""
    W = disp.shape[-1]
    xr = (torch.arange(W, dtype=torch.int64, device=disp.device)
          - torch.round(disp).to(torch.int64))
    in_img = (xr >= 0) & (xr < W)
    xr_c = xr.clamp(0, W - 1)
    d_eff = torch.where(valid & in_img, disp, -BIG)
    zbuf = torch.full_like(disp, -BIG).scatter_reduce_(
        -1, xr_c, d_eff, "amax", include_self=True)
    winner = zbuf.gather(-1, xr_c)
    return valid & in_img & (winner > disp + step)


def _nearest_valid(disp: torch.Tensor, ok: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    """Per row: the disparity of the nearest ``ok`` pixel at or before x
    (at or after x when ``reverse``), NaN where there is none."""
    W = disp.shape[-1]
    xs = torch.arange(W, dtype=torch.int64, device=disp.device)
    if reverse:
        idx = torch.where(ok, xs, W).flip(-1).cummin(-1).values.flip(-1)
        found = idx < W
    else:
        idx = torch.where(ok, xs, -1).cummax(-1).values
        found = idx >= 0
    near = disp.gather(-1, idx.clamp(0, W - 1))
    return torch.where(found, near, torch.nan)


def fill_occlusions(disp: torch.Tensor, valid: torch.Tensor,
                    occluded: torch.Tensor):
    """Background fill of occluded pixels: (disp, valid) with each occluded
    pixel replaced by the farther of its two nearest valid horizontal
    neighbours (``fmin``: a missing side is ignored) and marked valid; an
    occluded pixel with neither keeps its disparity and is invalid."""
    # a NaN disparity counts as no support, as in the reference's scan
    ok = valid & ~occluded
    ok_num = ok & ~torch.isnan(disp)
    both = torch.fmin(_nearest_valid(disp, ok_num, reverse=False),
                      _nearest_valid(disp, ok_num, reverse=True))
    missing = torch.isnan(both)
    fill = torch.where(missing, disp, both)
    out = torch.where(occluded, fill, disp)
    return out, ok | (occluded & ~missing)
