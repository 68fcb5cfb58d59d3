"""Winner-take-all disparity extraction: argmin + uniqueness + subpixel
(torch port of ``i3dr_stereo_tpu.ops.wta``), cv::StereoSGBM / StereoBM
selection semantics:

- best d = argmin_d S(p, d), the first minimum;
- uniqueness: invalid if some d with |d - best| > 1 has
  S[d] * (100 - uniquenessRatio) < S[best] * 100;
- parabolic subpixel d + (S[d-1] - S[d+1]) / (2 (S[d-1] + S[d+1] - 2 S[d])),
  clipped to +-0.5, for interior d only.

Plain torch on every device. The flagship's WTA is fused into the
``sgm_sweep_wta`` kernel (:mod:`i3dr_stereo_tpu_torch.ops.sgm_fused_t`).
"""

from __future__ import annotations

import torch

BIG = 1.0e9


def wta_disparity(S: torch.Tensor, min_disparity: int = 0, *,
                  uniqueness_ratio=0.0, subpixel: bool = True):
    """S: (..., D) aggregated costs -> (disparity float32 in absolute
    pixels, valid bool). A pixel whose best cost is BIG-level (>= BIG/2,
    or >= 9999 for an integer S from the int16 mode) is invalid.
    ``uniqueness_ratio`` is a runtime value; <= 0 disables the check."""
    D = S.shape[-1]
    if S.dtype.is_floating_point:
        invalid_level = BIG / 2
    else:
        S = S.to(torch.float32)
        invalid_level = 9999.0
    Sbest, best = S.min(-1, keepdim=True)
    valid = Sbest < invalid_level

    ur = float(uniqueness_ratio)
    if ur > 0:
        d_idx = torch.arange(D, device=S.device)
        far = (d_idx - best).abs() > 1
        min_far = torch.where(far, S, torch.inf).amin(-1, keepdim=True)
        valid = valid & (min_far * (100.0 - ur) >= Sbest * 100.0)

    disp = best.to(torch.float32)
    if subpixel:
        Sm = S.gather(-1, (best - 1).clamp(min=0))
        Sp = S.gather(-1, (best + 1).clamp(max=D - 1))
        denom = (Sm + Sp) - 2.0 * Sbest
        offset = torch.where(denom > 1e-9, (Sm - Sp) / (2.0 * denom), 0.0)
        offset = offset.clamp(-0.5, 0.5)
        interior = (best > 0) & (best < D - 1)
        disp = disp + torch.where(interior, offset, 0.0)
    disp = disp + float(min_disparity)
    return disp[..., 0], valid[..., 0]
