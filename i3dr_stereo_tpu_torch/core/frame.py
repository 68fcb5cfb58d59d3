"""Image conversion at the pipeline's entry (torch port of
``i3dr_stereo_tpu.core.frame.to_mono_f32``)."""

from __future__ import annotations

import torch

# ITU-R BT.601 luma, matching cv::cvtColor BGR2GRAY weights (B, G, R)
_BGR_WEIGHTS = (0.114, 0.587, 0.299)


def to_mono_f32(image: torch.Tensor) -> torch.Tensor:
    """uint8/float, mono or BGR -> float32 mono in [0, 255].

    The luma is an explicit weighted sum rather than a tensordot, which
    on the card would be a cuBLAS call."""
    x = image.to(torch.float32)
    if x.ndim == 3 and x.shape[-1] == 3:
        wb, wg, wr = _BGR_WEIGHTS
        return x[..., 0] * wb + x[..., 1] * wg + x[..., 2] * wr
    return x
