"""Frame containers and image conversion at the pipeline's entry (torch
port of ``i3dr_stereo_tpu.core.frame``).

The reference registers its frames as JAX pytrees; here they are plain
dataclasses of tensors that all lie on one device, named when the frame
is created (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from i3dr_stereo_tpu_torch._build import resolve_device

# ITU-R BT.601 luma, matching cv::cvtColor BGR2GRAY weights (B, G, R)
_BGR_WEIGHTS = (0.114, 0.587, 0.299)


def _stamp_seq(stamp: float, seq: int, device: torch.device):
    return (torch.tensor(stamp, dtype=torch.float32, device=device),
            torch.tensor(seq, dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class Frame:
    """One image: mono float32 [0, 255] (H, W) or (H, W, 3) color."""

    image: torch.Tensor
    stamp: torch.Tensor  # 0-dim float32 seconds
    seq: torch.Tensor    # 0-dim int32 sequence number

    @property
    def device(self) -> torch.device:
        return self.image.device

    @staticmethod
    def create(image, stamp: float = 0.0, seq: int = 0, *,
               device="cuda") -> "Frame":
        dev = resolve_device(device)
        return Frame(torch.as_tensor(image, device=dev),
                     *_stamp_seq(stamp, seq, dev))


@dataclasses.dataclass(frozen=True)
class StereoFrame:
    """A time-paired left/right image pair (post frame-pairing)."""

    left: torch.Tensor   # (H, W) or (B, H, W)
    right: torch.Tensor
    stamp: torch.Tensor
    seq: torch.Tensor

    @staticmethod
    def create(left, right, stamp: float = 0.0, seq: int = 0, *,
               device="cuda") -> "StereoFrame":
        dev = resolve_device(device)
        left = torch.as_tensor(left, device=dev)
        right = torch.as_tensor(right, device=dev)
        if left.shape != right.shape:
            raise ValueError(f"left {tuple(left.shape)} and right "
                             f"{tuple(right.shape)} differ in shape")
        return StereoFrame(left, right, *_stamp_seq(stamp, seq, dev))

    @property
    def device(self) -> torch.device:
        return self.left.device

    @property
    def height(self) -> int:
        return self.left.shape[-2]

    @property
    def width(self) -> int:
        return self.left.shape[-1]


def to_mono_f32(image: torch.Tensor) -> torch.Tensor:
    """uint8/float, mono or BGR -> float32 mono in [0, 255].

    The luma is an explicit weighted sum rather than a tensordot, which
    on the card would be a cuBLAS call."""
    x = image.to(torch.float32)
    if x.ndim == 3 and x.shape[-1] == 3:
        wb, wg, wr = _BGR_WEIGHTS
        return x[..., 0] * wb + x[..., 1] * wg + x[..., 2] * wr
    return x


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array -> a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def to_uint8(image) -> np.ndarray:
    """A tensor on any device or an array -> host uint8, clipped to
    [0, 255]."""
    return np.clip(to_numpy(image), 0, 255).astype(np.uint8)
