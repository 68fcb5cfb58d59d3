"""Matcher facade (torch port of ``i3dr_stereo_tpu.matchers.base``): the
match result with the reference's encodings, and ``StereoMatcher`` /
``create_matcher``, the AbstractStereoMatcher surface
(include/stereoMatcher/abstractStereoMatcher.h:12-92).

PyTorch runs eagerly, so the reference's per-shape cache of compiled
executables has no counterpart: every call runs the current config.
"""

from __future__ import annotations

import dataclasses

import torch

from i3dr_stereo_tpu_torch._build import resolve_device
from i3dr_stereo_tpu_torch.config.params import (
    ALGORITHM_DEFAULTS,
    Algorithm,
    MatcherConfig,
)
from i3dr_stereo_tpu_torch.core.frame import to_mono_f32
from i3dr_stereo_tpu_torch.ops.resize import resize_cubic, resize_nearest
from i3dr_stereo_tpu_torch.ops.wls import div_const

NODATA = -10000.0    # I3DRSGM nodata convention (I3DRSGM.cpp:142-145)
MISSING_Z = 10000.0  # generate_disparity.cpp MISSING_Z


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Disparity in absolute pixels + validity."""

    disparity: torch.Tensor    # (..., H, W) float32, absolute pixels
    valid: torch.Tensor        # (..., H, W) bool

    # --- reference-compatible encodings -------------------------------------
    def fixed_point(self, scale: int = 16,
                    min_disparity: int = 0) -> torch.Tensor:
        """x16 int16 encoding (DPP=16, generate_disparity.cpp:402-436);
        invalid pixels get (minDisparity-1)*16 like cv::StereoBM/SGBM.
        Rounds half to even, as the reference does."""
        d = torch.where(self.valid, self.disparity,
                        float(min_disparity) - 1.0)
        return torch.round(d * scale).to(torch.int16)

    def with_missing_z(self) -> torch.Tensor:
        """float32 disparity with invalid = MISSING_Z (10000), the
        encoding generate_disparity publishes (cpp:449-452)."""
        return torch.where(self.valid, self.disparity, MISSING_Z)

    def with_nodata(self) -> torch.Tensor:
        """float32 disparity with invalid = -10000 (I3DRSGM convention)."""
        return torch.where(self.valid, self.disparity, NODATA)


def _downsample(img: torch.Tensor, scale: float) -> torch.Tensor:
    """The cubic resize of AbstractStereoMatcher::setImages
    (abstractStereoMatcher.cpp:9-30, INTER_CUBIC by downsample_scale), as
    the reference computes it (``jax.image.resize(..., "cubic")``)."""
    if scale == 1.0:
        return img
    H, W = img.shape[-2:]
    return resize_cubic(img, int(round(H * scale)), int(round(W * scale)))


def _upsample_disparity(res: MatchResult, out_hw, scale: float
                        ) -> MatchResult:
    """Invert the downsample: the disparity and the valid mask back to
    ``out_hw`` by the nearest resize, the disparity divided by the scale
    (a product with its float32 reciprocal, as XLA computes the
    reference's division by a constant)."""
    if scale == 1.0:
        return res
    d = resize_nearest(res.disparity, *out_hw)
    v = resize_nearest(res.valid.to(torch.float32), *out_hw) > 0.5
    return MatchResult(disparity=div_const(d, scale), valid=v)


class StereoMatcher:
    """Stateful wrapper: a config and the match calls. Parameter changes
    never rebuild an engine (cf. I3DRSGM.cpp:630-654's destroy/recreate
    per setter). ``lean`` selects the reference's second SGM backend
    (the fused cost + SGM path, ``matchers/registry.py``). ``device``:
    where the matching runs, the card unless the caller asks for the CPU
    (a missing card raises; the CPU runs the plain torch twins)."""

    def __init__(self, config: MatcherConfig, *, lean: bool = False,
                 device: torch.device | str = "cuda"):
        self._config = config.sanitize()
        self.lean = bool(lean)
        self.device = resolve_device(device)

    @property
    def config(self) -> MatcherConfig:
        return self._config

    def set_config(self, config: MatcherConfig) -> None:
        self._config = config.sanitize()

    def update(self, **kw) -> None:
        """Live reconfigure (the dynamic_reconfigure path)."""
        self._config = self._config.replace(**kw)

    def _input(self, image) -> torch.Tensor:
        """An image on the matcher's device; a CUDA tensor stays where it
        is on a CUDA matcher."""
        x = torch.as_tensor(image)
        if x.device.type == "cuda" and self.device.type == "cuda":
            return x
        return x.to(self.device)

    def match(self, left, right) -> MatchResult:
        """(H, W) or (B, H, W) images (mono or BGR, uint8 or float; numpy
        or tensors) -> left-anchored MatchResult on the matcher's
        device. With ``downsample_scale != 1`` both images are resized
        first by the reference's antialiased cubic resize (to
        ``round(H * scale)`` x ``round(W * scale)``), and the result comes
        back to the input's size by the nearest resize, the disparity
        divided by the scale."""
        from i3dr_stereo_tpu_torch.matchers.registry import MATCHER_REGISTRY

        cfg = self._config
        scale = cfg.downsample_scale
        li = to_mono_f32(self._input(left))
        ri = to_mono_f32(self._input(right))
        res = MATCHER_REGISTRY[cfg.algorithm](
            _downsample(li, scale), _downsample(ri, scale), cfg,
            lean=self.lean)
        return _upsample_disparity(res, li.shape[-2:], scale)

    # reference-compatible aliases (abstractStereoMatcher.h)
    forward_match = match

    def backward_match(self, left, right) -> MatchResult:
        """Right-anchored disparity: match with swapped, mirrored images
        (the createRightMatcher trick, matcherOpenCVBlock.cpp:46-51)."""
        l, r = self._input(left), self._input(right)
        # mirror the width axis (a BGR image keeps its channel order; the
        # reference flips the last axis, channels included)
        w_axis = -2 if l.ndim == 3 and l.shape[-1] == 3 else -1
        res = self.match(r.flip(w_axis), l.flip(w_axis))
        return MatchResult(disparity=res.disparity.flip(-1),
                           valid=res.valid.flip(-1))


def create_matcher(config: MatcherConfig | Algorithm, *, lean: bool = False,
                   device: torch.device | str = "cuda") -> StereoMatcher:
    """Factory keyed by the reference's algorithm enum
    (init_matcher, generate_disparity.cpp:263-331)."""
    if isinstance(config, Algorithm):
        config = ALGORITHM_DEFAULTS[config]
    return StereoMatcher(config, lean=lean, device=device)
