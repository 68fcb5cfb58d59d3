"""I3DRSGM engine facade (torch port of ``i3dr_stereo_tpu.matchers.i3drsgm``):
the licensed engine wrapper's surface (include/stereoMatcher/I3DRSGM.h:18-86
and matcherI3DRSGM.{h,cpp}) on top of the pyramid SGM:

- construction from a typed profile, a ``.param`` INI file (the dialect
  of ini/quick.param, parsed once into an
  :class:`~i3dr_stereo_tpu_torch.config.profile.SGMProfile`) or, by
  default, :func:`~i3dr_stereo_tpu_torch.config.profile.quick_profile`;
- every setter of the wrapper with its ROS-unit quirks (P1/P2 /1000,
  disparity range /10 forced odd, speckle /10, min disparity -> the
  coarsest level's prediction shift /20; I3DRSGM.cpp:249-508) and the
  pyramid enable / max level (I3DRSGM.cpp:405-469);
- forward and backward match (the backward one on swapped images mirrored
  along the width axis, like createRightMatcher);
- the nodata -10000 convention and the adapter's x(-16) fixed-point flip
  (matcherI3DRSGM.cpp:36,43).

Runs on the card unless asked for the CPU (``device``; a missing card
raises). PyTorch runs eagerly, so a setter replaces the frozen profile
and nothing is rebuilt. ``enableCPU(True)`` runs the kernels' plain torch
twins on the facade's device, where the reference switched its engine
to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from i3dr_stereo_tpu_torch._build import resolve_device
from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.config.profile import (
    NODATA_VALUE,
    SGMProfile,
    quick_profile,
)
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match


def _replace_levels(profile: SGMProfile, **kw) -> SGMProfile:
    return dataclasses.replace(
        profile,
        levels=tuple(dataclasses.replace(lv, **kw) for lv in profile.levels))


class I3DRSGM:
    """Drop-in engine object with the reference wrapper's method names.
    ``lean=True`` takes the pyramid's lean levels (the reference's
    ``I3DR_SGM_BACKEND=pallas``)."""

    def __init__(self, param_file: Optional[str] = None,
                 profile: Optional[SGMProfile] = None, *,
                 device: torch.device | str = "cuda", lean: bool = False):
        if profile is not None:
            self.profile = profile
        elif param_file is not None:
            self.profile = SGMProfile.from_param_file(param_file)
        else:
            self.profile = quick_profile()
        self.config = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM]
        self.nodata = NODATA_VALUE
        self.device = resolve_device(device)
        self.lean = bool(lean)
        self.plain = False

    # -- match ----------------------------------------------------------------
    def _input(self, image) -> torch.Tensor:
        return torch.as_tensor(image).to(self.device, torch.float32)

    def _match(self, left, right) -> MatchResult:
        return pyramid_sgm_match(left, right, self.config, self.profile,
                                 lean=self.lean, plain=self.plain)

    def forward_match(self, left, right) -> MatchResult:
        """(H, W) or (B, H, W) rectified mono images -> left-anchored
        MatchResult on the facade's device."""
        return self._match(self._input(left), self._input(right))

    def backward_match(self, left, right) -> MatchResult:
        """Right-anchored disparity: the match of the swapped mono images,
        mirrored along the width axis, the last."""
        l, r = self._input(left), self._input(right)
        res = self._match(r.flip(-1), l.flip(-1))
        return MatchResult(disparity=res.disparity.flip(-1),
                           valid=res.valid.flip(-1))

    match = forward_match

    def reference_encoded(self, res: MatchResult) -> torch.Tensor:
        """The adapter's output convention: disparity x(-16), invalid ->
        nodata (matcherI3DRSGM.cpp:36-47; I3DRSGM.cpp:142-145)."""
        return torch.where(res.valid, res.disparity * -16.0, self.nodata)

    # -- reference setter surface (ROS unit conventions) ----------------------
    def setP1(self, ros_value: float) -> None:
        v = ros_value / 1000.0
        self.profile = _replace_levels(self.profile, p1=(v, v, v, v))

    def setP2(self, ros_value: float) -> None:
        v = ros_value / 1000.0
        self.profile = _replace_levels(self.profile, p2=(v, v, v, v))

    def setDisparityRange(self, ros_value: int) -> None:
        n = int(ros_value / 10)
        if n % 2 == 0:
            n += 1
        self.profile = _replace_levels(self.profile, num_disparities=n)

    def setSpeckleDifference(self, ros_value: float) -> None:
        self.profile = _replace_levels(self.profile,
                                       speckle_max_diff=ros_value / 10.0)

    def setSpeckleSize(self, ros_value: int) -> None:
        self.profile = _replace_levels(self.profile,
                                       speckle_max_region=int(ros_value / 10))

    def setMinDisparity(self, ros_value: float) -> None:
        shift = ros_value / 20.0
        coarse = max(lv.level for lv in self.profile.levels)
        self.profile = dataclasses.replace(
            self.profile,
            levels=tuple(dataclasses.replace(
                lv, prediction_shift=shift if lv.level == coarse else 0.0)
                for lv in self.profile.levels))

    def setWindowSize(self, size: int) -> None:
        size = min(int(size), 17)
        if size % 2 == 0:
            size += 1
        self.profile = _replace_levels(self.profile, census_w=size,
                                       census_h=size)

    def setBackmatchingDistance(self, d: float) -> None:
        self.profile = _replace_levels(self.profile, backmatch_dist=d)

    def enableBackmatching(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile, backmatch=bool(on))

    def enableSubpixel(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile, subpixel=bool(on))

    def enableInterpolation(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile,
                                       interpolate_gaps=bool(on))

    def enableOcclusionDetection(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile,
                                       occlusion_detection=bool(on))

    def enableOcclusionInterpolation(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile,
                                       interpolate_occlusions=bool(on))

    def enablePyramid(self, min_level: int, max_level: int) -> None:
        self.profile = self.profile.with_levels_enabled(min_level, max_level)

    def maxPyramid(self, level: int) -> None:
        """I3DRSGM.cpp:442-469: enable pyramids 0..level."""
        self.profile = self.profile.with_levels_enabled(0, level)

    def enableCPU(self, on: bool) -> None:
        """Reference: switch the engine to the CPU (I3DRSGM.cpp:214-235).
        Here: run the kernels' plain torch twins on the facade's device
        (off by default; a CPU facade runs them anyway)."""
        self.plain = bool(on)

    def setNoDataValue(self, v: float) -> None:
        self.nodata = float(v)
