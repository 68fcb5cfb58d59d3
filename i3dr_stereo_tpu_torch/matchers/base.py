"""Matcher result (torch port of ``i3dr_stereo_tpu.matchers.base.MatchResult``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Disparity in absolute pixels + validity."""

    disparity: torch.Tensor    # (..., H, W) float32, absolute pixels
    valid: torch.Tensor        # (..., H, W) bool
