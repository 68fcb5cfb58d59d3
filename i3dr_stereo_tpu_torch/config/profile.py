"""Typed pyramid schedule (torch port of the typed half of
``i3dr_stereo_tpu.config.profile``).

Only :class:`PyramidLevelConfig` and :class:`SGMProfile` are carried
over: the flat :class:`~i3dr_stereo_tpu_torch.config.params.MatcherConfig`
builds its schedule through
:func:`i3dr_stereo_tpu_torch.matchers.pyramid.profile_from_config`. The
engine's ``.param`` INI parser and its unit conventions are not ported
yet (ROADMAP.md, Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import List

NODATA_VALUE = -10000.0  # engine nodata convention (I3DRSGM.cpp:142-145, quick.param Nodata Value)
DSI_NODATA = 10000.0     # in-DSI nodata (quick.param "DSI Nodata Value")


@dataclasses.dataclass(frozen=True)
class PyramidLevelConfig:
    """One ``[Pyramid N]`` / ``[Pyramid N Subpix]`` section, typed."""

    level: int                       # 0 = full resolution
    enabled: bool = True             # "Process This Pyramid"
    subpix_pass: bool = False        # section is a "... Subpix" refinement pass
    num_disparities: int = 31        # "Number Of Disparities" (per-level window)
    step_size: float = 0.5           # "Disparity Step Size" (0.5 => half-pel DSI)
    census_w: int = 9                # "Feature Set Size X"
    census_h: int = 9                # "Feature Set Size Y"
    # per-direction additive penalties; order: (SN, SE-NW, SW-NE, WE)
    p1: tuple = (0.1, 0.1, 0.1, 0.1)
    p2: tuple = (0.8, 0.8, 0.8, 0.8)
    directions: tuple = (True, True, True, True)  # SGM <dir> Optimization flags
    backmatch: bool = True           # "Compute Backmatching"
    backmatch_dist: float = 1.5      # "Maximum Backmatching Distance"
    median: bool = True              # "Disparity Median Optimizer" (3x3)
    speckle: bool = True             # "Disparity Speckle Filter Optimizer"
    speckle_max_diff: float = 0.5
    speckle_max_region: int = 100
    subpixel: bool = True            # "DSI Interpolator = Parabolic"
    interpolate_gaps: bool = True    # "Interpolate Disparity" (Gauss interpolator)
    interpolator_mode: str = "gauss"  # "Interpolator Mode" (Gauss | wls fallback)
    interp_directions: int = 32      # "Interpolator Number Of Directions"
    interp_min_elements: int = 0     # "Interpolator Minimum Number Of Elements"
    interpolate_occlusions: bool = True
    occlusion_detection: bool = False
    prediction_shift: float = -5.0   # "Top Prediction Shift" (coarsest level only)
    # the cv-style WTA margin filter carried from MatcherConfig.uniqueness_ratio
    uniqueness_ratio: float = 0.0


@dataclasses.dataclass(frozen=True)
class SGMProfile:
    """Full coarse-to-fine schedule (= one ``.param`` file, typed)."""

    name: str
    levels: tuple                    # PyramidLevelConfig, coarse -> fine order
    nodata: float = NODATA_VALUE
    dsi_nodata: float = DSI_NODATA
    use_cpu: bool = False            # "Use CPU SGM"

    @property
    def enabled_levels(self) -> List[PyramidLevelConfig]:
        return [lv for lv in self.levels if lv.enabled]
