"""I3DRSGM engine profile (torch port of ``i3dr_stereo_tpu.config.profile``):
the reference's INI ``.param`` parser and the typed coarse-to-fine
schedule, copied rather than imported (importing the JAX package imports
JAX).

The reference configures its licensed SGM engine through 737-line INI
files (ini/quick.param, ini/subpix.param) with one ``[Pyramid N]`` section
per coarse-to-fine level plus ``[Pyramid N Subpix]`` refinement sections,
mutated at runtime by textual find-and-replace and a full engine rebuild
per parameter change (I3DRSGM.cpp:40-140, 630-654).

Here the same information is a typed, immutable profile:

- :func:`parse_param_ini` reads the reference INI dialect (sections,
  ``Key = Value`` with spaces in keys) into nested dicts — so existing
  ``.param`` files keep working.
- :class:`SGMProfile` is the typed schedule the pyramid matcher
  (:mod:`i3dr_stereo_tpu_torch.matchers.pyramid`) consumes;
  "reconfigure" is ``dataclasses.replace``, never an engine rebuild.
- :func:`from_ros_convention` reproduces the reference's unit quirks so
  launch-file parameter sets mean the same thing here: P1/P2 ÷1000 (extra
  ÷10 for subpix) (I3DRSGM.cpp:294-330), disparity range ÷10 forced odd
  (:491-508), speckle ÷10 (:249-287), min_disparity → top-prediction
  shift ÷20 (:390-403).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional

NODATA_VALUE = -10000.0  # engine nodata convention (I3DRSGM.cpp:142-145, quick.param Nodata Value)
DSI_NODATA = 10000.0     # in-DSI nodata (quick.param "DSI Nodata Value")


# ---------------------------------------------------------------------------
# INI dialect parser
# ---------------------------------------------------------------------------

def parse_param_ini(text: str) -> Dict[str, Dict[str, str]]:
    """Parse the engine INI dialect: ``[Section Name]`` headers and
    ``Key With Spaces = value`` lines; later duplicate sections merge."""
    sections: Dict[str, Dict[str, str]] = {}
    current: Optional[Dict[str, str]] = None
    for raw in text.splitlines():
        line = raw.strip().rstrip("\r")
        if not line or line.startswith(("#", ";")):
            continue
        m = re.match(r"^\[(.+)\]$", line)
        if m:
            name = m.group(1).strip()
            current = sections.setdefault(name, {})
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            current[key.strip()] = val.strip()
    return sections


def load_param_file(path: str) -> Dict[str, Dict[str, str]]:
    with open(path, "r", errors="replace") as f:
        return parse_param_ini(f.read())


def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes", "on")


# ---------------------------------------------------------------------------
# Typed profile
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PyramidLevelConfig:
    """One ``[Pyramid N]`` / ``[Pyramid N Subpix]`` section, typed.

    Only the fields that influence the numerical result are retained;
    the engine's I/O-path keys (Input/Output dirs, file patterns) are
    replaced by the framework's io layer.
    """

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
    # not an engine INI key: the cv-style WTA margin filter carried from
    # MatcherConfig.uniqueness_ratio so the flagship path applies it
    # instead of silently dropping it (cfg/i3DR_Disparity.cfg:27)
    uniqueness_ratio: float = 0.0

    @staticmethod
    def from_section(level: int, sec: Mapping[str, str], *, subpix_pass: bool,
                     top_shift: float) -> "PyramidLevelConfig":
        g = sec.get
        dirs = (
            _to_bool(g("SGM South-North Optimization", "true")),
            _to_bool(g("SGM SouthEast-NorthWest Optimization", "true")),
            _to_bool(g("SGM SouthWest-NorthEast Optimization", "true")),
            _to_bool(g("SGM West-East Optimization", "true")),
        )
        p1 = tuple(float(g(f"{k} Penalty 1", "0.1"))
                   for k in ("SN", "SE-NW", "SW-NE", "WE"))
        p2 = tuple(float(g(f"{k} Penalty 2", "0.8"))
                   for k in ("SN", "SE-NW", "SW-NE", "WE"))
        return PyramidLevelConfig(
            level=level,
            enabled=_to_bool(g("Process This Pyramid", "true")),
            subpix_pass=subpix_pass,
            num_disparities=int(float(g("Number Of Disparities", "31"))),
            step_size=float(g("Disparity Step Size", "0.5")),
            census_w=int(float(g("Feature Set Size X", "9"))),
            census_h=int(float(g("Feature Set Size Y", "9"))),
            p1=p1,
            p2=p2,
            directions=dirs,
            backmatch=_to_bool(g("Compute Backmatching", "true")),
            backmatch_dist=float(g("Maximum Backmatching Distance", "1.5")),
            median=_to_bool(g("Disparity Median Optimizer", "true")),
            speckle=_to_bool(g("Disparity Speckle Filter Optimizer", "true")),
            speckle_max_diff=float(g("Disparity Speckle Filter Max Difference", "0.5")),
            speckle_max_region=int(float(g("Disparity Speckle Filter Max Region Size", "100"))),
            subpixel=g("DSI Interpolator", "Parabolic").strip().lower() == "parabolic",
            interpolate_gaps=_to_bool(g("Interpolate Disparity", "true")),
            interpolator_mode=g("Interpolator Mode", "Gauss").strip().lower(),
            interp_directions=int(g("Interpolator Number Of Directions", "32")),
            interp_min_elements=int(
                g("Interpolator Minimum Number Of Elements", "0")),
            interpolate_occlusions=_to_bool(g("Interpolate Occlusions", "true")),
            occlusion_detection=_to_bool(g("Occlusion Detection", "false")),
            prediction_shift=top_shift,
        )


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

    @staticmethod
    def from_sections(name: str, sections: Mapping[str, Mapping[str, str]]) -> "SGMProfile":
        param = sections.get("Parameter", {})
        n_levels = int(float(param.get("Pyramid Levels", "6")))
        top_shift = float(param.get("Top Prediction Shift", "-5"))
        levels: List[PyramidLevelConfig] = []
        # coarse (highest index) -> fine (0); subpix refinement after each.
        for lv in range(n_levels - 1, -1, -1):
            main = sections.get(f"Pyramid {lv}")
            if main is not None:
                levels.append(PyramidLevelConfig.from_section(
                    lv, main, subpix_pass=False,
                    top_shift=top_shift if lv == n_levels - 1 else 0.0))
            sub = sections.get(f"Pyramid {lv} Subpix")
            if sub is not None:
                levels.append(PyramidLevelConfig.from_section(
                    lv, sub, subpix_pass=True, top_shift=0.0))
        use_cpu = _to_bool(sections.get("Pyramid 0", {}).get("Use CPU SGM", "false"))
        return SGMProfile(name=name, levels=tuple(levels), use_cpu=use_cpu)

    @staticmethod
    def from_param_file(path: str, name: Optional[str] = None) -> "SGMProfile":
        return SGMProfile.from_sections(name or path, load_param_file(path))

    def with_levels_enabled(self, min_level: int, max_level: int) -> "SGMProfile":
        """Reference `enablePyramid`/`maxPyramid` semantics
        (I3DRSGM.cpp:405-469): enable main passes within [min, max]."""
        new = tuple(
            dataclasses.replace(lv, enabled=(min_level <= lv.level <= max_level)
                                if not lv.subpix_pass else lv.enabled)
            for lv in self.levels
        )
        return dataclasses.replace(self, levels=new)


def _default_levels(*, n_levels: int, subpix_on_finest: bool,
                    enabled_main: bool, top_shift: float) -> tuple:
    """The semantic content of the shipped quick/subpix profiles:
    6 pyramid levels, census 9x9, 31 disparities/level, step 0.5,
    4 directions P1=0.1 P2=0.8, LR-check 1.5, speckle (0.5, 100),
    median 3x3 (quick.param:56,97,99,105-106,122,128,142-167)."""
    levels = []
    for lv in range(n_levels - 1, -1, -1):
        levels.append(PyramidLevelConfig(
            level=lv,
            enabled=True if lv == n_levels - 1 else enabled_main,
            subpix_pass=False,
            prediction_shift=top_shift if lv == n_levels - 1 else 0.0,
        ))
        if lv == 0 and subpix_on_finest:
            levels.append(PyramidLevelConfig(level=0, enabled=True,
                                             subpix_pass=True, step_size=0.5))
    return tuple(levels)


def quick_profile() -> SGMProfile:
    """In-code equivalent of ini/quick.param: all main pyramid passes,
    coarse-to-fine shift prediction (Top Prediction Shift = -5)."""
    return SGMProfile(name="quick",
                      levels=_default_levels(n_levels=6, subpix_on_finest=False,
                                             enabled_main=True, top_shift=-5.0))


def subpix_profile() -> SGMProfile:
    """In-code equivalent of ini/subpix.param: adds the half-pel subpix
    refinement pass on the finest level (Top Prediction Shift = 8)."""
    return SGMProfile(name="subpix",
                      levels=_default_levels(n_levels=6, subpix_on_finest=True,
                                             enabled_main=True, top_shift=8.0))


# ---------------------------------------------------------------------------
# ROS-parameter unit conventions (I3DRSGM.cpp quirks)
# ---------------------------------------------------------------------------

def from_ros_convention(*, p1: Optional[float] = None, p2: Optional[float] = None,
                        disparity_range: Optional[int] = None,
                        speckle_range: Optional[float] = None,
                        min_disparity: Optional[float] = None,
                        subpix: bool = False) -> dict:
    """Convert reference launch-file I3DRSGM parameter values into engine
    units, reproducing the wrapper's conversions so existing launch
    profiles keep their meaning:

    - ``setP1/setP2``: INI value = ros / 1000 (÷10 more for subpix
      sections) — I3DRSGM.cpp:294-330.
    - ``setDisparityRange``: INI "Number Of Disparities" = ros / 10,
      forced odd — I3DRSGM.cpp:491-508.
    - ``setSpeckle*``: ÷10 — I3DRSGM.cpp:249-287.
    - ``setMinDisparity``: "Top Prediction Shift" = ros / 20 —
      I3DRSGM.cpp:390-403.
    """
    out = {}
    scale = 1000.0 * (10.0 if subpix else 1.0)
    if p1 is not None:
        out["p1"] = p1 / scale
    if p2 is not None:
        out["p2"] = p2 / scale
    if disparity_range is not None:
        n = int(disparity_range / 10)
        if n % 2 == 0:
            n += 1
        out["num_disparities"] = n
    if speckle_range is not None:
        out["speckle_max_diff"] = speckle_range / 10.0
    if min_disparity is not None:
        out["prediction_shift"] = min_disparity / 20.0
    return out
