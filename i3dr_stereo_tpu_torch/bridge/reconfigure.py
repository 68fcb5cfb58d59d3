"""Dynamic reconfigure: schema'd live parameter servers.

Mirrors the reference's dynamic_reconfigure usage — schemas generated
from cfg/*.cfg with ranges and an enum of algorithms
(cfg/i3DR_Disparity.cfg:11-39), the first-callback-writes-back
initialization idiom (generate_disparity.cpp:737-756) and constraint
fixups (:759-775). Here a schema is data, a server owns a current config
dataclass, and updates clamp -> fixup -> notify; the pipeline then
re-jits only if a shape-affecting field changed — numeric params
(p1/p2, uniqueness, texture, speckle diff, backmatch dist, depth
bounds) are TRACED arguments of the compiled step
(StereoPipeline.DYN_FIELDS), so tuning them costs nothing, instead of
the reference's full engine rebuild per setter (I3DRSGM.cpp:630-654).
:func:`bind_pipeline` wires a server to a running StereoPipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from i3dr_stereo_tpu_torch.config.params import (
    Algorithm,
    CameraSettings,
    MatcherConfig,
    PointCloudConfig,
)


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    name: str
    type: str              # "int" | "double" | "bool" | "enum"
    default: Any
    min: Any = None
    max: Any = None
    choices: Optional[dict] = None  # enum: {name: value}
    description: str = ""


# cfg/i3DR_Disparity.cfg:11-39, field-for-field
DISPARITY_SCHEMA: List[ParamDesc] = [
    ParamDesc("stereo_algorithm", "enum", 0, 0, 5,
              {a.name: int(a) for a in Algorithm}, "stereo algorithm"),
    ParamDesc("prefilter_size", "int", 9, 5, 255, None, "Normalization window size, pixels"),
    ParamDesc("prefilter_cap", "int", 31, 1, 63, None, "Bound on normalized pixel values"),
    ParamDesc("correlation_window_size", "int", 15, 5, 255, None, "SAD correlation window width, pixels"),
    ParamDesc("min_disparity", "int", 0, -2056, 2056, None, "Disparity to begin search at, pixels"),
    ParamDesc("disparity_range", "int", 64, 16, 2056, None, "Number of disparities to search, pixels"),
    ParamDesc("uniqueness_ratio", "double", 15.0, 0.0, 100.0, None, "Best-vs-next-best margin filter"),
    ParamDesc("texture_threshold", "int", 10, 0, 10000, None, "SAD window response threshold"),
    ParamDesc("speckle_size", "int", 100, 0, 1000, None, "Reject regions smaller than this size, pixels"),
    ParamDesc("speckle_range", "int", 4, 0, 31, None, "Max allowed difference between detected disparities"),
    ParamDesc("fullDP", "bool", False, None, None, None, "Run the full variant (SGBM)"),
    ParamDesc("p1", "double", 200.0, 0.0, 4000.0, None, "First smoothness parameter (SGBM)"),
    ParamDesc("p2", "double", 400.0, 0.0, 4000.0, None, "Second smoothness parameter (SGBM)"),
    ParamDesc("disp12MaxDiff", "int", 0, 0, 128, None, "Max left-right disparity check difference"),
    ParamDesc("interp", "bool", False, None, None, None, "Interpolation with backward matching"),
]

# cfg/i3DR_pointCloud.cfg
POINTCLOUD_SCHEMA: List[ParamDesc] = [
    ParamDesc("depth_max", "double", 10.0, 0.0, 20.0, None, "Maximum depth (m)"),
    ParamDesc("depth_min", "double", 10.0, 0.0, 20.0, None, "Minimum depth (m)"),
    ParamDesc("save_points_as_binary", "bool", False, None, None, None,
              "Save point cloud as binary"),
]

# cfg/tiscamera_settings.cfg
CAMERA_SCHEMA: List[ParamDesc] = [
    ParamDesc("Brightness", "int", 0, 0, 4095),
    ParamDesc("Exposure_Auto", "bool", False),
    ParamDesc("Gain_Auto", "bool", False),
    ParamDesc("Exposure", "int", 6000, 20, 100000),
    ParamDesc("Gain", "int", 0, 0, 480),
]


def _clamp(desc: ParamDesc, value):
    if desc.type == "bool":
        return bool(value)
    if desc.type == "enum":
        v = int(value)
        return min(max(v, desc.min), desc.max)
    v = float(value) if desc.type == "double" else int(value)
    if desc.min is not None:
        v = max(v, desc.min)
    if desc.max is not None:
        v = min(v, desc.max)
    return v


class ReconfigureServer:
    """Holds a flat param dict validated against a schema; notifies a
    callback with (config_dict, changed_keys)."""

    def __init__(self, schema: List[ParamDesc],
                 callback: Optional[Callable[[Dict[str, Any], List[str]], None]] = None,
                 initial: Optional[Dict[str, Any]] = None):
        self.schema = {d.name: d for d in schema}
        self.values: Dict[str, Any] = {d.name: d.default for d in schema}
        if initial:
            for k, v in initial.items():
                if k in self.schema:
                    self.values[k] = _clamp(self.schema[k], v)
        self._cb = callback
        # NOTE the reference's first-callback-writes-back idiom
        # (generate_disparity.cpp:737-756) pushes the NODE's initial
        # values into the GUI — never the schema defaults into the node.
        # Here that direction is the ``initial=`` seeding above; invoking
        # the callback at construction would push schema-clamped values
        # back into the owner (e.g. float speckle_range 0.5 -> int 0,
        # which speckle-filters away every pixel), so we do not.

    def update(self, **kw) -> Dict[str, Any]:
        changed = []
        for k, v in kw.items():
            if k not in self.schema:
                raise KeyError(f"unknown parameter {k!r}")
            nv = _clamp(self.schema[k], v)
            if nv != self.values[k]:
                self.values[k] = nv
                changed.append(k)
        if changed and self._cb:
            self._cb(dict(self.values), changed)
        return dict(self.values)

    def get(self) -> Dict[str, Any]:
        return dict(self.values)

    def describe(self) -> List[ParamDesc]:
        return list(self.schema.values())


# --- mapping between the flat reference names and MatcherConfig fields ------

_FLAT_TO_CFG = {
    "stereo_algorithm": "algorithm",
    "prefilter_size": "prefilter_size",
    "prefilter_cap": "prefilter_cap",
    "correlation_window_size": "window_size",
    "min_disparity": "min_disparity",
    "disparity_range": "disparity_range",
    "uniqueness_ratio": "uniqueness_ratio",
    "texture_threshold": "texture_threshold",
    "speckle_size": "speckle_size",
    "speckle_range": "speckle_range",
    "p1": "p1",
    "p2": "p2",
    "disp12MaxDiff": "disp12_max_diff",
    "interp": "interp",
}


def apply_flat_params(cfg: MatcherConfig, flat: Dict[str, Any]) -> MatcherConfig:
    """Flat reference-named dict -> sanitized MatcherConfig."""
    kw: Dict[str, Any] = {}
    for flat_name, field in _FLAT_TO_CFG.items():
        if flat_name in flat:
            v = flat[flat_name]
            if field == "algorithm":
                v = Algorithm(int(v))
            kw[field] = v
    if "fullDP" in flat:
        # fullDP toggles 5 <-> 8 path SGBM; a 4-direction engine profile
        # (I3DRSGM quick.param:144-147) is not "fullDP off", leave it be
        if flat["fullDP"]:
            kw["num_directions"] = 8
        elif cfg.num_directions == 8:
            kw["num_directions"] = 5
    return cfg.replace(**kw)


def apply_cloud_params(cloud: PointCloudConfig, flat: Dict[str, Any]) -> PointCloudConfig:
    kw = {}
    for k in ("depth_max", "depth_min", "save_points_as_binary"):
        if k in flat:
            kw[k] = flat[k]
    return dataclasses.replace(cloud, **kw)


_CLOUD_KEYS = ("depth_max", "depth_min", "save_points_as_binary")


def bind_pipeline(pipe, include_cloud: bool = True) -> ReconfigureServer:
    """One live reconfigure server driving a running StereoPipeline —
    the rqt_reconfigure analog (launch/stereo_matcher.launch:209).

    Flat reference-named updates map onto the pipeline's typed config;
    only CHANGED keys are applied (the first-callback-writes-back
    direction: the pipeline's current values seed the server, schema
    defaults never overwrite the node). Changes confined to
    StereoPipeline.DYN_FIELDS + depth bounds reuse the compiled step.
    """
    schema = list(DISPARITY_SCHEMA) + (list(POINTCLOUD_SCHEMA)
                                       if include_cloud else [])
    initial: Dict[str, Any] = {}
    for flat_name, field in _FLAT_TO_CFG.items():
        v = getattr(pipe.config, field)
        initial[flat_name] = int(v) if flat_name == "stereo_algorithm" else v
    initial["fullDP"] = pipe.config.num_directions == 8
    if include_cloud:
        for k in _CLOUD_KEYS:
            initial[k] = getattr(pipe.cloud, k)

    def _cb(values: Dict[str, Any], changed: List[str]) -> None:
        flat = {k: values[k] for k in changed
                if k in _FLAT_TO_CFG or k == "fullDP"}
        if flat:
            pipe.config = apply_flat_params(pipe.config, flat)
        cloud_kw = {k: values[k] for k in changed if k in _CLOUD_KEYS}
        if cloud_kw:
            pipe.update_cloud(**cloud_kw)

    return ReconfigureServer(schema, callback=_cb, initial=initial)


def apply_camera_params(s: CameraSettings, flat: Dict[str, Any]) -> CameraSettings:
    m = {"Brightness": "brightness", "Exposure": "exposure", "Gain": "gain",
         "Exposure_Auto": "exposure_auto", "Gain_Auto": "gain_auto"}
    kw = {m[k]: v for k, v in flat.items() if k in m}
    return dataclasses.replace(s, **kw).clamp()
