"""The stereo pipeline: rectify -> match -> depth-range clamp -> depth,
cloud, crop (torch port of ``i3dr_stereo_tpu.pipeline.stereo_pipeline``).

The rectification maps depend only on the calibration, so they are built
once per rig (:meth:`StereoPipeline.set_rig` rebuilds them) on the
pipeline's device, and every frame is one ``remap`` launch for both images.
Every call runs the current config: its numeric fields (P1/P2,
uniqueness, backmatch distance, speckle range) reach the kernels as
scalars, and the depth bounds as runtime scalars, each made on the device
once a value (:meth:`StereoPipeline._scalar`). On the card the pyramid
matcher and CSBP replay a CUDA graph captured for the config
(``matchers/pyramid.py:PyramidGraphs``), so a change through
:meth:`StereoPipeline.update_config` costs one eager frame and one
captured frame, then replays; ``update_cloud`` rebuilds nothing. The
pipeline runs on the card (``device="cuda"``, the
default) and launches the kernels there, or raises where there is none:
it never falls back. ``device="cpu"`` runs the plain torch twins of the
kernels. ``lean=True`` passes the matchers' ``lean`` argument on (the
reference's ``I3DR_SGM_BACKEND=pallas`` branch: the fused cost + SGM
path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from i3dr_stereo_tpu_torch._build import resolve_device
from i3dr_stereo_tpu_torch.config.params import MatcherConfig, PointCloudConfig
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.core.frame import to_mono_f32
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.matchers.registry import MATCHER_REGISTRY
from i3dr_stereo_tpu_torch.ops.depth import (
    MISSING_Z,
    crop_by_disparity,
    disparity_to_depth,
    disparity_to_pointcloud,
)
from i3dr_stereo_tpu_torch.ops.rectify import make_rectify_map, rectify_pair
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS as METRICS


@dataclasses.dataclass(frozen=True)
class PipelineResult:
    """Everything the reference publishes."""

    rect_left: torch.Tensor            # (..., H, W) float32
    rect_right: torch.Tensor
    disparity: torch.Tensor            # absolute pixels, float32
    valid: torch.Tensor                # bool
    depth: Optional[torch.Tensor] = None        # metres, 0 where invalid
    depth_valid: Optional[torch.Tensor] = None
    points: Optional[dict] = None               # {"xyz","valid","rgb"} flattened
    cropped_left: Optional[torch.Tensor] = None

    def disparity_missing_z(self) -> torch.Tensor:
        return torch.where(self.valid, self.disparity, MISSING_Z)


def _resolve_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


@dataclasses.dataclass
class StereoPipeline:
    """Host-side facade: calibration constants + the per-frame step."""

    rig: StereoRig
    config: MatcherConfig
    cloud: PointCloudConfig = dataclasses.field(default_factory=PointCloudConfig)
    device: torch.device | str = "cuda"
    interpolation: str = "cubic"
    compute_depth: bool = True
    compute_points: bool = True
    compute_crop: bool = False
    rectify_inputs: bool = True
    lean: bool = False

    def __post_init__(self):
        self.config = self.config.sanitize()
        self.device = _resolve_device(self.device)
        if self.rectify_inputs:
            self._lmap = make_rectify_map(self.rig.left,
                                          interpolation=self.interpolation,
                                          device=self.device)
            self._rmap = make_rectify_map(self.rig.right,
                                          interpolation=self.interpolation,
                                          device=self.device)
        else:
            self._lmap = self._rmap = None
        self._Q = torch.as_tensor(self.rig.Q, dtype=torch.float32,
                                  device=self.device)
        self._scalars = {}

    # -- live reconfigure ------------------------------------------------------
    def update_config(self, **kw) -> None:
        self.config = self.config.replace(**kw)

    def update_cloud(self, **kw) -> None:
        self.cloud = dataclasses.replace(self.cloud, **kw)

    def set_rig(self, rig: StereoRig) -> None:
        """Switch calibration: rebuilds the rectification maps and Q."""
        self.rig = rig
        self.__post_init__()

    # -- the step --------------------------------------------------------------
    def _scalar(self, v) -> torch.Tensor:
        """``v`` as a float32 scalar on the pipeline's device, made once a
        value and held (16 values at most): a tensor made from the host is
        a copy that waits for the work queued on the device, so made each
        frame after the match it kept the host from queueing the rest of
        the frame while the match ran."""
        t = self._scalars.get(v)
        if t is None:
            if len(self._scalars) >= 16:
                self._scalars.clear()
            t = self._scalars[v] = torch.tensor(v, dtype=torch.float32,
                                                device=self.device)
        return t

    def _remap_input(self, image) -> torch.Tensor:
        x = torch.as_tensor(image, device=self.device)
        # mono uint8 goes into the remap as uint8 (1 byte per source
        # pixel, identical values); colour or float input takes the luma
        # conversion first
        if not (x.dtype == torch.uint8
                and not (x.ndim == 3 and x.shape[-1] == 3)):
            x = to_mono_f32(x)
        return x

    def process(self, left, right) -> PipelineResult:
        """(H, W) or (B, H, W) images (mono or BGR, uint8 or float; raw
        when ``rectify_inputs``, else already rectified) ->
        PipelineResult on the pipeline's device."""
        with METRICS.span("pipeline.process"):
            cfg = self.config
            with METRICS.span("pipeline.upload") as span:
                if self._lmap is None:
                    l, r = (to_mono_f32(torch.as_tensor(x, device=self.device))
                            for x in (left, right))
                else:
                    l, r = self._remap_input(left), self._remap_input(right)
                span.set(bytes=getattr(left, "nbytes", 0)
                         + getattr(right, "nbytes", 0))
            if self._lmap is not None:
                with METRICS.span("pipeline.rectify"):
                    l, r = rectify_pair(l, r, self._lmap, self._rmap)
            with METRICS.span("pipeline.match"):
                res: MatchResult = MATCHER_REGISTRY[cfg.algorithm](
                    l, r, cfg, lean=self.lean)
            disp, valid = res.disparity, res.valid

            # depth-range -> disparity clamp (generate_disparity.cpp:449-452):
            # disparities implying Z outside [depth_min, depth_max] are
            # missing; a bound <= 0 is disabled
            with METRICS.span("pipeline.clamp"):
                depth_min = self._scalar(self.cloud.depth_min)
                depth_max = self._scalar(self.cloud.depth_max)
                fx_t = self._scalar(self.rig.fx * self.rig.baseline)
                min_disp_from_depth = fx_t / torch.where(depth_max > 0,
                                                         depth_max, torch.inf)
                valid = valid & ((depth_max <= 0)
                                 | (disp >= min_disp_from_depth))
                max_disp_from_depth = fx_t / torch.clamp(depth_min, min=1e-6)
                valid = valid & ((depth_min <= 0)
                                 | (disp <= max_disp_from_depth))

            depth = depth_valid = points = cropped = None
            if self.compute_depth:
                with METRICS.span("pipeline.depth"):
                    depth, depth_valid = disparity_to_depth(
                        disp, valid, self._Q, depth_min, depth_max)
            if self.compute_points:
                with METRICS.span("pipeline.cloud"):
                    points = disparity_to_pointcloud(disp, valid, self._Q, l,
                                                     depth_min, depth_max)
            if self.compute_crop:
                cropped = crop_by_disparity(l, disp, valid)
            return PipelineResult(
                rect_left=l, rect_right=r, disparity=disp, valid=valid,
                depth=depth, depth_valid=depth_valid, points=points,
                cropped_left=cropped)

    __call__ = process
