"""Node-level equivalents of the reference's executables.

Each class re-creates one reference node's topic/service surface on the
in-process graph, backed by the fused TPU pipeline instead of separate
OS processes:

- :class:`GenerateDisparityNode` <- src/generate_disparity.cpp (topics
  image_rect/disparity, save_stereo service, 2 reconfigure servers,
  algorithm hot-swap)
- :class:`RectifyNode`           <- src/rectify.cpp (standalone
  rectification + save_rectified service)
- :class:`DisparityToDepthNode`  <- src/disparity_to_depth.cpp
- :class:`CropByDisparityNode`   <- src/crop_image_by_disparity.cpp
  (lazy: computes only when subscribed, cpp:91)
- :class:`CameraControlNode`     <- src/tiscamera_ctrl.py (property
  services, settings reconfigure, laser-split republish)
- :class:`TriggerNode`           <- src/tiscamera_trigger.py (Bool topic)
- :func:`warmup_matchers`        <- src/init_stereo_matchers.cpp (ahead-
  of-time compile of the selected backend = the CUDA-JIT warmup analog)

Torch port of ``i3dr_stereo_tpu.bridge.nodes``: the nodes that compute
take ``device`` (the card unless the caller asks for the CPU; a missing
card raises) and publish host numpy payloads, as the reference's do;
:class:`GenerateDisparityNode` copies a card's outputs into reused
page-locked buffers (:func:`host_copies`, ``bridge/pinned.py``).
PyTorch runs eagerly, so where the reference wraps the depth and crop
ops in ``jax.jit`` the port calls them directly, reading the depth
bounds on every call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from i3dr_stereo_tpu_torch.bridge.graph import Graph, Node
from i3dr_stereo_tpu_torch.bridge.pinned import PinnedPool
from i3dr_stereo_tpu_torch.bridge.reconfigure import (
    CAMERA_SCHEMA,
    DISPARITY_SCHEMA,
    POINTCLOUD_SCHEMA,
    ReconfigureServer,
    apply_camera_params,
    apply_cloud_params,
    apply_flat_params,
)
from i3dr_stereo_tpu_torch.bridge.services import (
    SaveRectifiedRequest,
    SaveRectifiedResponse,
    SaveStereoRequest,
    SaveStereoResponse,
)
from i3dr_stereo_tpu_torch.config.params import CameraSettings, MatcherConfig, PointCloudConfig
from i3dr_stereo_tpu_torch._build import resolve_device
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.core.frame import to_numpy
from i3dr_stereo_tpu_torch.io.savers import save_stereo, save_png
from i3dr_stereo_tpu_torch.ops.depth import pointcloud_to_numpy
from i3dr_stereo_tpu_torch.pipeline.pairing import ApproximateTimeSync
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS as METRICS


def host_copies(pool: PinnedPool, outputs: list) -> list:
    """Host numpy arrays of ``outputs``, ``(topic, value)`` pairs, one
    ``node.copy`` span each (``topic``, ``bytes``). A tensor on a CUDA
    device is copied by DMA into a page-locked buffer of ``pool``,
    enqueued without a wait, and its span also carries ``pinned`` and
    ``fresh`` (the bytes the pool newly allocated); the last span waits
    once for all of them (the outputs of one frame share a device), so
    the spans cover the whole copy stage. Anything else goes through
    ``to_numpy``."""
    arrays, stream = [], None
    for i, (topic, x) in enumerate(outputs):
        with METRICS.span("node.copy", topic=topic) as span:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                a, fresh = pool.copy(x)
                stream = torch.cuda.current_stream(x.device)
                span.set(pinned=1, fresh=fresh)
            else:
                a = to_numpy(x)
            if i == len(outputs) - 1 and stream is not None:
                stream.record_event().synchronize()
            span.set(bytes=a.nbytes)
        arrays.append(a)
    return arrays


class GenerateDisparityNode(Node):
    """The central pipeline node (generate_disparity.cpp).

    Subscribes <ns>/left|right/image_raw, publishes
    <ns>/left|right/image_rect, <ns>/disparity, <ns>/depth, <ns>/points2
    (the last two were a separate process in the reference — here they
    are free outputs of the same fused program)."""

    def __init__(self, graph: Graph, rig: StereoRig, config: MatcherConfig,
                 cloud: PointCloudConfig = PointCloudConfig(),
                 namespace: str = "/stereo", name: str = "generate_disparity",
                 rectify: bool = True, slop: float = 0.05, remaps=None,
                 device="cuda"):
        super().__init__(graph, name, namespace, remaps or {})
        self.pipeline = StereoPipeline(rig=rig, config=config, cloud=cloud,
                                       device=device,
                                       rectify_inputs=rectify,
                                       compute_crop=False)
        self._sync = ApproximateTimeSync(slop=slop)
        self._last = None  # cached state for save_stereo
        self._pinned = PinnedPool()
        self.frames_processed = 0
        self.frames_dropped = 0

        self.subscribe("left/image_raw", self._on_left)
        self.subscribe("right/image_raw", self._on_right)
        self.advertise_service("save_stereo", self.save_stereo)
        # two reconfigure servers, like the reference (cpp:968-977)
        self.disparity_cfg = ReconfigureServer(
            DISPARITY_SCHEMA, self._on_disparity_reconf,
            initial=_config_to_flat(self.pipeline.config))
        self.cloud_cfg = ReconfigureServer(
            POINTCLOUD_SCHEMA, self._on_cloud_reconf,
            initial=dataclasses.asdict(cloud))

    # -- topic callbacks ------------------------------------------------------
    def _on_left(self, stamp, img):
        self._sync.push_left(stamp, img)
        self._drain()

    def _on_right(self, stamp, img):
        self._sync.push_right(stamp, img)
        self._drain()

    def _drain(self):
        for l, r in self._sync.pop_pairs():
            self._process(l.stamp, l.data, r.data)

    def _process(self, stamp, left, right):
        with METRICS.span("node.frame", stamp=stamp):
            try:
                res = self.pipeline.process(left, right)
            except Exception as e:  # match failure: drop frame, keep running
                self.frames_dropped += 1
                self._publish("match_errors", stamp, repr(e))
                return
            self.frames_processed += 1
            self._last = (stamp, left, right, res)
            outputs = [("left/image_rect", res.rect_left),
                       ("right/image_rect", res.rect_right),
                       ("disparity", res.disparity),
                       ("disparity", res.valid)]
            if res.depth is not None:
                outputs.append(("depth", res.depth))
            if res.points is not None:
                outputs += [("points2", v) for v in res.points.values()]
            host = iter(host_copies(self._pinned, outputs))
            self._publish("left/image_rect", stamp, next(host))
            self._publish("right/image_rect", stamp, next(host))
            self._publish("disparity", stamp, {
                "disparity": next(host),
                "valid": next(host),
                "min_disparity": self.pipeline.config.min_disparity,
                "disparity_range": self.pipeline.config.disparity_range,
                "f": self.pipeline.rig.fx,
                "T": self.pipeline.rig.baseline,
            })
            if res.depth is not None:
                self._publish("depth", stamp, next(host))
            if res.points is not None:
                self._publish("points2", stamp,
                              {k: next(host) for k in res.points})

    def _publish(self, topic, stamp, data):
        with METRICS.span("node.publish", topic=topic):
            self.publish(topic, stamp, data)

    # -- reconfigure ----------------------------------------------------------
    def _on_disparity_reconf(self, flat, changed):
        # apply only the keys that changed: re-coercing the whole flat
        # dict would clamp unrelated fields through the schema's types
        # (e.g. engine speckle_range 0.5 -> int 0). Nothing to rebuild:
        # every call runs the current config, numeric fields reach the
        # kernels as runtime scalars (cf. I3DRSGM.cpp:630-654)
        self.pipeline.config = apply_flat_params(
            self.pipeline.config, {k: flat[k] for k in changed})

    def _on_cloud_reconf(self, flat, changed):
        self.pipeline.cloud = apply_cloud_params(
            self.pipeline.cloud, {k: flat[k] for k in changed})

    # -- services -------------------------------------------------------------
    def save_stereo(self, req: SaveStereoRequest) -> SaveStereoResponse:
        if self._last is None:
            return SaveStereoResponse(res="no frame yet", ok=False)
        stamp, left, right, res = self._last
        xyz = rgb = None
        if res.points is not None:
            xyz, rgb = pointcloud_to_numpy(res.points)
        paths = save_stereo(
            req.folderpath, seq=self.frames_processed,
            left_raw=to_numpy(left), right_raw=to_numpy(right),
            left_rect=to_numpy(res.rect_left),
            right_rect=to_numpy(res.rect_right),
            disparity=to_numpy(res.disparity), valid=to_numpy(res.valid),
            points_xyz=xyz, points_rgb=rgb,
            save_rectified=req.save_rectified,
            save_disparity=req.save_disparity,
            save_point_cloud=req.save_point_cloud,
            binary_ply=self.pipeline.cloud.save_points_as_binary)
        return SaveStereoResponse(res="saved", ok=True, paths=paths)


class RectifyNode(Node):
    """Standalone rectification (rectify.cpp): image_raw -> image_rect
    with a save_rectified service. Used for the no-laser stream and bag
    replay in the reference (stereo_matcher.launch:180-185)."""

    def __init__(self, graph: Graph, rig: StereoRig, namespace="/stereo",
                 name="rectify", remaps=None, device="cuda"):
        super().__init__(graph, name, namespace, remaps or {})
        from i3dr_stereo_tpu_torch.ops.rectify import make_rectify_map, remap

        self.device = resolve_device(device)
        self._maps = (make_rectify_map(rig.left, device=self.device),
                      make_rectify_map(rig.right, device=self.device))
        self._remap = remap
        self._last = {}
        self.subscribe("left/image_raw", lambda s, d: self._on(0, "left", s, d))
        self.subscribe("right/image_raw", lambda s, d: self._on(1, "right", s, d))
        self.advertise_service("save_rectified", self.save_rectified)

    def _on(self, idx, side, stamp, img):
        src = torch.as_tensor(np.asarray(img, dtype=np.float32),
                              device=self.device)
        out = to_numpy(self._remap(src, self._maps[idx]))
        self._last[side] = out
        self.publish(f"{side}/image_rect", stamp, out)

    def save_rectified(self, req: SaveRectifiedRequest) -> SaveRectifiedResponse:
        if not self._last:
            return SaveRectifiedResponse(res="no frame yet", ok=False)
        import os

        os.makedirs(req.folderpath, exist_ok=True)
        paths = {}
        for side, img in self._last.items():
            paths[side] = save_png(
                os.path.join(req.folderpath, f"{side}_rect.png"), img)
        return SaveRectifiedResponse(res="saved", ok=True, paths=paths)


class DisparityToDepthNode(Node):
    """disparity_to_depth.cpp as a subscriber node (for graphs that run
    the matcher without fused depth, e.g. external disparity sources).

    Disparity and rect-left are ApproximateTime-synced by stamp before a
    cloud is produced, matching the reference's 3-way synchronizer of
    disparity + rect + infos (disparity_to_depth.cpp:55-57, 274-280; the
    camera infos are static here — the rig passed at construction). An
    out-of-order rect frame therefore can no longer color/mask the cloud
    of a different frame."""

    def __init__(self, graph: Graph, rig: StereoRig, namespace="/stereo",
                 name="disparity_to_depth", depth_max=10.0, depth_min=0.0,
                 slop=0.05, remaps=None, device="cuda"):
        super().__init__(graph, name, namespace, remaps or {})
        from i3dr_stereo_tpu_torch.ops.depth import disparity_to_depth, disparity_to_pointcloud

        self.device = resolve_device(device)
        Q = torch.as_tensor(rig.Q, dtype=torch.float32, device=self.device)
        # the bounds are read on every call, so a change reaches the next
        # frame (the reference's jax.jit closes over them at its first
        # trace)
        self.depth_max, self.depth_min = depth_max, depth_min
        self._depth = lambda d, v: disparity_to_depth(
            d, v, Q, self.depth_min, self.depth_max)
        self._points = lambda d, v, g: disparity_to_pointcloud(
            d, v, Q, g, self.depth_min, self.depth_max)
        self._sync = ApproximateTimeSync(slop=slop)
        self.subscribe("left/image_rect", self._on_rect)
        self.subscribe("disparity", self._on_disp)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=self.device)

    def _on_rect(self, stamp, img):
        self._sync.push_right(stamp, self._tensor(img, np.float32))
        self._drain()

    def _on_disp(self, stamp, msg):
        # depth needs no rect; publish it immediately (reference parity:
        # the depth image is a pure function of disparity + Q)
        d = self._tensor(msg["disparity"], np.float32)
        v = self._tensor(msg["valid"], bool)
        depth, ok = self._depth(d, v)
        self.publish("depth", stamp, to_numpy(depth))
        self._sync.push_left(stamp, (d, v))
        self._drain()

    def _drain(self):
        for disp_msg, rect in self._sync.pop_pairs():
            d, v = disp_msg.data
            if rect.data.shape != d.shape:
                continue
            pts = self._points(d, v, rect.data)
            self.publish("points2", disp_msg.stamp,
                         {k: to_numpy(x) for k, x in pts.items()})


class CropByDisparityNode(Node):
    """crop_image_by_disparity.cpp: left_rect masked by valid disparity;
    lazy — computes only while someone subscribes (cpp:91)."""

    def __init__(self, graph: Graph, namespace="/stereo",
                 name="crop_image_by_disparity", remaps=None, device="cuda"):
        super().__init__(graph, name, namespace, remaps or {})
        from i3dr_stereo_tpu_torch.ops.depth import crop_by_disparity

        self.device = resolve_device(device)
        self._crop = crop_by_disparity
        self._rect = None
        self.subscribe("left/image_rect", self._on_rect)
        self.subscribe("disparity", self._on_disp)

    def _on_rect(self, stamp, img):
        self._rect = np.asarray(img, dtype=np.float32)

    def _on_disp(self, stamp, msg):
        if self.num_subscribers("left/image_rect_disp_cropped") == 0:
            return  # lazy
        if self._rect is None:
            return
        out = self._crop(*(torch.as_tensor(np.asarray(x), device=self.device)
                           for x in (self._rect, msg["disparity"],
                                     msg["valid"])))
        self.publish("left/image_rect_disp_cropped", stamp, to_numpy(out))


class TriggerNode(Node):
    """tiscamera_trigger.py: publishes laser on/off Booleans. The serial
    port is replaced by any callable source (tests drive it directly)."""

    def __init__(self, graph: Graph, name="tiscamera_trigger",
                 topic: str = "/phobos_nuclear_trigger"):
        super().__init__(graph, name, "")
        self._topic = topic

    def fire(self, stamp: float, laser_on: bool):
        self.publish(self._topic, stamp, bool(laser_on))


class CameraControlNode(Node):
    """tiscamera_ctrl.py: per-camera property services
    (tiscam_<serial>_set_*), settings reconfigure server and the
    laser-split republisher driven by the trigger topic."""

    def __init__(self, graph: Graph, serial: str, namespace="/stereo/left",
                 name=None, settings: CameraSettings = CameraSettings(),
                 split_laser: bool = False,
                 trigger_topic: str = "/phobos_nuclear_trigger",
                 apply_fn: Optional[Callable[[CameraSettings], None]] = None):
        super().__init__(graph, name or f"tiscamera_ctrl_{serial}", namespace)
        self.serial = serial
        self.settings = settings.clamp()
        self._apply = apply_fn or (lambda s: None)
        self._laser_on = False

        for prop in ("brightness", "exposure", "gain", "exposure_auto", "gain_auto"):
            self.graph.advertise_service(
                f"/tiscam_{serial}_set_{prop}",
                (lambda p: lambda req: self._set_prop(p, req))(prop))
        self.reconf = ReconfigureServer(CAMERA_SCHEMA, self._on_reconf,
                                        initial=_settings_to_flat(self.settings))
        if split_laser:
            self.graph.subscribe(trigger_topic, self._on_trigger)
            self.subscribe("image_raw", self._on_image)

    def _set_prop(self, prop, req):
        from i3dr_stereo_tpu_torch.bridge.services import SetResponse

        self.settings = dataclasses.replace(
            self.settings, **{prop: getattr(req, "value")}).clamp()
        self._apply(self.settings)
        return SetResponse(res=f"{prop}={getattr(self.settings, prop)}", ok=True)

    def _on_reconf(self, flat, changed):
        self.settings = apply_camera_params(self.settings, flat)
        self._apply(self.settings)

    def _on_trigger(self, stamp, laser_on: bool):
        self._laser_on = bool(laser_on)

    def _on_image(self, stamp, img):
        suffix = "with_laser" if self._laser_on else "no_laser"
        self.publish(f"image_raw_{suffix}", stamp, img)


def warmup_matchers(config: MatcherConfig, shape=(32, 32),
                    device="cuda") -> bool:
    """init_stereo_matchers.cpp analog: build the kernels (on the card)
    and push a small zero pair through the configured matcher before the
    first real frame."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.matchers.base import create_matcher

    device = resolve_device(device)
    if device.type == "cuda":
        _build.library()
    m = create_matcher(config.replace(disparity_range=16, speckle_size=0),
                       device=device)
    res = m.match(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
    return tuple(res.disparity.shape) == tuple(shape)


# -- helpers -----------------------------------------------------------------

def _config_to_flat(cfg: MatcherConfig) -> dict:
    return {
        "stereo_algorithm": int(cfg.algorithm),
        "prefilter_size": cfg.prefilter_size,
        "prefilter_cap": cfg.prefilter_cap,
        "correlation_window_size": cfg.window_size,
        "min_disparity": cfg.min_disparity,
        "disparity_range": cfg.disparity_range,
        "uniqueness_ratio": cfg.uniqueness_ratio,
        "texture_threshold": int(cfg.texture_threshold),
        "speckle_size": cfg.speckle_size,
        "speckle_range": int(cfg.speckle_range),
        "fullDP": cfg.num_directions == 8,
        "p1": cfg.p1,
        "p2": cfg.p2,
        "disp12MaxDiff": int(max(cfg.disp12_max_diff, 0)),
        "interp": cfg.interp,
    }


def _settings_to_flat(s: CameraSettings) -> dict:
    return {"Brightness": s.brightness, "Exposure": s.exposure, "Gain": s.gain,
            "Exposure_Auto": s.exposure_auto, "Gain_Auto": s.gain_auto}
