"""Calibration persistence + camera-info publishing.

The reference's only durable state is calibration YAML under
``~/.ros/camera_info/...`` (stereo_capture.launch:38-39), republished per
frame by scripts/yaml2CameraInfo.py:29-49. Equivalents:

- :class:`CalibrationStore` — a directory of ``<camera>.yaml`` files in
  the same ROS schema (so existing calibrations drop in unchanged).
- :class:`CameraInfoPublisherNode` — stamps the stored CameraModel onto
  a ``camera_info`` topic alongside each incoming image, exactly the
  yaml2CameraInfo behavior.
"""

from __future__ import annotations

import os
from typing import Optional

import yaml

from i3dr_stereo_tpu_torch.bridge.graph import Graph, Node
from i3dr_stereo_tpu_torch.core.camera import CameraModel, StereoRig


class CalibrationStore:
    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or os.path.join(
            os.path.expanduser("~"), ".i3dr_stereo_tpu_torch", "camera_info")

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.yaml")

    def save(self, name: str, cam: CameraModel) -> str:
        os.makedirs(self.directory, exist_ok=True)
        p = self._path(name)
        with open(p, "w") as f:
            yaml.safe_dump({"camera_name": name, **cam.to_dict()}, f)
        return p

    def load(self, name: str) -> CameraModel:
        return CameraModel.from_yaml(self._path(name))

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def save_rig(self, name: str, rig: StereoRig) -> tuple:
        return (self.save(f"{name}_left", rig.left),
                self.save(f"{name}_right", rig.right))

    def load_rig(self, name: str) -> StereoRig:
        return StereoRig(self.load(f"{name}_left"), self.load(f"{name}_right"))

    def list(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(f[:-5] for f in os.listdir(self.directory)
                      if f.endswith(".yaml"))


class CameraInfoPublisherNode(Node):
    """yaml2CameraInfo.py analog: republishes the calibration as a
    stamped camera_info message for every image on the paired topic."""

    def __init__(self, graph: Graph, cam: CameraModel, namespace: str,
                 name: str = "camera_info_publisher",
                 image_topic: str = "image_raw",
                 info_topic: str = "camera_info"):
        super().__init__(graph, name, namespace)
        self.cam = cam
        self._info_topic = info_topic
        self.subscribe(image_topic, self._on_image)

    def _on_image(self, stamp, img):
        msg = self.cam.to_dict()
        msg["stamp"] = stamp
        self.publish(self._info_topic, stamp, msg)
