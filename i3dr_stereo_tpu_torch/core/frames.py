"""Rig kinematics: the TF frame tree of the reference's URDF, as code.

Re-creates the frame graph of urdf/i3dr_stereo_camera.urdf.xacro
(parametric macro: baseline, per-camera toe-in, mount/camera offsets,
optional IMU, urdf lines 8-96) without xacro/URDF machinery: a typed rig
description expands into a dict of 4x4 homogeneous transforms with the
same frame names (<name>_cameraLeft_optical, <name>_depth_optical_frame,
...), usable to place point clouds in a world/robot frame or export TF.

Conventions preserved from the reference:
- camera body frames sit +-baseline/2 along the centre's y axis
  (left +y, right -y; urdf:40-52),
- optical frames apply the ROS optical rotation rpy(-pi/2, 0, -pi/2)
  with the toe-in added around the final z (urdf:55-67),
- the depth optical frame hangs off the RIGHT camera body (urdf:69-73),
- mount joint lifts the centre by height/2 and yaws -pi/2 (urdf:84-88),
- IMU alignment rotates pi/2 about y (Z -> X; urdf:91-96).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """URDF rpy convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def transform(xyz=(0.0, 0.0, 0.0), rpy=(0.0, 0.0, 0.0)) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = rpy_matrix(*rpy)
    T[:3, 3] = xyz
    return T


@dataclasses.dataclass(frozen=True)
class RigDescription:
    """Parameters of the reference xacro macro (same names/semantics)."""

    camera_name: str = "i3dr_stereo"
    baseline: float = 0.30
    toe_in_l: float = 0.0   # degrees
    toe_in_r: float = 0.0
    width: float = 0.1
    height: float = 0.1
    length: float = 0.3
    imu_en: bool = True
    camera_offset: tuple = (0.0, 0.0, 0.0)
    mount_offset: tuple = (0.0, 0.0, 0.0)

    def frame_tree(self) -> Dict[str, np.ndarray]:
        """All frames as transforms relative to <name>_base_link (or the
        IMU link when imu_en, which then parents base_link)."""
        n = self.camera_name
        pi = math.pi
        ox, oy, oz = self.camera_offset
        mx, my, mz = self.mount_offset

        frames: Dict[str, np.ndarray] = {}
        root = f"{n}_imu_link" if self.imu_en else f"{n}_base_link"
        frames[root] = np.eye(4)
        if self.imu_en:
            # imu joint: rpy(0, pi/2, 0), Z -> X (urdf:91-96)
            frames[f"{n}_base_link"] = frames[root] @ transform(
                rpy=(0, pi / 2, 0))
        base = frames[f"{n}_base_link"]
        # mount joint (urdf:84-88)
        frames[f"{n}_center"] = base @ transform(
            xyz=(mx, my, self.height / 2 + mz), rpy=(0, 0, -pi / 2))
        center = frames[f"{n}_center"]
        # camera bodies (urdf:40-52)
        frames[f"{n}_cameraLeft"] = center @ transform(
            xyz=(ox, self.baseline / 2 + oy, oz))
        frames[f"{n}_cameraRight"] = center @ transform(
            xyz=(ox, -(self.baseline / 2) - oy, oz))
        # optical frames with toe-in (urdf:55-67)
        frames[f"{n}_cameraLeft_optical"] = frames[f"{n}_cameraLeft"] @ transform(
            rpy=(-pi / 2, 0, -pi / 2 - math.radians(self.toe_in_l)))
        frames[f"{n}_cameraRight_optical"] = frames[f"{n}_cameraRight"] @ transform(
            rpy=(-pi / 2, 0, -pi / 2 + math.radians(self.toe_in_r)))
        # depth optical frame off the right camera (urdf:69-73)
        frames[f"{n}_depth_optical_frame"] = frames[f"{n}_cameraRight"] @ transform(
            rpy=(-pi / 2, 0, -pi / 2))
        return frames


def transform_points(T: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to (N, 3) points."""
    return xyz @ T[:3, :3].T + T[:3, 3]


def points_to_frame(frames: Dict[str, np.ndarray], from_frame: str,
                    to_frame: str, xyz: np.ndarray) -> np.ndarray:
    """Re-express points given in from_frame into to_frame."""
    T = np.linalg.inv(frames[to_frame]) @ frames[from_frame]
    return transform_points(T, xyz)
