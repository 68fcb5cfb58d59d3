"""Headless 3D point-cloud rendering — the PCL/VTK cloud pane of the
reference GUI (src/StereoGUI/StereoGUI.cpp:68-89, stereo_gui.cpp:126-147)
re-built as a pure-numpy perspective rasterizer, plus canned viewpoints
standing in for the rviz scene presets (rviz/phobos_nuclear_map_scene.rviz,
tcam_gige_scene.rviz).

No GL / VTK / display needed: points are orbit-rotated about the cloud
centroid, perspective-projected, and z-buffered into an RGB image by a
far-to-near vectorized paint (last write wins), with optional splat size
for denser look. Runs anywhere the tests run.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

# the rviz-scene analog: named orbit viewpoints (elev_deg, azim_deg)
VIEWPOINTS: Dict[str, Tuple[float, float]] = {
    "front": (0.0, 0.0),
    "orbit_left": (15.0, -35.0),
    "orbit_right": (15.0, 35.0),
    "top_down": (75.0, 0.0),
}


def _rotation(elev_deg: float, azim_deg: float) -> np.ndarray:
    ce, se = math.cos(math.radians(elev_deg)), math.sin(math.radians(elev_deg))
    ca, sa = math.cos(math.radians(azim_deg)), math.sin(math.radians(azim_deg))
    Ry = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])   # azimuth
    Rx = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]])   # elevation
    return Rx @ Ry


def render_cloud(xyz: np.ndarray, rgb: Optional[np.ndarray] = None, *,
                 width: int = 640, height: int = 480,
                 elev: float = 15.0, azim: float = -35.0,
                 distance: Optional[float] = None,
                 zoom: float = 1.0,
                 point_size: int = 2,
                 background: int = 16,
                 max_points: int = 2_000_000) -> np.ndarray:
    """Render (N, 3) points (+ optional (N, 3) uint8 colors) to an RGB
    image from an orbit viewpoint. Optical-frame convention (z forward,
    y down) like the clouds disparity_to_pointcloud emits."""
    out = np.full((height, width, 3), background, np.uint8)
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    good = np.isfinite(xyz).all(axis=1)
    xyz = xyz[good]
    if rgb is not None:
        rgb = np.asarray(rgb).reshape(-1, 3)[good]
    if len(xyz) == 0:
        return out
    if len(xyz) > max_points:
        sel = np.random.default_rng(0).choice(len(xyz), max_points,
                                              replace=False)
        xyz = xyz[sel]
        rgb = rgb[sel] if rgb is not None else None

    center = xyz.mean(axis=0)
    pts = (xyz - center) @ _rotation(elev, azim).T
    extent = float(np.percentile(np.linalg.norm(pts, axis=1), 95)) + 1e-6
    if distance is None:
        distance = max(2.6 * extent, 1e-2)
    distance = distance / max(float(zoom), 1e-3)   # orbit-camera dolly
    z = pts[:, 2] + distance
    vis = z > 1e-3
    pts, z = pts[vis], z[vis]
    if len(pts) == 0:
        return out
    col = (rgb[vis] if rgb is not None
           else _depth_shade(z))

    f = 0.9 * min(width, height) * distance / (2.2 * extent)
    u = (f * pts[:, 0] / z + width / 2).astype(np.int32)
    v = (f * pts[:, 1] / z + height / 2).astype(np.int32)
    inb = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z, col = u[inb], v[inb], z[inb], col[inb]

    order = np.argsort(-z, kind="stable")  # far -> near; near paints last
    u, v, col = u[order], v[order], col[order]
    r = max(int(point_size) // 2, 0)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            uu = np.clip(u + dx, 0, width - 1)
            vv = np.clip(v + dy, 0, height - 1)
            out[vv, uu] = col
    return out


def _depth_shade(z: np.ndarray) -> np.ndarray:
    zn = (z - z.min()) / (np.ptp(z) + 1e-6)
    c = (255 * (1.0 - 0.75 * zn)).astype(np.uint8)
    return np.stack([c // 2, c, 255 - c // 3], axis=-1)


def render_cloud_views(xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
                       views: Optional[Dict[str, Tuple[float, float]]] = None,
                       **kw) -> Dict[str, np.ndarray]:
    """Render every named preset viewpoint (the rviz-scene analog)."""
    views = views or VIEWPOINTS
    return {name: render_cloud(xyz, rgb, elev=e, azim=a, **kw)
            for name, (e, a) in views.items()}
