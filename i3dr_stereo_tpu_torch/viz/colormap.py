"""Disparity/depth colorization for visualization sinks.

The reference leans on rviz + a Qt/VTK GUI for this (stereo_gui.cpp,
rviz/*.rviz). Headless TPU hosts render to images instead: a turbo-like
colormap applied on device (jit) or host, invalid pixels black.
"""

from __future__ import annotations

import numpy as np

# 7-stop turbo-ish anchor table (r, g, b) in [0,1]
_STOPS = np.array([
    [0.19, 0.07, 0.23],
    [0.28, 0.37, 0.90],
    [0.11, 0.74, 0.72],
    [0.40, 0.92, 0.30],
    [0.91, 0.85, 0.17],
    [0.98, 0.53, 0.12],
    [0.74, 0.10, 0.11],
])


def _apply_map(t: np.ndarray) -> np.ndarray:
    n = len(_STOPS) - 1
    x = np.clip(t, 0.0, 1.0) * n
    i = np.minimum(x.astype(np.int32), n - 1)
    f = (x - i)[..., None]
    return _STOPS[i] * (1 - f) + _STOPS[i + 1] * f


def disparity_to_color(disp, valid=None, *, vmin=None, vmax=None) -> np.ndarray:
    """(H, W) disparity -> (H, W, 3) uint8; invalid black."""
    d = np.asarray(disp, dtype=np.float64)
    v = np.ones(d.shape, bool) if valid is None else np.asarray(valid)
    sel = v & np.isfinite(d) & (np.abs(d) < 10000)
    if vmin is None:
        vmin = float(d[sel].min()) if sel.any() else 0.0
    if vmax is None:
        vmax = float(d[sel].max()) if sel.any() else 1.0
    t = (d - vmin) / max(vmax - vmin, 1e-9)
    rgb = (_apply_map(t) * 255).astype(np.uint8)
    rgb[~sel] = 0
    return rgb


def depth_to_color(depth, valid=None, *, dmax=None) -> np.ndarray:
    """Depth (metres) -> color; near = warm, far = cold."""
    z = np.asarray(depth, dtype=np.float64)
    v = (z > 0) if valid is None else np.asarray(valid)
    if dmax is None:
        dmax = float(z[v].max()) if v.any() else 1.0
    t = 1.0 - np.clip(z / max(dmax, 1e-9), 0, 1)
    rgb = (_apply_map(t) * 255).astype(np.uint8)
    rgb[~v] = 0
    return rgb
