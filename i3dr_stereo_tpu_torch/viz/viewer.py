"""Headless stereo viewer: the stereo_gui.cpp replacement.

The reference's Qt/VTK window shows 4 image panes (raw, rect, disparity,
depth) + a point-cloud view (src/StereoGUI/StereoGUI.cpp:4-25). On a
headless TPU host the same montage is rendered to PNG files / returned
arrays; it subscribes to the identical topics on the bridge graph. An
interactive matplotlib window is used when a display is available and
``interactive=True``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from i3dr_stereo_tpu_torch.bridge.graph import Graph, Node
from i3dr_stereo_tpu_torch.viz.colormap import depth_to_color, disparity_to_color


def _to_u8(img):
    x = np.asarray(img)
    if x.dtype != np.uint8:
        x = np.clip(x, 0, 255).astype(np.uint8)
    if x.ndim == 2:
        x = np.stack([x] * 3, axis=-1)
    return x


def montage(panes, cols=2, pad=4):
    """Stack same-size RGB panes into a grid image with labels."""
    import cv2

    panes = [(_to_u8(p), name) for p, name in panes]
    h = max(p.shape[0] for p, _ in panes)
    w = max(p.shape[1] for p, _ in panes)
    rows = (len(panes) + cols - 1) // cols
    out = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad, 3), np.uint8)
    for i, (p, name) in enumerate(panes):
        r, c = divmod(i, cols)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        out[y:y + p.shape[0], x:x + p.shape[1]] = p
        cv2.putText(out, name, (x + 4, y + 16), cv2.FONT_HERSHEY_SIMPLEX,
                    0.45, (255, 255, 255), 1, cv2.LINE_AA)
    return out


class StereoViewer(Node):
    """Subscribes to the pipeline topics and renders montages.

    - ``render()`` returns the current montage array
    - ``save(path)`` writes it (the CI-friendly "GUI")
    - with interactive=True and a display, shows a live matplotlib window
    """

    def __init__(self, graph: Graph, namespace: str = "/stereo",
                 name: str = "stereo_viewer", interactive: bool = False):
        super().__init__(graph, name, namespace)
        self._state = {}
        self._interactive = interactive and bool(os.environ.get("DISPLAY"))
        self._fig = None
        self.cloud_elev, self.cloud_azim = 15.0, -35.0
        self.cloud_zoom = 1.0
        self.cloud_point_size = 2
        self.subscribe("left/image_raw", lambda s, d: self._set("raw", d))
        self.subscribe("left/image_rect", lambda s, d: self._set("rect", d))
        self.subscribe("disparity", lambda s, d: self._set("disp", d))
        self.subscribe("depth", lambda s, d: self._set("depth", d))
        self.subscribe("points2", lambda s, d: self._set("points", d))

    def _set(self, key, data):
        self._state[key] = data
        if self._interactive:
            self._draw()

    def render(self) -> Optional[np.ndarray]:
        if not self._state:
            return None
        panes = []
        if "raw" in self._state:
            panes.append((self._state["raw"], "left/image_raw"))
        if "rect" in self._state:
            panes.append((self._state["rect"], "left/image_rect"))
        if "disp" in self._state:
            m = self._state["disp"]
            panes.append((disparity_to_color(m["disparity"], m.get("valid")),
                          "disparity"))
        if "depth" in self._state:
            panes.append((depth_to_color(self._state["depth"]), "depth"))
        if "points" in self._state:
            # the reference GUI's PCL/VTK cloud pane (StereoGUI.cpp:68-89)
            from i3dr_stereo_tpu_torch.ops.depth import pointcloud_to_numpy
            from i3dr_stereo_tpu_torch.viz.cloud import render_cloud

            xyz, rgb = pointcloud_to_numpy(self._state["points"])
            ref = panes[0][0] if panes else None
            h = ref.shape[0] if ref is not None else 480
            w = ref.shape[1] if ref is not None else 640
            panes.append((render_cloud(xyz, rgb, width=w, height=h,
                                       elev=self.cloud_elev,
                                       azim=self.cloud_azim,
                                       zoom=self.cloud_zoom,
                                       point_size=self.cloud_point_size),
                          "points2"))
        return montage(panes) if panes else None

    def set_viewpoint(self, name_or_angles) -> None:
        """Select a canned rviz-scene-style viewpoint (viz.cloud.VIEWPOINTS
        name) or explicit (elev_deg, azim_deg)."""
        from i3dr_stereo_tpu_torch.viz.cloud import VIEWPOINTS

        if isinstance(name_or_angles, str):
            self.cloud_elev, self.cloud_azim = VIEWPOINTS[name_or_angles]
        else:
            self.cloud_elev, self.cloud_azim = name_or_angles

    def save(self, path: str) -> Optional[str]:
        import cv2

        img = self.render()
        if img is None:
            return None
        cv2.imwrite(path, img[..., ::-1])  # RGB -> BGR for imwrite
        return path

    def _draw(self):  # pragma: no cover - needs a display
        import matplotlib.pyplot as plt

        img = self.render()
        if img is None:
            return
        if self._fig is None:
            plt.ion()
            self._fig = plt.figure("i3dr_stereo_tpu_torch viewer")
        plt.figure(self._fig.number)
        plt.clf()
        plt.imshow(img)
        plt.axis("off")
        plt.pause(0.001)
