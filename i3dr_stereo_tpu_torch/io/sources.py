"""Frame sources: the capture side of the pipeline, host-shell only.

Reference equivalents:

- tiscamera.py / pylon_camera GigE drivers (L0)  -> :class:`CameraSource`
  protocol + :class:`SyntheticSource` (deterministic test camera) and
  :class:`DirectorySource` (image-sequence replay).
- rosbag replay (stereo_bag_capture.launch:38)  -> :class:`DirectorySource`
  with stamps from filenames or fixed fps, plus record() to write one.
- the laser on/off frame routing of tiscamera_ctrl.py:175-183
  -> :class:`LaserSplitSource` driven by a trigger callable.

Real GigE Vision cameras are driven WITHOUT any vendor SDK by
:mod:`i3dr_stereo_tpu.io.gige` — GVCP control + GVSP streaming spoken
directly over UDP (validated against a loopback protocol emulator);
any other hardware source drops in by implementing ``frames()``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.pipeline.pairing import Stamped


class CameraSource:
    """Protocol: yields Stamped frames; settable like tiscamera_ctrl."""

    width: int
    height: int
    fps: float

    def frames(self) -> Iterator[Stamped]:  # pragma: no cover - protocol
        raise NotImplementedError

    # capture-property surface (cfg/tiscamera_settings.cfg)
    def set_property(self, name: str, value) -> bool:
        return False


@dataclasses.dataclass
class SyntheticStereoSource:
    """Deterministic moving synthetic scene — the test-bench camera."""

    width: int = 640
    height: int = 480
    fps: float = 5.0
    n_frames: int = 10
    max_disp: int = 48
    seed: int = 0

    def pairs(self) -> Iterator[Tuple[Stamped, Stamped]]:
        for i in range(self.n_frames):
            sc = layered_scene(self.height, self.width, max_disp=self.max_disp,
                               seed=self.seed + i)
            t = i / self.fps
            yield (Stamped(t, sc.left, i), Stamped(t, sc.right, i))

    def scene(self, i: int):
        return layered_scene(self.height, self.width, max_disp=self.max_disp,
                             seed=self.seed + i)


_STAMP_RE = re.compile(r"(\d+)")


@dataclasses.dataclass
class DirectorySource(CameraSource):
    """Image-sequence replay — the bag-replay equivalent.

    Reads ``<prefix>*<ext>`` sorted by the numeric part of the filename
    (the engine's file-pattern convention, quick.param [Pattern]);
    stamps are synthesized at ``fps`` unless filenames carry epoch-ns.
    """

    directory: str
    prefix: str = ""
    ext: str = ".png"
    fps: float = 5.0
    loop: bool = False
    grayscale: bool = True

    def _files(self):
        paths = sorted(
            glob.glob(os.path.join(self.directory, f"{self.prefix}*{self.ext}")),
            key=lambda p: int("".join(_STAMP_RE.findall(os.path.basename(p))) or 0))
        return paths

    def frames(self) -> Iterator[Stamped]:
        import cv2

        paths = self._files()
        seq = 0
        while True:
            for p in paths:
                img = cv2.imread(p, cv2.IMREAD_GRAYSCALE if self.grayscale
                                 else cv2.IMREAD_COLOR)
                if img is None:
                    continue
                yield Stamped(seq / self.fps, img.astype(np.float32), seq)
                seq += 1
            if not self.loop:
                return


@dataclasses.dataclass
class StereoDirectorySource:
    """Paired left/right replay (l_rect*/r_rect* file convention)."""

    directory: str
    left_prefix: str = "l_rect"
    right_prefix: str = "r_rect"
    ext: str = ".png"
    fps: float = 5.0

    def pairs(self) -> Iterator[Tuple[Stamped, Stamped]]:
        left = DirectorySource(self.directory, self.left_prefix, self.ext, self.fps)
        right = DirectorySource(self.directory, self.right_prefix, self.ext, self.fps)
        for l, r in zip(left.frames(), right.frames()):
            yield l, r


def record_pairs(directory: str, pairs, left_prefix="l_rect", right_prefix="r_rect"):
    """Record a stream to disk (the 'rosbag record' analog)."""
    import cv2

    os.makedirs(directory, exist_ok=True)
    n = 0
    for l, r in pairs:
        cv2.imwrite(os.path.join(directory, f"{left_prefix}{n:06d}.png"),
                    np.clip(l.data, 0, 255).astype(np.uint8))
        cv2.imwrite(os.path.join(directory, f"{right_prefix}{n:06d}.png"),
                    np.clip(r.data, 0, 255).astype(np.uint8))
        n += 1
    return n


@dataclasses.dataclass
class LaserSplitSource:
    """Route frames into with_laser / no_laser streams by a trigger state
    (tiscamera_ctrl.py:108-116,175-183 + tiscamera_trigger.py serial Bool).

    ``trigger`` is any callable stamp -> bool (True = laser on)."""

    source: CameraSource
    trigger: Callable[[float], bool]

    def split(self) -> Iterator[Tuple[str, Stamped]]:
        for f in self.source.frames():
            yield ("with_laser" if self.trigger(f.stamp) else "no_laser", f)
