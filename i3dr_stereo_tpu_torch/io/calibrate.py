"""Stereo calibration from chessboard captures.

The reference delegates calibration to the ROS ``camera_calibration``
GUI (launch/stereo_calibration.launch:48-56: cameracalibrator.py with a
--size/--square chessboard) and then consumes the resulting YAMLs. The
same division of labour here: calibration is host-side tooling (OpenCV
solvers — the identical math cameracalibrator wraps), producing
:class:`~i3dr_stereo_tpu_torch.core.camera.CameraModel`/``StereoRig`` that the
TPU pipeline consumes, persisted via io.calib_store in the ROS YAML
schema.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from i3dr_stereo_tpu_torch.core.camera import CameraModel, StereoRig


@dataclasses.dataclass(frozen=True)
class ChessboardSpec:
    """--size NxM --square S of cameracalibrator.py."""

    cols: int = 9      # inner corners per row
    rows: int = 6      # inner corners per column
    square_size: float = 0.025  # metres

    def object_points(self) -> np.ndarray:
        objp = np.zeros((self.rows * self.cols, 3), np.float32)
        objp[:, :2] = (np.mgrid[0:self.cols, 0:self.rows].T.reshape(-1, 2)
                       * self.square_size)
        return objp


def find_corners(image: np.ndarray, board: ChessboardSpec
                 ) -> Optional[np.ndarray]:
    import cv2

    img = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    found, corners = cv2.findChessboardCorners(
        img, (board.cols, board.rows),
        flags=cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE)
    if not found:
        return None
    corners = cv2.cornerSubPix(
        img, corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-4))
    return corners.reshape(-1, 2)


def calibrate_stereo(left_images: Sequence[np.ndarray],
                     right_images: Sequence[np.ndarray],
                     board: ChessboardSpec = ChessboardSpec(),
                     ) -> Tuple[StereoRig, dict]:
    """Full stereo calibration -> rectified StereoRig (+ diagnostics).

    Mirrors cameracalibrator.py's pipeline: per-view chessboard corners,
    mono intrinsics, stereo extrinsics, stereoRectify -> R/P per camera.
    """
    import cv2

    assert len(left_images) == len(right_images) and left_images
    h, w = np.asarray(left_images[0]).shape[:2]
    objp = board.object_points()

    obj_pts, l_pts, r_pts = [], [], []
    for li, ri in zip(left_images, right_images):
        lc = find_corners(li, board)
        rc = find_corners(ri, board)
        if lc is None or rc is None:
            continue
        obj_pts.append(objp)
        l_pts.append(lc.astype(np.float32))
        r_pts.append(rc.astype(np.float32))
    if len(obj_pts) < 3:
        raise ValueError(f"only {len(obj_pts)} usable views; need >= 3")

    flags = cv2.CALIB_FIX_K3
    rms_l, K1, D1, _, _ = cv2.calibrateCamera(obj_pts, l_pts, (w, h), None,
                                              None, flags=flags)
    rms_r, K2, D2, _, _ = cv2.calibrateCamera(obj_pts, r_pts, (w, h), None,
                                              None, flags=flags)
    rms_s, K1, D1, K2, D2, R, T, _, _ = cv2.stereoCalibrate(
        obj_pts, l_pts, r_pts, K1, D1, K2, D2, (w, h),
        flags=cv2.CALIB_FIX_INTRINSIC)
    R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
        K1, D1, K2, D2, (w, h), R, T, alpha=0)

    left = CameraModel(w, h, K1, D1.reshape(-1), R1, P1)
    right = CameraModel(w, h, K2, D2.reshape(-1), R2, P2)
    rig = StereoRig(left, right)
    diag = {"views": len(obj_pts), "rms_left": rms_l, "rms_right": rms_r,
            "rms_stereo": rms_s, "baseline_m": rig.baseline}
    return rig, diag


# --------------------------------------------------------------------------
# synthetic chessboard rendering (test/bench support — the reference has
# no testable calibration path at all)
# --------------------------------------------------------------------------

def render_chessboard(board: ChessboardSpec, K: np.ndarray, D: np.ndarray,
                      rvec: np.ndarray, tvec: np.ndarray,
                      image_size: Tuple[int, int],
                      square_px: int = 40) -> np.ndarray:
    """Render a chessboard seen by a camera (K, D) at pose (rvec, tvec)."""
    import cv2

    w, h = image_size
    cols, rows = board.cols + 1, board.rows + 1
    s = board.square_size
    # board texture with a one-square white margin
    tex = np.full(((rows + 2) * square_px, (cols + 2) * square_px), 220, np.uint8)
    for i in range(rows):
        for j in range(cols):
            if (i + j) % 2 == 0:
                y0, x0 = (i + 1) * square_px, (j + 1) * square_px
                tex[y0:y0 + square_px, x0:x0 + square_px] = 30
    # map texture corners (board plane coords) into the image
    plane = np.array([[-s, -s, 0], [cols * s + s, -s, 0],
                      [cols * s + s, rows * s + s, 0], [-s, rows * s + s, 0]],
                     np.float32)
    img_pts, _ = cv2.projectPoints(plane, rvec, tvec, K, D)
    src = np.array([[0, 0], [tex.shape[1], 0],
                    [tex.shape[1], tex.shape[0]], [0, tex.shape[0]]], np.float32)
    Hm = cv2.getPerspectiveTransform(src, img_pts.reshape(-1, 2).astype(np.float32))
    out = cv2.warpPerspective(tex, Hm, (w, h), borderValue=128)
    return cv2.GaussianBlur(out, (3, 3), 0.6)
