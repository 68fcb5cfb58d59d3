"""The rig, its rectification maps, Q and the remap, from the numbers of a
configuration file (frozen copy of the port's ``core/camera.py`` and
``ops/rectify.py`` host math and ``remap_plain``; float64 numpy on the
host, as ``cv::initUndistortRectifyMap`` computes it)."""

from __future__ import annotations

import numpy as np
import torch


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of a rotation vector (``cv2.Rodrigues``)."""
    r = np.asarray(rvec, dtype=np.float64)
    theta = np.linalg.norm(r)
    if theta == 0:
        return np.eye(3)
    k = r / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.cos(theta) * np.eye(3) + (1 - np.cos(theta)) * np.outer(k, k)
            + np.sin(theta) * kx)


def cameras(rig: dict) -> tuple[dict, dict]:
    """The configuration's ``rig`` block -> two cameras as dicts of
    float64 numpy ``K``, ``D``, ``R``, ``P`` and ints ``width``,
    ``height``. The right camera's P carries ``Tx = -fx' * baseline``."""
    W, H = int(rig["width"]), int(rig["height"])
    K = np.asarray(rig["K"], np.float64).reshape(3, 3)
    D = np.asarray(rig["D"], np.float64).reshape(-1)
    P = np.asarray(rig["P"], np.float64).reshape(3, 4)
    Pr = P.copy()
    Pr[0, 3] = -P[0, 0] * float(rig["baseline_m"])
    left = dict(width=W, height=H, K=K, D=D, R=rodrigues(rig["rvec_left"]),
                P=P)
    right = dict(width=W, height=H, K=K, D=D,
                 R=rodrigues(rig["rvec_right"]), P=Pr)
    return left, right


def calc_q(left: dict, right: dict) -> np.ndarray:
    """The 4x4 disparity-to-depth matrix (disparity_to_depth.cpp:62-85)."""
    fx, cx, cy = left["P"][0, 0], left["P"][0, 2], left["P"][1, 2]
    cx2 = right["P"][0, 2]
    T = -right["P"][0, 3] / right["P"][0, 0]
    Q = np.zeros((4, 4))
    Q[0, 0] = 1.0
    Q[0, 3] = -cx
    Q[1, 1] = 1.0
    Q[1, 3] = -cy
    Q[2, 3] = fx
    Q[3, 2] = 1.0 / T
    Q[3, 3] = -(cx - cx2) / T
    return Q


def inverse_map_xy(cam: dict) -> tuple[np.ndarray, np.ndarray]:
    """For each rectified pixel, its source coordinate in the raw image:
    unproject through P, rotate by R^-1, plumb-bob distortion, raw K."""
    H, W = cam["height"], cam["width"]
    P, K, R = cam["P"], cam["K"], cam["R"]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    Rinv = np.linalg.inv(R)
    X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2]
    Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2]
    Z = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2]
    xp = X / Z
    yp = Y / Z
    D = np.zeros(5)
    D[: cam["D"].size] = cam["D"][:5]
    k1, k2, p1, p2, k3 = D
    r2 = xp * xp + yp * yp
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    yd = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    return K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic weights (cv INTER_CUBIC) of the taps at -1, 0, 1, 2."""
    t = t[..., None]
    x = np.abs(t - np.array([-1.0, 0.0, 1.0, 2.0]))
    return np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * (x**3 - 5.0 * x**2 + 8.0 * x - 4.0), 0.0))


def rectify_map(cam: dict, device) -> dict:
    """The bicubic remap of one camera on ``device``: ``flat`` (H, W)
    int64 index of each stencil's top-left tap in the source edge-padded
    by 2, ``wx`` / ``wy`` (H, W, 4) float32 tap weights."""
    map_x, map_y = inverse_map_xy(cam)
    taps, pad = 4, 2
    x0, y0 = np.floor(map_x), np.floor(map_y)
    wx = _cubic_weights(map_x - x0).astype(np.float32)
    wy = _cubic_weights(map_y - y0).astype(np.float32)
    src_h, src_w = cam["height"], cam["width"]
    bx = np.clip(x0 - 1.0 + pad, 0, src_w + 2 * pad - taps)
    by = np.clip(y0 - 1.0 + pad, 0, src_h + 2 * pad - taps)
    flat = (by * (src_w + 2 * pad) + bx).astype(np.int32)
    return dict(flat=torch.as_tensor(flat, device=device).long(),
                wx=torch.as_tensor(wx, device=device),
                wy=torch.as_tensor(wy, device=device),
                src_h=src_h, src_w=src_w, pad=pad, taps=taps)


def remap(image: torch.Tensor, m: dict,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W) raw image -> (H, W) float32 rectified image: edge-pad, then
    the 4 x 4 taps summed row by row (``row + tap * wx[i]``, then
    ``out + row * wy[j]``). ``dtype`` is the precision of the sums (the
    control computes them in bfloat16)."""
    p = m["pad"]
    img = image.to(dtype)
    rows = (torch.arange(m["src_h"] + 2 * p, device=img.device) - p) \
        .clamp_(0, m["src_h"] - 1)
    cols = (torch.arange(m["src_w"] + 2 * p, device=img.device) - p) \
        .clamp_(0, m["src_w"] - 1)
    flat = img[rows[:, None], cols[None, :]].reshape(-1)
    Wp = m["src_w"] + 2 * p
    idx0 = m["flat"].reshape(-1)
    wx, wy = m["wx"].to(dtype), m["wy"].to(dtype)
    out = torch.zeros(m["flat"].shape, dtype=dtype, device=img.device)
    for j in range(m["taps"]):
        row = torch.zeros_like(out)
        for i in range(m["taps"]):
            tap = flat[idx0 + (j * Wp + i)].reshape(out.shape)
            row = row + tap * wx[..., i]
        out = out + row * wy[..., j]
    return out.to(torch.float32)
