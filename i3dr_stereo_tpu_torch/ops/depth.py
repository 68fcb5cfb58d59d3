"""Disparity -> depth image, point cloud, and disparity-masked crop (torch
port of ``i3dr_stereo_tpu.ops.depth``).

- depth: w = q32 d + q33, Z = q23 / w, filtering d == 0, |d| >= 10000,
  w <= 0 and Z outside [depth_min, depth_max]
  (disparity_to_depth.cpp:150-205);
- point cloud: a fixed-shape (N, 3) float32 array + valid mask + rgb;
- crop: the rectified left image masked to valid disparity
  (crop_image_by_disparity.cpp:49-75).

``Q`` is a (4, 4) float32 tensor on the disparity's device; the depth
bounds may be Python floats or 0-dim float32 tensors (runtime scalars).
"""

from __future__ import annotations

import numpy as np
import torch

from i3dr_stereo_tpu_torch.core.frame import to_numpy

MISSING_Z = 10000.0  # reference invalid-disparity marker (generate_disparity.cpp:449-452)


def disparity_to_depth(disp: torch.Tensor, valid: torch.Tensor,
                       Q: torch.Tensor, depth_min=0.0, depth_max=10.0):
    """(…, H, W) disparity -> (depth_m, valid); 0 where invalid."""
    q23, q32, q33 = Q[2, 3], Q[3, 2], Q[3, 3]
    w = q32 * disp + q33
    ok = valid & (disp != 0.0) & (disp.abs() < MISSING_Z) & (w > 0.0)
    z = torch.where(ok, q23 / torch.where(w == 0, 1.0, w), 0.0)
    ok = ok & (z >= depth_min) & (z <= depth_max)
    return torch.where(ok, z, 0.0), ok


def disparity_to_pointcloud(disp: torch.Tensor, valid: torch.Tensor,
                            Q: torch.Tensor, rgb=None,
                            depth_min=0.0, depth_max=10.0) -> dict:
    """(…, H, W) disparity -> {"xyz": (…, H*W, 3), "valid": (…, H*W),
    "rgb": (…, H*W, 3)}; a mono ``rgb`` image becomes grey rgb."""
    H, W = disp.shape[-2:]
    lead = disp.shape[:-2]
    q03, q13, q23 = Q[0, 3], Q[1, 3], Q[2, 3]
    q32, q33 = Q[3, 2], Q[3, 3]
    ys = torch.arange(H, dtype=torch.float32, device=disp.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=disp.device)[None, :]
    w = q32 * disp + q33
    ok = valid & (disp != 0.0) & (disp.abs() < MISSING_Z) & (w > 0.0)
    wsafe = torch.where(w == 0, 1.0, w)
    X = (xs + q03) / wsafe
    Y = (ys + q13) / wsafe
    Z = q23 / wsafe
    ok = ok & (Z >= depth_min) & (Z <= depth_max)
    xyz = torch.stack([X, Y, Z], dim=-1).reshape(lead + (H * W, 3))
    out = {"xyz": xyz.to(torch.float32), "valid": ok.reshape(lead + (H * W,))}
    if rgb is not None:
        if rgb.ndim == disp.ndim:  # mono -> grey rgb
            rgb = torch.stack([rgb] * 3, dim=-1)
        out["rgb"] = rgb.reshape(lead + (H * W, 3))
    return out


def crop_by_disparity(image: torch.Tensor, disp: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Mask image to pixels with valid disparity; invalid pixels -> 0."""
    ok = valid & (disp.abs() < MISSING_Z)
    if image.ndim == disp.ndim + 1:  # color
        ok = ok[..., None]
    return torch.where(ok, image, torch.zeros((), dtype=image.dtype,
                                              device=image.device))


def pointcloud_to_numpy(pc: dict) -> tuple[np.ndarray, np.ndarray | None]:
    """Host-side compaction: drop invalid points (for PLY export). The
    cloud's entries may be tensors on any device or numpy arrays; the
    result is numpy."""
    xyz = to_numpy(pc["xyz"])
    valid = to_numpy(pc["valid"])
    rgb = to_numpy(pc["rgb"]) if "rgb" in pc else None
    xyz = xyz[valid]
    rgb = rgb[valid] if rgb is not None else None
    return xyz, rgb
