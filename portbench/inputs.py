"""Inputs made from the seed: layered scenes with exact ground truth (a
torch copy, on the device, of the port's ``io/synthetic.py:
layered_scene`` in its integer mode), seen through a configuration's
distorted rig as raw uint8 frames, as the two cameras deliver them.

A scene is rendered rectified, so its disparity is exact there. The raw
view of each camera samples it where that camera's pixel lands after
undistortion and the rectifying rotation (the inverse of the
rectification map), so rectifying the raw frame gives the scene back up
to two resamplings. Distinct frames are the scenes shifted along x, so
set-up renders only a few scenes. Everything is made on the device with
a seeded generator and copied to the host once."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.rectify import cameras

SCENES = 3        # scenes made from the seed
FRAMES = 24       # distinct raw pairs in the pool, published in turn
SHIFT_PX = 97     # columns a scene moves between its frames


@dataclasses.dataclass
class Frames:
    """The pool of raw frames a run publishes, in turn: ``left[i]`` and
    ``right[i]`` (H, W) uint8 numpy, ``gt[i]`` the rectified ground-truth
    disparity and ``gt_valid[i]`` its in-image, unoccluded mask (numpy,
    for the accuracy line)."""

    left: list
    right: list
    gt: list
    gt_valid: list


def _texture(gen, h: int, w: int, smooth: int, device) -> torch.Tensor:
    t = torch.rand((h, w), generator=gen, device=device, dtype=torch.float64)
    for _ in range(smooth):
        t = 0.25 * (t.roll(1, 0) + t.roll(-1, 0) + t.roll(1, 1)
                    + t.roll(-1, 1))
    t = (t - t.min()) / max(float(t.max() - t.min()), 1e-9)
    return (30.0 + 195.0 * t).to(torch.float32)


def layered_scene(gen, rng: np.random.Generator, H: int, W: int, *,
                  max_disp: int, background_disp: int, layers: int,
                  device):
    """(left, right, disparity, valid) rectified (H, W) tensors: a
    textured background at ``background_disp`` and ``layers`` textured
    rectangles in front of it at integer disparities, rendered back to
    front; ``valid`` marks pixels whose match is in the right view."""
    big = _texture(gen, H, W + max_disp + 1, 2, device)
    d0 = int(background_disp)
    left = big[:, :W].clone()
    right = big[:, d0:d0 + W].clone()
    disp = torch.full((H, W), float(d0), device=device)
    rdisp = disp.clone()
    for _ in range(layers):
        d = int(rng.integers(d0 + 2, max_disp + 1))
        lw = int(rng.integers(W // 6, W // 3))
        lh = int(rng.integers(H // 6, H // 3))
        x0 = int(rng.integers(max_disp + 2, W - lw - 2))
        y0 = int(rng.integers(2, H - lh - 2))
        tex = _texture(gen, lh, lw, 1, device)
        left[y0:y0 + lh, x0:x0 + lw] = tex
        disp[y0:y0 + lh, x0:x0 + lw] = d
        right[y0:y0 + lh, x0 - d:x0 - d + lw] = tex
        rdisp[y0:y0 + lh, x0 - d:x0 - d + lw] = d
    xs = torch.arange(W, device=device)[None, :]
    xr = xs - disp.long()
    in_img = (xr >= 0) & (xr < W)
    seen = rdisp.gather(1, xr.clamp(0, W - 1))
    valid = in_img & ((seen - disp).abs() <= 0.5)
    return left, right, disp, valid


def raw_grid(cam: dict, device) -> torch.Tensor:
    """(1, H, W, 2) ``grid_sample`` grid: where each raw pixel of ``cam``
    lands in the rectified image (undistortion by fixed-point iteration,
    as ``cv::undistortPoints``, then R and the rectified P)."""
    H, W = cam["height"], cam["width"]
    K, P, R = cam["K"], cam["P"], cam["R"]
    k1, k2, p1, p2, k3 = (list(cam["D"][:5]) + [0.0] * 5)[:5]
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                          torch.arange(W, dtype=torch.float64, device=device),
                          indexing="ij")
    xd = (u - K[0, 2]) / K[0, 0]
    yd = (v - K[1, 2]) / K[1, 1]
    x, y = xd.clone(), yd.clone()
    for _ in range(20):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    X = R[0, 0] * x + R[0, 1] * y + R[0, 2]
    Y = R[1, 0] * x + R[1, 1] * y + R[1, 2]
    Z = R[2, 0] * x + R[2, 1] * y + R[2, 2]
    xr = P[0, 0] * X / Z + P[0, 2]
    yr = P[1, 1] * Y / Z + P[1, 2]
    grid = torch.stack([2.0 * xr / (W - 1) - 1.0, 2.0 * yr / (H - 1) - 1.0],
                       -1)
    return grid[None].to(torch.float32)


def _raw(img: torch.Tensor, grid: torch.Tensor) -> np.ndarray:
    out = F.grid_sample(img[None, None], grid, mode="bicubic",
                        padding_mode="border", align_corners=True)[0, 0]
    return out.clamp(0, 255).round().to(torch.uint8).cpu().numpy()


def make_frames(config: dict, seed: int, device) -> Frames:
    """``FRAMES`` distinct raw pairs of the configuration's rig: ``SCENES``
    scenes from the seed, frame i scene i % SCENES shifted by ``SHIFT_PX``
    * (i // SCENES) columns (left, right and ground truth together)."""
    rig = config["rig"]
    H, W = int(rig["height"]), int(rig["width"])
    sc = config["scene"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    rng = np.random.default_rng(int(seed))
    cams = cameras(rig)
    grids = [raw_grid(c, device) for c in cams]
    scenes = [layered_scene(gen, rng, H, W, max_disp=int(sc["max_disp"]),
                            background_disp=int(sc["background_disp"]),
                            layers=int(sc["layers"]), device=device)
              for _ in range(SCENES)]
    out = Frames([], [], [], [])
    for i in range(FRAMES):
        left, right, disp, valid = scenes[i % len(scenes)]
        s = -SHIFT_PX * (i // len(scenes))
        out.left.append(_raw(left.roll(s, 1), grids[0]))
        out.right.append(_raw(right.roll(s, 1), grids[1]))
        out.gt.append(disp.roll(s, 1).cpu().numpy())
        out.gt_valid.append(valid.roll(s, 1).cpu().numpy())
    return out
