"""Synthetic stereo scenes with analytic ground-truth disparity (torch
port: a numpy copy of ``layered_scene`` and ``slanted_scene`` from
``i3dr_stereo_tpu.io.synthetic``, bit-identical for the same seed —
``tests/test_torch_config.py`` pins both).

The reference has no test fixtures at all (SURVEY.md §4) — its only
offline evaluation is bag replay on recorded data. This module provides
the deterministic scenes the test-suite and benchmarks are built on:
layered fronto-parallel planes rendered into both views back-to-front,
so ground truth disparity (and its occlusion mask) is exact by
construction.

Hard-mode knobs (what a real two-camera laser-speckle rig produces, and
what integer-shift scenes cannot exercise):

- ``fractional=True`` draws layer (and background) disparities on a
  0.2-px grid and renders the right view from a 5x-supersampled texture
  — EXACT subpixel ground truth. 0.2 px is deliberately not on cv2's
  1/16-px fixed-point grid, so neither an integer-locking matcher nor a
  x16-quantizing oracle can score an artificial 0 on it.
- ``right_gain`` / ``right_bias`` apply a photometric mismatch to the
  right camera (exposure/vignetting difference between physical
  cameras).
- ``noise_sigma`` adds independent per-view Gaussian sensor noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int, smooth: int = 2) -> np.ndarray:
    """Band-limited random texture in [30, 225] — matchable but natural."""
    t = rng.uniform(0.0, 1.0, (h, w))
    for _ in range(smooth):
        t = 0.25 * (np.roll(t, 1, 0) + np.roll(t, -1, 0)
                    + np.roll(t, 1, 1) + np.roll(t, -1, 1))
    t = (t - t.min()) / max(float(np.ptp(t)), 1e-9)
    return 30.0 + 195.0 * t


def _texture_fine(rng: np.random.Generator, h: int, wf: int,
                  ss: int) -> np.ndarray:
    """Texture on an ``ss``x horizontally-supersampled grid, band-limited
    at the COARSE pixel scale (a real camera's optics + pixel integration
    do this): anisotropic double-box smoothing, x-width scaled by ss so
    the image viewed at pixel stride has the same spatial statistics as
    :func:`_texture` — subpixel-shifted views stay interpolable."""
    from scipy import ndimage

    t = rng.uniform(0.0, 1.0, (h, wf))
    for _ in range(2):
        t = ndimage.uniform_filter1d(t, size=3, axis=0, mode="wrap")
        t = ndimage.uniform_filter1d(t, size=3 * ss, axis=1, mode="wrap")
    t = (t - t.min()) / max(float(np.ptp(t)), 1e-9)
    return 30.0 + 195.0 * t


@dataclasses.dataclass
class SyntheticScene:
    left: np.ndarray          # (H, W) float32 [0,255]
    right: np.ndarray
    disparity: np.ndarray     # (H, W) float32 ground truth (left frame)
    occluded: np.ndarray      # (H, W) bool — true where right view lacks the match
    valid: np.ndarray         # in-image & unoccluded


def layered_scene(height: int = 120, width: int = 160, *,
                  background_disp: int = 8,
                  layers: int = 3,
                  max_disp: int = 24,
                  seed: int = 0,
                  fractional: bool = False,
                  right_gain: float = 1.0,
                  right_bias: float = 0.0,
                  noise_sigma: float = 0.0) -> SyntheticScene:
    """Back-to-front render of textured rectangles.

    Default: integer disparities, identical photometry — every pixel's
    true disparity is exact and the views are bit-identical where
    unoccluded (the easy regime the original tests rely on).
    ``fractional=True`` draws disparities on a fifth-pixel grid and
    renders the right view exactly from a supersampled texture
    (subpixel GT off cv2's x16 grid); ``right_gain`` /
    ``right_bias`` / ``noise_sigma`` add the photometric asymmetry of a
    real two-camera rig. Occlusions in the right view are tracked so
    accuracy metrics can exclude them (like standard stereo benchmarks).
    """
    rng = np.random.default_rng(seed)
    H, W = height, width
    # Fractional mode renders from a 5x-horizontally-supersampled texture:
    # disparities live on a 0.2-px grid, so every sample position in
    # either view lands EXACTLY on the fine grid — subpixel ground truth
    # with zero interpolation error, the same exactness the integer
    # renderer has. Fifths (not quarters) keep the GT off cv2's 1/16-px
    # fixed-point grid. (pad width in the integer branch matches the
    # original generator exactly so seed-pinned test scenes are
    # bit-identical.)
    SS = 5 if fractional else 1
    big = (_texture_fine(rng, H, SS * (W + max_disp + 1), SS) if fractional
           else _texture(rng, H, W + max_disp + 1))

    left = np.empty((H, W), np.float32)
    right = np.empty((H, W), np.float32)
    xs1 = np.arange(W)
    # background at constant disparity d0: L(y,x) = T(y,x), R(y,x) = T(y, x+d0)
    d0 = float(background_disp)
    if fractional:
        d0 += float(rng.integers(1, SS)) / SS
    left[:] = big[:, :SS * W:SS]
    right[:] = big[:, int(round(SS * d0))::SS][:, :W]
    disp = np.full((H, W), d0, np.float32)
    # right-view z-buffer in right coords: which disparity occupies each right pixel
    rdisp = np.full((H, W), d0, np.float32)

    for i in range(layers):
        d = float(rng.integers(int(d0) + 2, max_disp + 1))
        if fractional:
            d += float(rng.integers(1, SS)) / SS
            d = min(d, float(max_disp))
        lw = int(rng.integers(W // 6, W // 3))
        lh = int(rng.integers(H // 6, H // 3))
        x0 = int(rng.integers(max_disp + 2, W - lw - 2))
        y0 = int(rng.integers(2, H - lh - 2))
        tex = (_texture_fine(rng, lh, SS * lw + SS - 1, SS) if fractional
               else _texture(rng, lh, lw, smooth=1))
        # left view: texture coordinate t = x - x0, fine-grid index SS*t
        left[y0:y0 + lh, x0:x0 + lw] = tex[:, :SS * lw:SS]
        disp[y0:y0 + lh, x0:x0 + lw] = d
        # right view: same surface shifted left by d — right pixel xr has
        # texture coordinate t = xr - (x0 - d), on the fine grid for any
        # fifth-pixel d
        rx0 = int(np.ceil(x0 - d))
        rxs = np.arange(rx0, rx0 + lw)
        tfine = np.round(SS * (rxs - (x0 - d))).astype(int)
        keep = (tfine >= 0) & (tfine < tex.shape[1])
        right[y0:y0 + lh, rxs[keep]] = tex[:, tfine[keep]]
        rdisp[y0:y0 + lh, rxs[keep]] = d

    # occlusion: left pixel (y, x) is visible in the right view iff the
    # right pixel (y, round(x - d)) is occupied by (nearly) the same
    # disparity; fractional renders use a half-pixel tolerance
    ys, xs = np.mgrid[0:H, 0:W]
    xr = np.round(xs - disp).astype(int)
    in_img = (xr >= 0) & (xr < W)
    xr_c = np.clip(xr, 0, W - 1)
    occluded = ~in_img | (np.abs(rdisp[ys, xr_c] - disp) > 0.5)

    # photometric asymmetry + sensor noise (applied AFTER geometry so the
    # ground truth is untouched)
    if right_gain != 1.0 or right_bias != 0.0:
        right = right * right_gain + right_bias
    if noise_sigma > 0.0:
        left = left + rng.normal(0.0, noise_sigma, left.shape)
        right = right + rng.normal(0.0, noise_sigma, right.shape)
    left = np.clip(left, 0.0, 255.0)
    right = np.clip(right, 0.0, 255.0)

    return SyntheticScene(
        left=left.astype(np.float32),
        right=right.astype(np.float32),
        disparity=disp,
        occluded=occluded,
        valid=~occluded,
    )


def slanted_scene(height: int = 120, width: int = 160, *,
                  d_near: float = 20.0, d_far: float = 6.0,
                  seed: int = 1,
                  right_gain: float = 1.0,
                  right_bias: float = 0.0,
                  noise_sigma: float = 0.0) -> SyntheticScene:
    """A single slanted plane: disparity varies linearly across x, with
    subpixel ground truth — exercises parabolic subpixel refinement.

    Rendered by sampling a continuous texture: L(y,x) = T(y, x),
    R(y,x) = T(y, x + d(x_r)) with linear interpolation. Photometric
    knobs as in :func:`layered_scene`.
    """
    rng = np.random.default_rng(seed)
    H, W = height, width
    pad = int(np.ceil(d_near)) + 2
    big = _texture(rng, H, W + 2 * pad, smooth=3)

    xs = np.arange(W)
    # disparity as a function of LEFT x
    disp = d_far + (d_near - d_far) * xs / max(W - 1, 1)
    disp2d = np.broadcast_to(disp, (H, W)).astype(np.float32).copy()

    left = big[:, pad:pad + W].astype(np.float32)
    # right view: find for each right x the left x with x_l - d(x_l) = x_r.
    # With monotone mapping, invert numerically.
    xl_of_xr = np.interp(xs, xs - disp, xs)
    src = pad + xl_of_xr
    i0 = np.floor(src).astype(int)
    frac = src - i0
    right = (big[:, i0] * (1 - frac) + big[:, i0 + 1] * frac).astype(np.float32)

    if right_gain != 1.0 or right_bias != 0.0:
        right = right * right_gain + right_bias
    if noise_sigma > 0.0:
        left = left + rng.normal(0.0, noise_sigma, left.shape)
        right = right + rng.normal(0.0, noise_sigma, right.shape)
    left = np.clip(left, 0.0, 255.0).astype(np.float32)
    right = np.clip(right, 0.0, 255.0).astype(np.float32)

    occluded = np.zeros((H, W), bool)
    occluded[:, : int(np.ceil(d_near))] = True  # left strip has no right match
    return SyntheticScene(left=left, right=right, disparity=disp2d,
                          occluded=occluded, valid=~occluded)
