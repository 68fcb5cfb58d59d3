"""Rectification: undistort + rectify maps built once per calibration,
then a 16-tap (bicubic) or 4-tap (bilinear) remap per frame (torch port
of ``i3dr_stereo_tpu.ops.rectify``).

Host half: the inverse map (plumb-bob distortion through the rectifying
rotation) and the separable Keys (a = -0.75, cv INTER_CUBIC) or linear
weights are the reference's numpy float64 operations, copied rather than
imported (importing the JAX package imports JAX), so ``flat_idx``,
``wx`` and ``wy`` come out bit-identical to the reference map
(``tests/test_torch_rectify.py`` pins them). The map holds each pixel's
weights interleaved (``wx`` then ``wy``), so the kernel reads them as
16-byte vectors; ``wx`` and ``wy`` are views of that one tensor.

Device half: :func:`remap` launches the ``remap`` kernel
(``csrc/remap.cu``, the port of the TPU's banded ``remap_banded``) for a
CUDA tensor and runs :func:`remap_plain`, the reference's
``_remap_gather_impl`` in torch, for a CPU tensor; :func:`rectify_pair`
remaps both cameras of a rig in one launch. The TPU's banded
channelisation (``rectify_pallas.build_banded``) is a gather workaround
the GPU does not need, so the map carries no banded form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.core.camera import CameraModel


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution weights for the 4 taps at offsets
    {-1, 0, 1, 2} from the floor sample; a=-0.75 matches cv INTER_CUBIC."""
    t = t[..., None]
    x = np.abs(t - np.array([-1.0, 0.0, 1.0, 2.0]))  # distance to each tap
    w = np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * (x**3 - 5.0 * x**2 + 8.0 * x - 4.0), 0.0),
    )
    return w  # (..., 4)


def _linear_weights(t: np.ndarray) -> np.ndarray:
    t = t[..., None]
    off = np.array([0.0, 1.0])
    return np.clip(1.0 - np.abs(t - off), 0.0, 1.0)  # (..., 2)


def inverse_rectify_map_xy(cam: CameraModel) -> tuple[np.ndarray, np.ndarray]:
    """For each rectified pixel, the source coordinate in the raw image.

    Same math as cv::initUndistortRectifyMap: unproject through the
    rectified projection P, rotate by R^-1, apply plumb-bob distortion,
    project through raw K. Host-side float64, once per calibration.
    """
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    # rotate into the raw camera frame
    Rinv = np.linalg.inv(cam.R)
    X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2]
    Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2]
    Z = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2]
    xp = X / Z
    yp = Y / Z
    # plumb_bob distortion (k1 k2 p1 p2 k3)
    D = np.zeros(5)
    D[: cam.D.size] = cam.D[:5]
    k1, k2, p1, p2, k3 = D
    r2 = xp * xp + yp * yp
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    yd = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    map_x = cam.K[0, 0] * xd + cam.K[0, 2]
    map_y = cam.K[1, 1] * yd + cam.K[1, 2]
    return map_x, map_y


@dataclasses.dataclass(frozen=True)
class RectifyMap:
    """Precomputed remap: flat gather indices + separable tap weights.

    ``flat_idx[h, w]`` indexes the top-left tap of the (T x T) stencil in
    the flattened source image edge-padded by ``pad`` on every side;
    ``weights[h, w]`` holds the T horizontal weights, then the T vertical
    ones (T=4 cubic, T=2 linear), which ``wx`` / ``wy`` view. Both tensors
    live on one device."""

    flat_idx: torch.Tensor   # (H, W) int32 into the padded flat image
    weights: torch.Tensor    # (H, W, 2T) float32: wx, then wy
    src_h: int
    src_w: int
    pad: int
    taps: int

    @property
    def padded_w(self) -> int:
        return self.src_w + 2 * self.pad

    @property
    def wx(self) -> torch.Tensor:
        """(H, W, T) float32 horizontal weights (a view)."""
        return self.weights[..., :self.taps]

    @property
    def wy(self) -> torch.Tensor:
        """(H, W, T) float32 vertical weights (a view)."""
        return self.weights[..., self.taps:]


def make_rectify_map(cam: CameraModel, *, interpolation: str = "cubic",
                     map_xy: tuple[np.ndarray, np.ndarray] | None = None,
                     device: torch.device | str = "cuda") -> RectifyMap:
    """Build the remap structure on ``device`` (host work, once; the card
    unless the caller asks for the CPU, and a missing card raises).

    ``map_xy`` overrides the calibration-derived inverse map — used for
    generic remap applications (e.g. unit tests, custom warps)."""
    device = _build.resolve_device(device)
    if map_xy is None:
        map_x, map_y = inverse_rectify_map_xy(cam)
    else:
        map_x, map_y = map_xy
    if interpolation == "cubic":
        taps, pad = 4, 2  # stencil offsets -1..2 around floor => pad 2
        x0 = np.floor(map_x)
        y0 = np.floor(map_y)
        wx = _cubic_weights(map_x - x0)
        wy = _cubic_weights(map_y - y0)
        base_x = x0 - 1.0
        base_y = y0 - 1.0
    elif interpolation == "linear":
        taps, pad = 2, 1
        base_x = np.floor(map_x)
        base_y = np.floor(map_y)
        wx = _linear_weights(map_x - base_x)
        wy = _linear_weights(map_y - base_y)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")

    # out-of-range source coords: clamp the stencil inside the padded image
    # (padding is edge-replicated, so fully outside pixels read the
    # replicated border)
    src_h, src_w = cam.height, cam.width
    bx = np.clip(base_x + pad, 0, src_w + 2 * pad - taps)
    by = np.clip(base_y + pad, 0, src_h + 2 * pad - taps)
    flat = (by * (src_w + 2 * pad) + bx).astype(np.int32)
    return RectifyMap(
        flat_idx=torch.as_tensor(flat, device=device),
        weights=torch.as_tensor(
            np.concatenate([wx, wy], -1).astype(np.float32), device=device),
        src_h=int(src_h),
        src_w=int(src_w),
        pad=pad,
        taps=taps,
    )


def _check(image: torch.Tensor, rmap: RectifyMap) -> None:
    if image.ndim not in (2, 3) or tuple(image.shape[-2:]) != (rmap.src_h,
                                                               rmap.src_w):
        raise ValueError(f"expected a (H, W) or (B, H, W) image of "
                         f"{rmap.src_h}x{rmap.src_w}, got "
                         f"{tuple(image.shape)}")
    if image.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"remap takes uint8 or float32 images, got "
                         f"{image.dtype}")


def remap_plain(image: torch.Tensor, rmap: RectifyMap) -> torch.Tensor:
    """Plain torch twin of the ``remap`` kernel: the reference's
    ``_remap_gather_impl`` — edge-pad, then T x T flat gathers summed in
    its order (``row_acc + tap * wx[i]``, then ``out + row_acc * wy[j]``)."""
    _check(image, rmap)
    batched = image.ndim == 3
    img = (image if batched else image[None]).to(torch.float32)
    p = rmap.pad
    rows = (torch.arange(rmap.src_h + 2 * p, device=img.device) - p) \
        .clamp_(0, rmap.src_h - 1)
    cols = (torch.arange(rmap.padded_w, device=img.device) - p) \
        .clamp_(0, rmap.src_w - 1)
    flat = img[:, rows[:, None], cols[None, :]].reshape(img.shape[0], -1)
    W = rmap.padded_w
    idx0 = rmap.flat_idx.reshape(-1).long()

    out = torch.zeros((img.shape[0],) + tuple(rmap.flat_idx.shape),
                      dtype=torch.float32, device=img.device)
    for j in range(rmap.taps):
        row_acc = torch.zeros_like(out)
        for i in range(rmap.taps):
            tap = flat[:, idx0 + (j * W + i)].reshape(out.shape)
            row_acc = row_acc + tap * rmap.wx[..., i]
        out = out + row_acc * rmap.wy[..., j]
    return out if batched else out[0]


def _remap_kernel(images, maps) -> tuple:
    """One launch of the ``remap`` kernel over one camera or two (the same
    shapes, source type and taps): each image (H, W) or (B, H, W). Two
    cameras' outputs share one allocation."""
    images = [x.contiguous() for x in images]
    m, m1 = maps[0], maps[-1]
    _build.require_cuda(*images, m.flat_idx, m.weights, m1.flat_idx,
                        m1.weights)
    src = images[0]
    batched = src.ndim == 3
    B = src.shape[0] if batched else 1
    H, W = m.flat_idx.shape
    outs = torch.empty((len(images), B, H, W), dtype=torch.float32,
                       device=src.device)
    out = outs.data_ptr()
    pair = len(images) == 2
    _build.launch("i3dr_remap", "remap", src.device, src.data_ptr(),
                  images[1].data_ptr() if pair else None,
                  int(src.dtype == torch.uint8), m.flat_idx.data_ptr(),
                  m1.flat_idx.data_ptr() if pair else None,
                  m.weights.data_ptr(), m1.weights.data_ptr() if pair else None,
                  out, out + 4 * B * H * W if pair else None, B, H, W,
                  m.src_h, m.src_w, m.pad, m.taps, _build.stream_of(src))
    return (outs if batched else outs[:, 0]).unbind(0)


def remap(image: torch.Tensor, rmap: RectifyMap) -> torch.Tensor:
    """Apply the precomputed map to a (H, W) or (B, H, W) uint8 or
    float32 image -> float32 of the map's shape. A CPU tensor takes the
    plain version; a CUDA tensor launches the ``remap`` kernel (or
    raises), which reads the source in its own type and clamps
    coordinates instead of materialising the padded image."""
    if image.device.type == "cpu":
        return remap_plain(image, rmap)
    _check(image, rmap)
    return _remap_kernel([image], [rmap])[0]


def rectify_pair(left: torch.Tensor, right: torch.Tensor, lmap: RectifyMap,
                 rmap: RectifyMap) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`remap` of both cameras of a rig: on the card one launch for
    both where their images and maps agree in shape, type and taps."""
    if left.device.type == "cpu" and right.device.type == "cpu":
        return remap_plain(left, lmap), remap_plain(right, rmap)
    _check(left, lmap)
    _check(right, rmap)
    if (left.shape == right.shape and left.dtype == right.dtype
            and lmap.flat_idx.shape == rmap.flat_idx.shape
            and lmap.pad == rmap.pad and lmap.taps == rmap.taps):
        return _remap_kernel([left, right], [lmap, rmap])
    return remap(left, lmap), remap(right, rmap)
