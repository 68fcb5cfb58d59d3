"""Image resizes of the matcher facade's ``downsample_scale``: the cubic
resize of the images (the reference's ``jax.image.resize(..., "cubic")``,
matchers/base.py:61-68) and the nearest resize of the disparity back.

The cubic resize is separable: per resized axis a dense (n_in, n_out)
weight matrix, contracted with the image by two matrix products (the
reference's einsum). The weights are a copy of JAX's
``compute_weight_mat`` with ``_fill_keys_cubic_kernel`` (Keys, a = -0.5):
sample positions ``(i + 0.5) / scale - 0.5``, the kernel widened by
``max(1 / scale, 1)`` (antialiased when it shrinks), each column
normalised where its sum exceeds ``1000 eps``, and zeroed where the
sample leaves ``[-0.5, n_in - 0.5]``. They are computed once a size pair
in float32 on the host, as XLA folds them, and cached. An axis whose size
does not change is left as it is, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_F = np.float32


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((_F(1.5) * x - _F(2.5)) * x) * x + _F(1.0)
    out = np.where(x >= 1.0,
                   ((_F(-0.5) * x + _F(2.5)) * x - _F(4.0)) * x + _F(2.0),
                   out)
    return np.where(x >= 2.0, _F(0.0), out).astype(np.float32)


@functools.cache
def _cubic_weights_np(n_in: int, n_out: int) -> np.ndarray:
    # the reference's scale and its inverse are Python floats, rounded to
    # float32 where they meet the float32 arrays
    inv_scale = _F(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, _F(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + _F(0.5)) * inv_scale
                - _F(0.0) * inv_scale - _F(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale)
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, _F(1.0)), _F(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= _F(n_in) - _F(0.5))
    return np.where(inside[None, :], w, _F(0.0)).astype(np.float32)


@functools.cache
def cubic_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """The (n_in, n_out) float32 weights of one axis, on ``device`` (kept:
    a copy from the host each call would wait for the device)."""
    return torch.from_numpy(_cubic_weights_np(n_in, n_out)).to(device)


def resize_cubic(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(..., h, w) float32 -> (..., H, W) by the antialiased Keys cubic
    resize. The matrix products are library calls (the reference leaves
    its einsum to XLA)."""
    x = img.to(torch.float32)
    if x.shape[-2] != H:
        x = torch.matmul(cubic_weights(x.shape[-2], H, x.device).T, x)
    if x.shape[-1] != W:
        x = torch.matmul(x, cubic_weights(x.shape[-1], W, x.device))
    return x


@functools.cache
def _nearest_index(n_out: int, n_in: int,
                   device: torch.device) -> torch.Tensor:
    """Source index of ``jax.image.resize(..., "nearest")`` on ``device``
    (kept): half-pixel centres, ``floor((i + 0.5) * n_in / n_out)`` as XLA
    folds it, a product with the float32 constant ``n_in * (1 / n_out)``
    (a true division, or a product with the reciprocal alone, picks
    another source where the exact quotient is an integer: 18 -> 127 px
    at 63)."""
    c = _F(n_in) * (_F(1.0) / _F(n_out))
    pos = np.arange(n_out, dtype=np.float32) + _F(0.5)
    return torch.from_numpy(np.floor(pos * c).astype(np.int64)).to(device)


def resize_nearest(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(..., h, w) -> (..., H, W), nearest, as the reference resizes."""
    ys = _nearest_index(H, x.shape[-2], x.device)
    xs = _nearest_index(W, x.shape[-1], x.device)
    return x[..., ys[:, None], xs[None, :]]
