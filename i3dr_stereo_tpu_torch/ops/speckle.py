"""Speckle filtering: invalidate small disconnected disparity regions
(torch port of ``i3dr_stereo_tpu.ops.speckle``).

The exact ``cv::filterSpeckles`` keep-mask: a pixel survives iff its
4-connected component of the ``|d_p - d_q| <= max_diff`` graph over valid
pixels has more than ``max_size`` pixels (the engine's "Disparity Speckle
Filter Max Difference = 0.5 / Max Region Size = 100",
ini/quick.param:94-95).

- :func:`speckle_keep` launches the ``speckle_ccl`` kernel
  (``csrc/speckle_ccl.cu``: union-find labelling, each tile root's count
  added at its component's root, the port of the TPU's
  ``speckle_filter_pallas``) for a CUDA tensor and
  runs :func:`speckle_keep_plain` for a CPU tensor.
- :func:`speckle_keep_plain` is the reference's XLA formulation: S+2
  min-label rounds, 3 change-detection rounds, 2L+4 dirty-spread rounds
  and one histogram — exact and bounded, with the proof in the JAX
  module's docstring.
- :func:`speckle_filter` adds the ``downsample`` front-end (plain torch
  on every device): the k x k block minimum of the valid disparities,
  size threshold ``max(max_size // k^2, 1)``, ``max_diff * k``, and the
  verdict broadcast back.

The TPU's reroute of large thresholds at large frames to XLA was a VMEM
workaround; the port has one path for every size.
"""

from __future__ import annotations

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build

_NEIGH = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """r[..., y, x] = x[..., y - dy, x - dx], ``fill`` outside."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def _check(d: torch.Tensor, v: torch.Tensor) -> None:
    if d.ndim != 3 or v.shape != d.shape or d.dtype != torch.float32 \
            or v.dtype != torch.bool:
        raise ValueError(f"expected float32 disparities and a bool mask, "
                         f"both (B, H, W), got {tuple(d.shape)} {d.dtype} / "
                         f"{tuple(v.shape)} {v.dtype}")


def speckle_keep_plain(d: torch.Tensor, v: torch.Tensor, max_size: int,
                       max_diff, iters: int = 0) -> torch.Tensor:
    """Plain torch twin of the ``speckle_ccl`` kernel (the reference's
    XLA formulation; ``iters > 0`` overrides its propagation budget, which
    makes it inexact, as in the reference)."""
    _check(d, v)
    B, H, W = d.shape
    dev = d.device
    md = torch.as_tensor(max_diff, dtype=torch.float32, device=dev)
    INF_LABEL = H * W
    L = iters if iters > 0 else max_size + 2

    ids = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(1, H, W)
    label = torch.where(v, ids, INF_LABEL)
    conn = [v & _shift(v, dy, dx, False)
            & ((d - _shift(d, dy, dx, float("inf"))).abs() <= md)
            for dy, dx in _NEIGH]

    def prop(lab):
        for (dy, dx), m in zip(_NEIGH, conn):
            nl = _shift(lab, dy, dx, INF_LABEL)
            lab = torch.minimum(lab, torch.where(m, nl, INF_LABEL))
        return lab

    for _ in range(L):
        label = prop(label)
    # change detection: unconverged regions keep making progress
    dirty = torch.zeros_like(v)
    for _ in range(3):
        nxt = prop(label)
        dirty = dirty | (nxt != label)
        label = nxt
    # dirtiness spreads along region edges: diam(catchment) <= 2L, +margin
    for _ in range(2 * L + 4):
        for (dy, dx), m in zip(_NEIGH, conn):
            dirty = dirty | (m & _shift(dirty, dy, dx, False))

    # exact sizes of (converged) components: one histogram + one lookup
    lab = label.reshape(B, H * W)
    ones = (lab < INF_LABEL).to(torch.int32)
    safe = lab.clamp(0, H * W - 1).long()
    counts = torch.zeros((B, H * W), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, safe, ones)
    size = torch.gather(counts, 1, safe).reshape(B, H, W)
    return v & (dirty | (size > max_size))


def speckle_keep(d: torch.Tensor, v: torch.Tensor, max_size: int,
                 max_diff) -> torch.Tensor:
    """Exact keep-mask of (B, H, W) float32 disparities ``d`` and bool
    validity ``v``. ``max_diff`` is a runtime scalar. A CPU tensor takes
    the plain version; a CUDA tensor launches the ``speckle_ccl`` kernel
    (or raises)."""
    if d.device.type == "cpu":
        return speckle_keep_plain(d, v, max_size, max_diff)
    _check(d, v)
    _build.require_cuda(d, v)
    B, H, W = d.shape
    if H * W >= 2 ** 31:
        raise ValueError(f"frame of {H}x{W} pixels: labels are int32")
    labels = torch.empty((B, H, W), dtype=torch.int32, device=d.device)
    sizes = torch.empty_like(labels)
    keep = torch.empty_like(v)
    _build.launch("i3dr_speckle_ccl", "speckle_ccl", d.device,
                  d.data_ptr(), v.data_ptr(), labels.data_ptr(),
                  sizes.data_ptr(), keep.data_ptr(), B, H, W, int(max_size),
                  float(max_diff), _build.stream_of(d))
    return keep


def block_min(disp: torch.Tensor, valid: torch.Tensor, k: int):
    """The downsample front-end: (B, H, W) -> (B, ceil(H/k), ceil(W/k))
    minimum of the valid disparities of each k x k block (inf where none)
    and the block's ``any`` of validity, on the frame zero-padded to
    multiples of k."""
    B, H, W = disp.shape
    H2, W2 = -(-H // k), -(-W // k)
    pad = (0, W2 * k - W, 0, H2 * k - H)
    d = torch.nn.functional.pad(disp.to(torch.float32), pad)
    v = torch.nn.functional.pad(valid, pad)
    masked = torch.where(v, d, float("inf"))
    dd = masked.reshape(B, H2 * k, W2, k).amin(-1)
    dd = dd.reshape(B, H2, k, W2).amin(2)
    vv = v.reshape(B, H2 * k, W2, k).any(-1)
    vv = vv.reshape(B, H2, k, W2).any(2)
    return dd.contiguous(), vv.contiguous()


def speckle_filter(disp: torch.Tensor, valid: torch.Tensor, *, max_size: int,
                   max_diff, iters: int = 0, downsample: int = 1,
                   plain: bool = False) -> torch.Tensor:
    """Return the valid mask with speckles removed.

    disp: (H, W) or (B, H, W) float disparities; valid: same-shape bool.
    ``iters`` overrides the propagation budget (0 = exact: max_size + 2)
    and then runs the plain formulation on every device, as the reference
    does. ``downsample`` > 1 labels the k x k block minima with threshold
    ``max(max_size // k^2, 1)`` and ``max_diff * k`` (float32) and
    broadcasts the rejection back. ``plain`` runs the plain twin on
    whatever device the tensors are on."""
    if max_size <= 0:
        return valid
    batched = disp.ndim == 3
    d3 = (disp if batched else disp[None]).to(torch.float32).contiguous()
    v3 = (valid if batched else valid[None]).contiguous()
    B, H, W = d3.shape
    if downsample > 1:
        k = int(downsample)
        dd, vv = block_min(d3, v3, k)
        keep_small = speckle_filter(
            dd, vv, max_size=max(max_size // (k * k), 1),
            max_diff=float(np.float32(max_diff) * np.float32(k)),
            iters=iters, plain=plain)
        rejected = vv & ~keep_small
        H2, W2 = rejected.shape[1:]
        rej_full = rejected[:, :, None, :, None].expand(B, H2, k, W2, k) \
            .reshape(B, H2 * k, W2 * k)
        keep = v3 & ~rej_full[:, :H, :W]
    elif plain or iters > 0:
        keep = speckle_keep_plain(d3, v3, max_size, max_diff, iters)
    else:
        keep = speckle_keep(d3, v3, max_size, max_diff)
    return keep if batched else keep[0]
