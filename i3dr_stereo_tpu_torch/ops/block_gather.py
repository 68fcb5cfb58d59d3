"""Row gather with a per-block anchor clamp (torch port of
``i3dr_stereo_tpu.ops.block_gather``).

The pyramid gathers along image rows twice per level: to warp the right
image by the coarse prediction (``rw[x] = r[x - pred(x)]``) and to look
up the right-anchored disparity in the backmatch check. On the TPU the
gather is banded around one anchor per (8-row x 128-column) block; the
band clamp is part of what the pyramid computes (the residual search is
centred on it), so the port keeps it: ``block_anchors`` and the clamp in
``block_shift_gather`` are the reference semantics. The GPU kernel
(``csrc/row_gather.cu``) reads any column, so the TPU's radius limit is
not inherited.
"""

from __future__ import annotations

import torch

from i3dr_stereo_tpu_torch import _build

LANE = 128
ROWS = 8


def pad_edge(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Edge-replicate the last two dims of ``x`` up to (H, W); any dtype."""
    h, w = x.shape[-2:]
    if (h, w) == (H, W):
        return x
    rows = torch.arange(H, device=x.device).clamp_(max=h - 1)
    cols = torch.arange(W, device=x.device).clamp_(max=w - 1)
    return x[..., rows[:, None], cols[None, :]]


def block_anchors(pred_int: torch.Tensor) -> torch.Tensor:
    """Per-(8x128)-block anchor: the prediction sampled at block centres,
    on the prediction edge-padded to a multiple of 128 columns."""
    B, H, W = pred_int.shape
    Wb = (W + LANE - 1) // LANE
    pp = pad_edge(pred_int, H, Wb * LANE)
    return pp[:, ROWS // 2::ROWS, LANE // 2::LANE].contiguous()


def _check(src, idx, q):
    if src.ndim != 3 or idx.shape != src.shape:
        raise ValueError(f"src/idx must be (B, H, W) alike, got "
                         f"{tuple(src.shape)} / {tuple(idx.shape)}")
    B, H, W = src.shape
    want = (B, (H + ROWS - 1) // ROWS, (W + LANE - 1) // LANE)
    if tuple(q.shape) != want:
        raise ValueError(f"q must be {want}, got {tuple(q.shape)}")
    if (src.dtype, idx.dtype, q.dtype) != (torch.float32, torch.int32,
                                           torch.int32):
        raise ValueError(f"expected float32 src and int32 idx/q, got "
                         f"{src.dtype}/{idx.dtype}/{q.dtype}")


def block_shift_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                             q: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain torch twin of the ``row_gather`` kernel."""
    _check(src, idx, q)
    B, H, W = src.shape
    q_up = (q.repeat_interleave(ROWS, 1)[:, :H]
            .repeat_interleave(LANE, 2)[:, :, :W])
    eff = torch.minimum(torch.maximum(idx, q_up - radius), q_up + radius)
    xs = torch.arange(W, dtype=torch.int32, device=src.device)
    col = (xs - eff).clamp(0, W - 1).long()
    return torch.gather(src, 2, col)


def block_shift_gather(src: torch.Tensor, idx: torch.Tensor, q: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """out[b, y, x] = src[b, y, clip(x - clip(idx, q-radius, q+radius), 0, W-1)]

    src float32 / idx int32 (B, H, W); q int32 (B, ceil(H/8), ceil(W/128))
    block anchors. A CPU tensor takes the plain version; a CUDA tensor
    launches the ``row_gather`` kernel (or raises)."""
    if src.device.type == "cpu":
        return block_shift_gather_plain(src, idx, q, radius)
    _check(src, idx, q)
    _build.require_cuda(src, idx, q)
    B, H, W = src.shape
    out = torch.empty_like(src)
    _build.launch("i3dr_row_gather", "row_gather", src.device,
                  src.data_ptr(), idx.data_ptr(), q.data_ptr(), out.data_ptr(),
                  B, H, W, q.shape[1], q.shape[2], int(radius),
                  _build.stream_of(src))
    return out


def gather_along_rows_reference(src: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    """out[b, y, x] = src[b, y, clip(x - idx[b, y, x], 0, W-1)] with no
    anchor clamp (``torch.gather``; the reference's ``take_along_axis``
    form, for tests)."""
    W = src.shape[-1]
    xs = torch.arange(W, dtype=torch.int32, device=src.device)
    col = (xs - idx.to(torch.int32)).clamp(0, W - 1).long()
    return torch.gather(src, 2, col)
