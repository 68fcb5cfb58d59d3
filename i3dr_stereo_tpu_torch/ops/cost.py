"""Pixel matching costs for the BM / SGBM backends (torch port of
``i3dr_stereo_tpu.ops.cost``): the x-Sobel and normalized-response
prefilters, the Birchfield–Tomasi and SAD cost volumes, the box
aggregation over the correlation window and the BM texture response.

Plain torch (the JAX package computes these in XLA, with no Pallas
kernel), but for SGBM's aggregated BT cost on the card:
:func:`bt_box_cost_volume` launches the ``bt_box_cost`` kernel
(``csrc/bt_box_cost.cu``), the BT cost and its box sum in one pass, and
runs the plain twin on a CPU tensor. The sums keep the reference's
float32 summation order, so the results equal it bit for bit on
fractional images too: a box sum adds the window's taps in order, over H
and then W; the normalized-response window sum is a difference of two
cumulative sums taken in the blocked order XLA's cumulative
reduce-window uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.ops.shift import gather_disparity_shifted

BIG_COST = 1.0e9
_SCAN_BLOCK = 16       # XLA rewrites a cumulative sum into blocks of 16
_BOX_RING_RADIUS = 8   # bt_box_cost's one pass; wider takes two, via scratch


def _as_batch(image: torch.Tensor):
    batched = image.ndim == 3
    return (image if batched else image[None]).to(torch.float32), batched


def _taps(x: torch.Tensor, axis: int, offsets):
    """``x`` shifted by each offset along ``axis`` with the edge
    replicated (index clamping), one copy at a time."""
    n = x.shape[axis]
    base = torch.arange(n, device=x.device)
    return (x.index_select(axis, (base + o).clamp(0, n - 1))
            for o in offsets)


def xsobel_prefilter(image: torch.Tensor, cap: int = 31) -> torch.Tensor:
    """Horizontal Sobel, clipped into [0, 2*cap] around cap (cv's ftzero
    table: ``clip(sobel_x + cap, 0, 2cap)``)."""
    img, batched = _as_batch(image)
    up, mid, dn = _taps(img, 1, (-1, 0, 1))
    (ul, ur), (ml, mr), (dl, dr) = (_taps(r, 2, (-1, 1))
                                    for r in (up, mid, dn))
    gx = (ur - ul) + 2.0 * (mr - ml) + (dr - dl)
    out = (gx + cap).clamp(0.0, 2.0 * cap)
    return out if batched else out[0]


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis, added in order."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def _cumsum_blocked(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis in XLA's order:
    sequential within blocks of 16, plus the exclusive cumulative sum of
    the block totals (taken the same way, recursively)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _scan(x)
    nb = -(-n // _SCAN_BLOCK)
    inner = _scan(F.pad(x, (0, nb * _SCAN_BLOCK - n))
                  .reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    prefix = F.pad(_cumsum_blocked(inner[..., -1]), (1, 0))[..., :nb]
    return ((inner + prefix[..., None])
            .reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n])


def normalized_response_prefilter(image: torch.Tensor, winsize: int = 9,
                                  cap: int = 31) -> torch.Tensor:
    """cv::StereoBM's PREFILTER_NORMALIZED_RESPONSE::

        scale_g = winsize^2 // 8;  scale_s = (1024 + scale_g) // (2*scale_g)
        val = floor((cross8(I)*scale_g*scale_s - boxsum(I)*scale_s) / 1024)
        out = clip(val, -cap, cap) + cap

    with cross8 = 4*I + up + down + left + right and boxsum the
    replicate-border window sum (a difference of cumulative sums)."""
    img, batched = _as_batch(image)
    r = winsize // 2
    scale_g = winsize * winsize // 8
    scale_s = (1024 + scale_g) // (scale_g * 2)

    up, dn = _taps(img, 1, (-1, 1))
    lf, rt = _taps(img, 2, (-1, 1))
    cross = 4.0 * img + lf + rt + up + dn

    pw = F.pad(img[:, None], (r, r, r, r), mode="replicate")[:, 0]
    cs = F.pad(_cumsum_blocked(pw.transpose(1, 2)).transpose(1, 2),
               (0, 0, 1, 0))
    rows = cs[:, winsize:, :] - cs[:, :-winsize, :]
    cs2 = F.pad(_cumsum_blocked(rows), (1, 0))
    boxsum = cs2[:, :, winsize:] - cs2[:, :, :-winsize]

    val = torch.floor((cross * float(scale_g * scale_s)
                       - boxsum * float(scale_s)) / 1024.0)
    out = val.clamp(-float(cap), float(cap)) + cap
    return out if batched else out[0]


def _half_sample_bounds(img: torch.Tensor):
    """Per-pixel min/max over {I, (I+I[x-1])/2, (I+I[x+1])/2} (BT)."""
    left, right = _taps(img, img.ndim - 1, (-1, 1))
    minus = 0.5 * (img + left)
    plus = 0.5 * (img + right)
    lo = torch.minimum(torch.minimum(minus, plus), img)
    hi = torch.maximum(torch.maximum(minus, plus), img)
    return lo, hi


def bt_cost_volume(left: torch.Tensor, right: torch.Tensor,
                   min_disparity: int, disparity_range: int):
    """Birchfield–Tomasi pixel cost volume: ((B, H, W, D) float32,
    valid)::

        d(x_l, x_r) = min(max(0, L - Rmax, Rmin - L),
                          max(0, R - Lmax, Lmin - R))

    on (typically prefiltered) (B, H, W) images; BIG_COST where invalid."""
    lL, hL = _half_sample_bounds(left)
    lR, hR = _half_sample_bounds(right)
    Rg, valid = gather_disparity_shifted(right, min_disparity,
                                         disparity_range)
    lRg, _ = gather_disparity_shifted(lR, min_disparity, disparity_range)
    hRg, _ = gather_disparity_shifted(hR, min_disparity, disparity_range)
    L = left[..., None]
    dl = torch.maximum(L - hRg, lRg - L).clamp(min=0.0)
    dr = torch.maximum(Rg - hL[..., None], lL[..., None] - Rg).clamp(min=0.0)
    return torch.where(valid, torch.minimum(dl, dr), BIG_COST), valid


def sad_cost_volume(left: torch.Tensor, right: torch.Tensor,
                    min_disparity: int, disparity_range: int):
    """Plain |L - R(x-d)| pixel cost (BM family), BIG_COST where invalid."""
    Rg, valid = gather_disparity_shifted(right, min_disparity,
                                         disparity_range)
    return torch.where(valid, (left[..., None] - Rg).abs(), BIG_COST), valid


def box_sum(x: torch.Tensor, window: int, axes=(1, 2)) -> torch.Tensor:
    """Sum over a window x window box, edge-replicated, separable: one
    1-D sliding sum per axis (in ``axes`` order), each adding the taps
    x[k-r] + ... + x[k+r] in order."""
    r = window // 2
    for ax in axes:
        taps = _taps(x, ax, range(-r, r + 1))
        x = next(taps)
        for t in taps:
            x = x + t
    return x


def box_aggregate(C: torch.Tensor, valid: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Aggregate a (B, H, W, D) pixel-cost volume over the correlation
    window. Invalid (x, d) taps contribute zero to the neighbouring
    window sums, and the entry itself stays BIG_COST where invalid."""
    if window <= 1:
        return C
    summed = box_sum(torch.where(valid, C, 0.0), window, axes=(1, 2))
    return torch.where(valid, summed, BIG_COST)


def bt_box_cost_volume(left: torch.Tensor, right: torch.Tensor,
                       min_disparity: int, disparity_range: int,
                       window: int) -> torch.Tensor:
    """SGBM's aggregated BT cost, (B, H, W, D) float32:
    ``box_aggregate(*bt_cost_volume(left, right, ...), window)`` on the
    (B, H, W) prefiltered images, BIG_COST where (x, d) is invalid. A CPU
    tensor runs that plain twin; any other tensor launches the
    ``bt_box_cost`` kernel, which is bit-equal to it at every window, or
    raises. Windows of 19 and wider take the kernel's two passes through a
    scratch volume of the output's shape."""
    if left.device.type == "cpu":
        return box_aggregate(*bt_cost_volume(left, right, min_disparity,
                                             disparity_range), window)
    if left.ndim != 3 or left.shape != right.shape:
        raise ValueError(f"bt_box_cost_volume: (B, H, W) images of one "
                         f"shape, got {tuple(left.shape)} and "
                         f"{tuple(right.shape)}")
    left, right = (x.to(torch.float32).contiguous() for x in (left, right))
    _build.require_cuda(left, right)
    B, H, W = left.shape
    radius = max(window, 1) // 2
    out = torch.empty((B, H, W, disparity_range), dtype=torch.float32,
                      device=left.device)
    scratch = torch.empty_like(out) if radius > _BOX_RING_RADIUS else None
    _build.launch("i3dr_bt_box_cost", "bt_box_cost", left.device,
                  left.data_ptr(), right.data_ptr(), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), B, H, W,
                  disparity_range, int(min_disparity), radius,
                  _build.stream_of(left))
    return out


def texture_response(prefiltered: torch.Tensor, window: int,
                     cap: int = 31) -> torch.Tensor:
    """cv::StereoBM texture check: sum |pref - cap| over the SAD window."""
    nd = prefiltered.ndim
    return box_sum((prefiltered - float(cap)).abs(), window,
                   axes=(nd - 2, nd - 1))
