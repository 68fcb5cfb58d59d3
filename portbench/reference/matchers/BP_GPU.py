"""Plain reference of dense belief propagation (the port's
``matchers/bp.py:belief_propagation_match`` with ``constant_space=False``,
upstream's ``cv::cuda::StereoBeliefPropagation``): min-sum loopy BP on the
4-connected grid over a 2x2 sum-pooled cost pyramid, then WTA over the
belief with no uniqueness check and no speckle filter.

- data cost: ``DATA_WEIGHT * min(|L - R|, MAX_DATA_TERM)``, ``DATA_WEIGHT
  * MAX_DATA_TERM`` where the tap leaves the image;
- pyramid: 2x2 sum pooling of the costs, cropped to even sizes, while the
  smaller side is at least 8 px, at most 5 levels;
- a message update, from the previous iteration's messages only: ``h_i =
  (((data + inc0) + inc1) + inc2) + inc3 - inc_(i^1)``, the linear
  truncated distance transform over d (a forward and a backward min-scan
  with step ``DISC_SINGLE_JUMP`` from ``BIG``, capped at ``min h +
  MAX_DISC_TERM``), then the mean subtracted, a sequential sum over d
  times the float32 reciprocal of D;
- levels coarse to fine, messages upsampled by nearest x2 (the odd last
  row and column zero); the belief ``data + inc0 + inc1 + inc2 + inc3``.

The port's rounding points, in float32 (TF32 off): the same operations on
the same values give the same bits. Volumes are disparity-major, (1, D,
H, W), messages (4, 1, D, H, W); message ``i`` flows towards ``_DIRS[i]``.

An iteration runs in row slabs (:func:`iterate`): a pixel's new message
reads only its own data and its four neighbours' previous messages, so a
slab of rows with one row of halo above and below gives its rows
exactly. The slabs overwrite one message volume from the top down, each
keeping the previous messages of its last row for the next slab's halo,
so the reference holds the pyramid, one message volume and one slab's
temporaries. ``dtype`` is the precision of the belief and the WTA."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import ops

BIG = 1.0e9
DATA_WEIGHT = 0.07
MAX_DATA_TERM = 10.0
DISC_SINGLE_JUMP = 1.0
MAX_DISC_TERM = 1.7
LEVELS_MAX = 5
_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_OPP = (1, 0, 3, 2)
SLAB_BYTES = 1 << 29    # one message plane of a slab, halo included, at most


@contextlib.contextmanager
def _no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def slab_rows(D: int, W: int) -> int:
    """Rows of a slab: a (D, rows + 2, W) float32 plane within
    ``SLAB_BYTES``, at least one."""
    return max(1, SLAB_BYTES // (4 * D * W) - 2)


def data_cost(l, r, min_d: int, D: int) -> torch.Tensor:
    """(1, H, W) images -> the (1, D, H, W) truncated AD cost, in row
    slabs (each pixel's costs are its own)."""
    _, H, W = l.shape
    out = torch.empty((1, D, H, W), dtype=torch.float32, device=l.device)
    rows = slab_rows(D, W)
    for a in range(0, H, rows):
        b = min(a + rows, H)
        Rg, valid = ops.gather_disparity_shifted(r[:, a:b], min_d, D)
        c = DATA_WEIGHT * (l[:, a:b, :, None] - Rg).abs().clamp(
            max=MAX_DATA_TERM)
        c = torch.where(valid, c, DATA_WEIGHT * MAX_DATA_TERM)
        out[:, :, a:b] = c.permute(0, 3, 1, 2)
    return out


def pool2(x: torch.Tensor) -> torch.Tensor:
    H2, W2 = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :H2, :W2]
    return ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2]) \
        + x[..., 1::2, 1::2]


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., y, x] = x[..., y - dy, x - dx]``, zero outside."""
    H, W = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def _distance_transform(h: torch.Tensor) -> torch.Tensor:
    """Over axis 2 of (4, 1, D, h, W): forward then backward min-scans
    from BIG, each step adding the jump, then the cap."""
    out = torch.empty_like(h)
    D = h.shape[2]
    carry = torch.full_like(h[:, :, 0], BIG)
    for d in range(D):
        carry = torch.minimum(h[:, :, d], carry + DISC_SINGLE_JUMP)
        out[:, :, d] = carry
    carry = torch.full_like(h[:, :, 0], BIG)
    for d in range(D - 1, -1, -1):
        carry = torch.minimum(out[:, :, d], carry + DISC_SINGLE_JUMP)
        out[:, :, d] = carry
    cap = h.amin(2, keepdim=True) + MAX_DISC_TERM
    return torch.minimum(out, cap)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Over axis 2, kept: a sum from d = 0 upwards, times float32(1 / D)."""
    D = x.shape[2]
    s = torch.zeros_like(x[:, :, 0])
    for d in range(D):
        s = s + x[:, :, d]
    return (s * float(np.float32(1.0) / np.float32(D))).unsqueeze(2)


def update(data: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One synchronous update of every row of a block: data (1, D, h, W),
    messages (4, 1, D, h, W), the block's edges taken as the image's."""
    inc = [_shift2d(m[i], dy, dx) for i, (dy, dx) in enumerate(_DIRS)]
    total = (((data + inc[0]) + inc[1]) + inc[2]) + inc[3]
    h = torch.stack([total - inc[_OPP[i]] for i in range(4)])
    del inc, total
    out = _distance_transform(h)
    del h
    return out - _mean(out)


def iterate(data: torch.Tensor, msgs: torch.Tensor, iters: int,
            rows: int) -> torch.Tensor:
    """``iters`` synchronous updates of ``msgs`` in place, slabs of
    ``rows`` rows from the top: a slab's block is its rows and one row
    above and below; the row above was overwritten by the slab before, so
    its previous messages are kept aside first."""
    H = data.shape[-2]
    for _ in range(iters):
        above = None
        for a in range(0, H, rows):
            b = min(a + rows, H)
            lo, hi = max(a - 1, 0), min(b + 1, H)
            old = msgs[..., a:hi, :]
            if above is not None:
                old = torch.cat([above, old], dim=-2)
            new = update(data[..., lo:hi, :], old)
            above = msgs[..., b - 1:b, :].clone()
            msgs[..., a:b, :] = new[..., a - lo:b - lo, :]
            del old, new
    return msgs


def upsample(m: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Nearest x2 of (..., h, w) to (..., H, W); the odd last row and
    column zero."""
    out = m.new_zeros(m.shape[:-2] + (H, W))
    h, w = min(H, 2 * m.shape[-2]), min(W, 2 * m.shape[-1])
    for a in (0, 1):
        for b in (0, 1):
            dst = out[..., a:h:2, b:w:2]
            dst.copy_(m[..., :dst.shape[-2], :dst.shape[-1]])
    return out


def pyramid(data0: torch.Tensor, levels: int) -> list:
    pyr = [data0]
    for _ in range(max(1, min(levels, LEVELS_MAX)) - 1):
        if min(pyr[-1].shape[-2:]) < 8:
            break
        pyr.append(pool2(pyr[-1]))
    return pyr


@torch.no_grad()
def match(l: torch.Tensor, r: torch.Tensor, cfg: dict,
          dtype=torch.float32):
    """(1, H, W) float32 rectified pair -> ((1, H, W) disparity, valid).
    ``dtype`` is the precision of the belief and the WTA."""
    with _no_tf32():
        min_d, D = int(cfg["min_disparity"]), int(cfg["disparity_range"])
        iters = max(1, int(cfg["bp_iters"]))
        pyr = pyramid(data_cost(l, r, min_d, D), int(cfg["bp_levels"]))
        msgs = torch.zeros((4,) + tuple(pyr[-1].shape), dtype=torch.float32,
                           device=l.device)
        for data in pyr[::-1]:
            if msgs.shape[-2:] != data.shape[-2:]:
                msgs = upsample(msgs, *data.shape[-2:])
            msgs = iterate(data, msgs, iters,
                           slab_rows(D, data.shape[-1]))
        data0 = pyr[0]
        del pyr, data
        _, H, W = l.shape
        disp = torch.empty((1, H, W), dtype=torch.float32, device=l.device)
        valid = torch.empty((1, H, W), dtype=torch.bool, device=l.device)
        rows = slab_rows(D, W)
        for a in range(0, H, rows):
            b = min(a + rows, H)
            lo, hi = max(a - 1, 0), min(b + 1, H)
            inc = [_shift2d(msgs[i][..., lo:hi, :], dy, dx)[..., a - lo:b - lo, :]
                   for i, (dy, dx) in enumerate(_DIRS)]
            belief = data0[..., a:b, :].to(dtype)
            for x in inc:
                belief = belief + x.to(dtype)
            del inc
            _, tap = ops.gather_disparity_shifted(r[:, a:b], min_d, D)
            S = torch.where(tap, belief.permute(0, 2, 3, 1),
                            torch.tensor(BIG, dtype=dtype, device=l.device))
            disp[:, a:b], valid[:, a:b] = ops.wta_disparity(
                S, min_d, uniqueness_ratio=0.0,
                subpixel=bool(cfg["subpixel"]), dtype=dtype)
            del belief, S
        return disp, valid
