"""Plain reference of constant-space belief propagation (the port's
``matchers/bp.py:belief_propagation_match`` with ``constant_space=True``,
standing for upstream's ``cv::cuda::StereoConstantSpaceBP``), with the
JAX package's semantics, which the port keeps:

- an image pyramid by 2x2 mean pooling (lane-pair sums, then row-pair
  sums, then x0.25; cropped to even sizes), at most 4 levels, a level
  added while the smaller side is at least 16 px;
- at the coarsest level, dense min-sum BP (:mod:`BP_GPU`'s data cost and
  message update) over ``Dc = max(K, D // 2^(levels - 1))`` disparities
  from 0, whatever ``min_disparity`` says;
- the K best planes a pixel from the coarse belief (a stable sort, the
  lower disparity first among equal beliefs), their messages gathered;
- at each finer level the candidates doubled and upsampled by nearest x2
  (the odd last row, then column, replicating its neighbour), the
  messages upsampled the same way, each plane's truncated AD cost at its
  whole disparity, and BP on the planes: ``h_i = (((data + inc0) + inc1)
  + inc2) + inc3 - inc_(i^1)``, ``msg_i[k] = min_k' (h_i[k'] + min(|d_k'
  - d_k|, MAX_DISC_TERM))`` (the sender's candidates on both axes), then
  the mean subtracted;
- the argmin plane of ``data + (((inc0 + inc1) + inc2) + inc3)``, then
  the speckle filter at ``max(speckle_range, 1)``, unbinned.

So level-0 disparities are multiples of 2^(levels - 1): 8 px at 4
levels. As far as is known OpenCV's CSBP keeps full-resolution
disparities at every level, with more planes at its coarser levels; that
departure is the JAX package's, kept here so that the reference and the
port compute the same thing.

The port's rounding points, in float32 (TF32 off): the same operations
on the same values give the same bits. ``dtype`` is the precision of the
final belief and argmin (the control passes bfloat16)."""

from __future__ import annotations

import torch

from portbench.reference import ops
from portbench.reference.matchers import BP_GPU

LEVELS_MAX = 4
MIN_SIDE = 16


def _incoming(m: torch.Tensor) -> list:
    """What each pixel receives from each direction, from (4, 1, K, H, W)
    messages."""
    return [BP_GPU._shift2d(m[i], dy, dx)
            for i, (dy, dx) in enumerate(BP_GPU._DIRS)]


def up2(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Nearest x2 of (..., h, w) to (..., H, W); the odd last row, then
    the odd last column, replicate their neighbours."""
    out = BP_GPU.upsample(x, H, W)
    h, w = min(H, 2 * x.shape[-2]), min(W, 2 * x.shape[-1])
    if h < H:
        out[..., h:, :] = out[..., h - 1:h, :]
    if w < W:
        out[..., :, w:] = out[..., :, w - 1:w]
    return out


def iterate_planes(data: torch.Tensor, dvals: torch.Tensor,
                   msgs: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` synchronous min-sum updates on the planes: data, dvals
    (1, K, H, W), msgs (4, 1, K, H, W)."""
    diff = (dvals[:, :, None] - dvals[:, None, :]).abs()
    V = (BP_GPU.DISC_SINGLE_JUMP * diff).clamp(
        max=BP_GPU.MAX_DISC_TERM)[None]
    del diff
    m = msgs
    for _ in range(iters):
        inc = torch.stack(_incoming(m))
        total = data + inc[0] + inc[1] + inc[2] + inc[3]
        h = total[None] - inc[list(BP_GPU._OPP)]
        del inc, total
        out = (h[:, :, :, None] + V).amin(2)
        del h
        m = out - BP_GPU._mean(out)
    return m


def pyramid(l: torch.Tensor, r: torch.Tensor, levels: int) -> list:
    """[(left, right), ...] finest first."""
    pyr = [(l, r)]
    for _ in range(max(1, min(levels, LEVELS_MAX)) - 1):
        if min(pyr[-1][0].shape[-2:]) < MIN_SIDE:
            break
        pyr.append((ops.downsample2(pyr[-1][0]), ops.downsample2(pyr[-1][1])))
    return pyr


def plane_cost(l: torch.Tensor, r: torch.Tensor, dvals: torch.Tensor):
    """The truncated AD cost (1, K, H, W) of each plane at its whole
    disparity, 0.7 where the tap leaves the image, and that mask."""
    B, K, H, W = dvals.shape
    xs = torch.arange(W, dtype=torch.int32, device=l.device)
    src = xs - torch.round(dvals).to(torch.int32)
    ok = (src >= 0) & (src < W)
    Rg = r[:, None].expand(B, K, H, W).gather(3, src.clamp(0, W - 1).long())
    data = BP_GPU.DATA_WEIGHT * (l[:, None] - Rg).abs().clamp(
        max=BP_GPU.MAX_DATA_TERM)
    return torch.where(ok, data,
                       BP_GPU.DATA_WEIGHT * BP_GPU.MAX_DATA_TERM), ok


@torch.no_grad()
def match(l: torch.Tensor, r: torch.Tensor, cfg: dict,
          dtype=torch.float32):
    """(1, H, W) float32 rectified pair -> ((1, H, W) disparity, valid).
    ``dtype`` is the precision of the final belief and argmin."""
    with BP_GPU._no_tf32():
        D = int(cfg["disparity_range"])
        iters = max(1, int(cfg["bp_iters"]))
        K = max(2, min(int(cfg["csbp_planes"]), D))
        pyr = pyramid(l, r, int(cfg["bp_levels"]))
        if len(pyr) < 2:
            raise ValueError("CSBP needs at least two pyramid levels")

        lc, rc = pyr[-1]
        Dc = max(K, D // 2 ** (len(pyr) - 1))
        data = BP_GPU.data_cost(lc, rc, 0, Dc)
        msgs = torch.zeros((4,) + tuple(data.shape), dtype=torch.float32,
                           device=l.device)
        msgs = BP_GPU.iterate(data, msgs, iters,
                              BP_GPU.slab_rows(Dc, data.shape[-1]))
        belief = data + sum(_incoming(msgs))
        idx = torch.sort(belief, dim=1, stable=True).indices[:, :K]
        dvals = idx.to(torch.float32)
        msgs = torch.stack([msgs[i].gather(1, idx) for i in range(4)])
        del belief, idx

        for lf, rf in pyr[-2::-1]:
            H, W = lf.shape[-2:]
            dvals = 2.0 * up2(dvals, H, W)
            msgs = up2(msgs, H, W)
            data, ok = plane_cost(lf, rf, dvals)
            msgs = iterate_planes(data, dvals, msgs, iters)

        belief = data.to(dtype) + sum(x.to(dtype) for x in _incoming(msgs))
        kbest = belief.argmin(1, keepdim=True)
        disp = dvals.gather(1, kbest)[:, 0]
        valid = ok.gather(1, kbest)[:, 0]
        valid = ops.speckle_filter(
            disp, valid, max_size=int(cfg["speckle_size"]),
            max_diff=max(float(cfg["speckle_range"]), 1.0), downsample=1)
        return disp, valid
