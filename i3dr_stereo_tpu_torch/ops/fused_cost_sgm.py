"""Fused matching cost + forward-horizontal SGM: the lean path (torch port
of ``i3dr_stereo_tpu.ops.fused_cost_sgm``, the reference's
``I3DR_SGM_BACKEND=pallas`` branch, here behind the matchers' ``lean``
argument).

One sweep builds the uint8 cost volume C *and* runs the W->E recurrence
on the unclamped cost, so the float cost never reaches memory; the other
directions then read C (255 = invalid) through the volume kernel of
:mod:`~i3dr_stereo_tpu_torch.ops.sgm` at the exact D, each folded into
the forward pass's plane (float32, or in int16 mode int16, as the
reference asks its kernel for) in place.

- :func:`fused_census_horizontal` — census hamming cost from word planes
  (kernel ``fused_census_fwd``, the TPU's ``_fused_fwd_kernel``:
  ``csrc/fused_census32.cu`` at D = 32, ``csrc/fused_cost_sgm.cu`` at any
  other D);
- :func:`fused_bt_horizontal` — pixelwise Birchfield-Tomasi cost in
  doubled units (kernel ``fused_bt_fwd``, the TPU's ``_fused_bt_kernel``:
  ``csrc/fused_bt.cu``);
- :func:`fused_census_sgm`, :func:`fused_bt_sgm` — the full aggregation:
  the int32 sum of int16-stored group totals (or a float32 sum) in the
  TPU's order, the forward pass first.

For pixel (y, x) and disparity index d the right source column is
``x - base[y // th] - min_disp - d``: one window base per tile of ``th``
rows (8, halved until it divides H). Any base is legal — the TPU's
``base >= -64`` limit came from its reversed, padded right plane.

Each kernel has a plain torch twin (``*_plain``: a Python loop over x,
vectorised over the rest, the reference's float32 operation order). A
CPU tensor takes the twin, a CUDA tensor launches the kernel or raises;
``plain=True`` on the aggregations runs the twins on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.ops.cost import _half_sample_bounds
from i3dr_stereo_tpu_torch.ops.sgm import (
    BIG,
    CLAMP,
    DIRECTIONS_4,
    DIRECTIONS_8,
    MAX_D,
    U8_SENTINEL,
    _groups,
    _step,
    fold_paths,
    sgm_volume_step,
    sgm_volume_step_plain,
)
from i3dr_stereo_tpu_torch.ops.sgm_fused_t import U8_CLAMP, _popcount32


def census_word_planes(census: torch.Tensor) -> torch.Tensor:
    """(B, H, W, nw) packed census -> contiguous (nw, B, H, W) word
    planes (int32 holding the raw 32-bit patterns)."""
    return census.movedim(-1, 0).contiguous()


def row_tile(H: int, th: int = 8) -> int:
    """The reference's row-tile height: ``th`` halved until it divides H."""
    while H % th:
        th //= 2
    return th


def _base_rows(base, H: int, th: int, device) -> Tuple[torch.Tensor, int]:
    """(int32 (H // th,) window bases on ``device``, th)."""
    th = row_tile(H, th)
    base = torch.as_tensor(base, dtype=torch.int32, device=device)
    if base.ndim == 2:
        base = base[0]  # same per-tile layout across the batch
    if base.shape != (H // th,):
        raise ValueError(f"base must hold one entry per tile of {th} rows: "
                         f"({H // th},), got {tuple(base.shape)}")
    return base.contiguous(), th


def _check_out(D: int, out_dtype) -> None:
    if not 1 <= D <= MAX_D:
        raise ValueError(f"D must be 1 to {MAX_D}, got {D}")
    if out_dtype not in (torch.int16, torch.float32):
        raise ValueError(f"out_dtype must be int16 or float32, got "
                         f"{out_dtype}")


def _source_columns(base, th: int, H: int, x: int, D: int, min_disp: int):
    """(H, D) right source columns of left column x."""
    d = torch.arange(D, device=base.device)
    return (x - base.repeat_interleave(th).long()[:, None] - int(min_disp)
            - d[None, :])


def _sweep_plain(cost_at, base, th, B, H, W, D, min_disp, p1, p2, out_dtype,
                 device):
    """The shared sweep of the twins: ``cost_at(x, src_clamped)`` gives the
    unclamped float32 cost (B, H, D) of left column x."""
    C = torch.empty((B, H, W, D), dtype=torch.uint8, device=device)
    S = torch.empty((B, H, W, D), dtype=out_dtype, device=device)
    carry = torch.zeros((B, H, D), dtype=torch.float32, device=device)
    for x in range(W):
        src = _source_columns(base, th, H, x, D, min_disp)
        valid = (src >= 0) & (src <= W - 1)
        cost = cost_at(x, src.clamp(0, W - 1))
        C[:, :, x] = torch.where(valid, cost.clamp(max=float(U8_CLAMP)),
                                 float(U8_SENTINEL)).to(torch.uint8)
        carry = _step(carry, torch.where(valid, cost, BIG), p1, p2)
        S[:, :, x] = (carry if out_dtype == torch.float32
                      else carry.clamp(max=CLAMP).to(torch.int16))
    return C, S


# ---------------------------------------------------------------------------
# J: census cost + forward pass
# ---------------------------------------------------------------------------

def _check_planes(cl, cr):
    if cl.ndim != 4 or cl.shape != cr.shape or cl.dtype != torch.int32 \
            or cr.dtype != torch.int32:
        raise ValueError("census word planes must be two int32 (NW, B, H, W) "
                         f"tensors, got {tuple(cl.shape)} {cl.dtype} / "
                         f"{tuple(cr.shape)} {cr.dtype}")


def fused_census_horizontal_plain(cl_words, cr_words, base, D: int, p1, p2,
                                  min_disp: int = 0, out_dtype=torch.int16,
                                  th: int = 8):
    """Plain torch twin of the ``fused_census_fwd`` kernel."""
    _check_planes(cl_words, cr_words)
    _check_out(D, out_dtype)
    NW, B, H, W = cl_words.shape
    base, th = _base_rows(base, H, th, cl_words.device)
    cl = cl_words.to(torch.int64) & 0xFFFFFFFF
    cr = cr_words.to(torch.int64) & 0xFFFFFFFF

    def cost_at(x, src):
        idx = src.expand(NW, B, H, D)
        ham = _popcount32(cl[..., x, None] ^ cr.gather(3, idx)).sum(0)
        return ham.to(torch.float32)

    return _sweep_plain(cost_at, base, th, B, H, W, D, min_disp, float(p1),
                        float(p2), out_dtype, cl_words.device)


def fused_census_horizontal(cl_words: torch.Tensor, cr_words: torch.Tensor,
                            base, D: int, p1, p2, min_disp: int = 0,
                            out_dtype=torch.int16, th: int = 8):
    """The cost volume and the forward-horizontal path costs in one pass.

    cl_words/cr_words: (NW, B, H, W) int32 census word planes
    (:func:`census_word_planes`). base: (H // th,) or (B, H // th) int32
    window base per row tile. Returns (C uint8 (B, H, W, D): min(hamming,
    254), 255 where the source column is outside the image; S (B, H, W,
    D): the path costs on the unclamped hamming distance, float32, or for
    ``out_dtype=torch.int16`` ``trunc(min(L, 10000))``). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    if cl_words.device.type == "cpu":
        return fused_census_horizontal_plain(cl_words, cr_words, base, D, p1,
                                             p2, min_disp, out_dtype, th)
    _check_planes(cl_words, cr_words)
    _check_out(D, out_dtype)
    _build.require_cuda(cl_words, cr_words)
    NW, B, H, W = cl_words.shape
    base, th = _base_rows(base, H, th, cl_words.device)
    C = torch.empty((B, H, W, D), dtype=torch.uint8, device=cl_words.device)
    S = torch.empty((B, H, W, D), dtype=out_dtype, device=cl_words.device)
    _build.launch("i3dr_fused_census_fwd", "fused_census_fwd",
                  cl_words.device, cl_words.data_ptr(), cr_words.data_ptr(),
                  base.data_ptr(), th, C.data_ptr(), S.data_ptr(),
                  int(out_dtype == torch.int16), B, H, W, NW, D,
                  int(min_disp), float(p1), float(p2),
                  _build.stream_of(cl_words))
    return C, S


# ---------------------------------------------------------------------------
# K: Birchfield-Tomasi cost + forward pass
# ---------------------------------------------------------------------------

def _check_images(left, right):
    if left.ndim != 3 or left.shape != right.shape \
            or left.dtype != torch.float32 or right.dtype != torch.float32:
        raise ValueError("prefiltered images must be two float32 (B, H, W) "
                         f"tensors, got {tuple(left.shape)} {left.dtype} / "
                         f"{tuple(right.shape)} {right.dtype}")


def fused_bt_horizontal_plain(left, right, base, D: int, p1, p2,
                              min_disp: int = 0, out_dtype=torch.int16,
                              th: int = 8):
    """Plain torch twin of the ``fused_bt_fwd`` kernel."""
    _check_images(left, right)
    _check_out(D, out_dtype)
    B, H, W = left.shape
    base, th = _base_rows(base, H, th, left.device)
    llo, lhi = _half_sample_bounds(left)
    rlo, rhi = _half_sample_bounds(right)

    def cost_at(x, src):
        idx = src.expand(B, H, D)
        r, lo, hi = right.gather(2, idx), rlo.gather(2, idx), rhi.gather(2, idx)
        lx = left[:, :, x, None]
        dl = torch.maximum(torch.maximum(lx - hi, lo - lx),
                           torch.zeros_like(r))
        dr = torch.maximum(torch.maximum(r - lhi[:, :, x, None],
                                         llo[:, :, x, None] - r),
                           torch.zeros_like(r))
        # doubled units; torch.round is half-to-even, as jnp.round
        return torch.round(2.0 * torch.minimum(dl, dr))

    return _sweep_plain(cost_at, base, th, B, H, W, D, min_disp, float(p1),
                        float(p2), out_dtype, left.device)


def fused_bt_horizontal(left: torch.Tensor, right: torch.Tensor, base, D: int,
                        p1, p2, min_disp: int = 0, out_dtype=torch.int16,
                        th: int = 8):
    """Birchfield-Tomasi counterpart of :func:`fused_census_horizontal`.

    left/right: (B, H, W) float32 prefiltered images (values in
    [0, 2 * prefilter_cap], so the doubled pixelwise cost fits uint8).
    The cost is ``round(2 * min(max(l - rhi, rlo - l, 0), max(r - lhi,
    llo - r, 0)))`` — doubled units, so half-sample values survive the
    uint8 volume exactly. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    if left.device.type == "cpu":
        return fused_bt_horizontal_plain(left, right, base, D, p1, p2,
                                         min_disp, out_dtype, th)
    _check_images(left, right)
    _check_out(D, out_dtype)
    _build.require_cuda(left, right)
    B, H, W = left.shape
    base, th = _base_rows(base, H, th, left.device)
    C = torch.empty((B, H, W, D), dtype=torch.uint8, device=left.device)
    S = torch.empty((B, H, W, D), dtype=out_dtype, device=left.device)
    _build.launch("i3dr_fused_bt_fwd", "fused_bt_fwd", left.device,
                  left.data_ptr(), right.data_ptr(), base.data_ptr(), th,
                  C.data_ptr(), S.data_ptr(), int(out_dtype == torch.int16),
                  B, H, W, D, int(min_disp), float(p1), float(p2),
                  _build.stream_of(left))
    return C, S


# ---------------------------------------------------------------------------
# the full aggregations
# ---------------------------------------------------------------------------

def _aggregate(forward, W: int, D: int, directions, pen, out_dtype,
               plain: bool):
    """Forward pass, then the remaining directions over its uint8 C folded
    into its path costs in the TPU's order: S_fwd, (0, -1), the top-down
    family, the bottom-up family, each family in groups of equal
    penalties (split where the TPU's VMEM rule splits them, at the exact
    D and the given W). The forward pass stores its path costs in
    ``out_dtype``, as the reference asks its kernel to."""
    if (0, 1) not in directions:
        raise ValueError("the fused path needs the W->E direction (0, 1)")
    _check_out(D, out_dtype)
    C, S = forward(*pen[(0, 1)], out_dtype)
    groups = _groups(directions, pen, W, D, 1)[1:]
    S = fold_paths(C, groups, out_dtype == torch.int16,
                   sgm_volume_step_plain if plain else sgm_volume_step, S)
    return S, C


def fused_bt_sgm(left: torch.Tensor, right: torch.Tensor, D: int, *,
                 min_disp: int = 0, p1: float = 8.0, p2: float = 32.0,
                 directions=None, out_dtype=torch.int16,
                 plain: bool = False):
    """Full pixelwise-BT SGM (the lean SGBM path, blockSize = 1
    semantics). left/right: (B, H, W) prefiltered (xsobel-clipped)
    images. Returns (S, C): costs and S are in DOUBLED units; p1/p2 come
    in normal cost units and are doubled here. WTA, parabolic subpixel
    and uniqueness are scale-invariant. S is the int32 sum of
    int16-stored group totals, or float32 for ``out_dtype=torch.float32``."""
    directions = tuple(tuple(d) for d in (directions or DIRECTIONS_8))
    B, H, W = left.shape
    pp = (2.0 * float(p1), 2.0 * float(p2))
    fwd = fused_bt_horizontal_plain if plain else fused_bt_horizontal
    base = torch.zeros((H // row_tile(H),), dtype=torch.int32,
                       device=left.device)

    def forward(q1, q2, od):
        return fwd(left, right, base, D, q1, q2, min_disp=min_disp,
                   out_dtype=od)

    return _aggregate(forward, W, D, directions,
                      {d: pp for d in directions}, out_dtype, plain)


def fused_census_sgm(cl_census: torch.Tensor, cr_census: torch.Tensor, D: int,
                     *, base: int = 0, min_disp: int = 0, p1: float = 10.0,
                     p2: float = 120.0, per_direction_penalties=None,
                     directions=None, out_dtype=torch.int16,
                     plain: bool = False):
    """Full SGM aggregation with the fused cost build.

    cl_census/cr_census: (B, H, W, nw) packed census. ``base``: the
    uniform window base (e.g. -K // 2 for residual matching against a
    warped right view). Returns (S, C): the summed path costs over
    ``directions`` (default the 4-path set) and the uint8 cost volume. S
    is the int32 sum of int16-stored group totals, or float32 for
    ``out_dtype=torch.float32``."""
    directions = tuple(tuple(d) for d in (directions or DIRECTIONS_4))
    if per_direction_penalties is None:
        pen = {d: (float(p1), float(p2)) for d in directions}
    else:
        pen = {d: (float(per_direction_penalties[i][0]),
                   float(per_direction_penalties[i][1]))
               for i, d in enumerate(directions)}
    clw, crw = census_word_planes(cl_census), census_word_planes(cr_census)
    NW, B, H, W = clw.shape
    fwd = fused_census_horizontal_plain if plain else fused_census_horizontal
    base_arr = torch.full((H // row_tile(H),), int(base), dtype=torch.int32,
                          device=clw.device)

    def forward(q1, q2, od):
        return fwd(clw, crw, base_arr, D, q1, q2, min_disp=min_disp,
                   out_dtype=od)

    return _aggregate(forward, W, D, directions, pen, out_dtype, plain)
