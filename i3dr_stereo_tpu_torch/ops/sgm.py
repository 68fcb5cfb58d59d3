"""SGM path aggregation over cost volumes (torch port of
``i3dr_stereo_tpu.ops.sgm`` and of the TPU kernels behind
``i3dr_stereo_tpu.ops.sgm_pallas.sgm_aggregate_pallas``), plus the
direction tables the flagship's :mod:`~i3dr_stereo_tpu_torch.ops.sgm_fused_t`
shares.

:func:`sgm_aggregate` is what SGBM, dense I3DRSGM and every volume SGM
call run by default. It has the TPU's semantics (the JAX package's
default backend there), edges included. The reference's second backend,
the lean fused path, is :mod:`~i3dr_stereo_tpu_torch.ops.fused_cost_sgm`
behind the matchers' one ``lean`` argument; it calls :func:`fold_paths`
here at the exact D, without the padding below:

- the volume is padded as the TPU pads it: H and W to multiples of 8
  with zero cost, then D to a multiple of 128 with the invalid cost (1e9
  for float32, the sentinel 255 for uint8). The padded lanes take part
  in the recurrence and set the exact 1e9-level values of S, which a
  parabolic subpixel next to an invalid disparity reads; the result is
  cropped back;
- one path direction per launch of the ``sgm_volume`` kernel
  (``csrc/sgm_volume.cu``), each folding its path costs into the running
  sum S in place (:func:`fold_paths`), in the TPU's order: the horizontal
  directions (0, 1) then (0, -1), then the top-down and the bottom-up
  family, each family in groups of equal penalties (split where the
  TPU's VMEM rule splits them), a group's total summed first in a
  float32 plane T. With ``out_dtype=torch.int16`` each group total is
  stored as the TPU stores it, ``trunc(min(total, 10000))``, and S is
  their int32 sum. No per-direction volume is held.

A CPU tensor runs the plain twin :func:`sgm_aggregate_plain`; a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from i3dr_stereo_tpu_torch import _build

BIG = 1.0e9
U8_SENTINEL = 255
CLAMP = 10000.0          # int16 mode: each stored group total is clamped
MAX_D = 512              # the kernel holds at most 16 disparities a lane

# (dy, dx) path directions, named from where the path COMES FROM.
DIRECTIONS_8: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, -1),          # W->E, E->W  (horizontal)
    (1, 0), (-1, 0),          # N->S, S->N  (vertical)
    (1, 1), (-1, -1),         # NW->SE, SE->NW
    (1, -1), (-1, 1),         # NE->SW, SW->NE
)
# the classic 4-path set (the engine's quick.param:144-147)
DIRECTIONS_4: Tuple[Tuple[int, int], ...] = ((0, 1), (0, -1), (1, 0), (-1, 0))
# cv::StereoSGBM MODE_SGBM single-pass set (5 directions)
DIRECTIONS_5: Tuple[Tuple[int, int], ...] = ((0, 1), (1, 0), (1, 1), (1, -1),
                                             (0, -1))

_HORIZ = ((0, 1), (0, -1))
_TOPDOWN = ((1, 0), (1, 1), (1, -1))
_BOTTOMUP = ((-1, 0), (-1, -1), (-1, 1))


def _vmem_ok_vertical(W: int, D: int, n_carries: int, itemsize: int) -> bool:
    """The TPU's rule for running a vertical group in one launch
    (``sgm_pallas._vmem_ok_vertical``): f32 carries plus double-buffered
    cost and int16 output rows under 10 MiB. It decides how the sum is
    grouped, so it shapes the float32 result."""
    return (n_carries * 4 + 2 * itemsize + 2 * 2) * W * D < 10 * 1024 * 1024


def _groups(directions, pen, W: int, D: int, itemsize: int):
    """The TPU's launches in order: [((p1, p2), [directions])], for the D
    it checks its VMEM rule with (the padded D in ``sgm_aggregate``, the
    exact D on the lean path)."""
    out = [(pen[d], [d]) for d in _HORIZ if d in directions]
    for family in (_TOPDOWN, _BOTTOMUP):
        by_pen: dict = {}
        for d in family:
            if d in directions:
                by_pen.setdefault(pen[d], []).append(d)
        for pp, ds in by_pen.items():
            if _vmem_ok_vertical(W, D, len(ds), itemsize):
                out.append((pp, ds))
            else:
                out.extend((pp, [d]) for d in ds)
    return out


def plan(C: torch.Tensor, p1, p2, directions,
         per_direction_penalties=None, out_dtype=None):
    """Batch, pad and group as the TPU does: (padded (B, H', W', D')
    volume, [((p1, p2), [directions])] in summation order, int16 mode,
    the (H, W, D) to crop back to)."""
    if C.ndim not in (3, 4) or C.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"C must be a float32 or uint8 (B, H, W, D) or "
                         f"(H, W, D) volume, got {tuple(C.shape)} {C.dtype}")
    if out_dtype not in (None, torch.float32, torch.int16):
        raise ValueError(f"out_dtype must be None, float32 or int16, got "
                         f"{out_dtype}")
    directions = tuple(tuple(d) for d in directions)
    Cb = C if C.ndim == 4 else C[None]
    B, H, W, D = Cb.shape
    padH, padW = -(-H // 8) * 8, -(-W // 8) * 8
    padD = -(-D // 128) * 128
    if (padH, padW) != (H, W):
        Cb = F.pad(Cb, (0, 0, 0, padW - W, 0, padH - H), value=0)
    if padD != D:
        invalid = U8_SENTINEL if Cb.dtype == torch.uint8 else BIG
        Cb = F.pad(Cb, (0, padD - D), value=invalid)
    if per_direction_penalties is None:
        pen = {d: (float(p1), float(p2)) for d in directions}
    else:
        pen = {d: (float(per_direction_penalties[i][0]),
                   float(per_direction_penalties[i][1]))
               for i, d in enumerate(directions)}
    groups = _groups(directions, pen, W, padD, Cb.element_size())
    if not groups:
        raise ValueError(f"no path directions in {directions}")
    return Cb.contiguous(), groups, out_dtype == torch.int16, (H, W, D)


# ---------------------------------------------------------------------------
# sgm_volume: one path direction, folded into the running sum
# ---------------------------------------------------------------------------

def _step(prev, c, p1: float, p2: float):
    """One SGM step over (..., D), the reference's float32 op order (the
    step of the flagship's ``sgm_fused_t``, which imports this module and
    so cannot be imported here)."""
    m = prev.amin(-1, keepdim=True)
    up = F.pad(prev[..., :-1], (1, 0), value=BIG)     # L(d-1)
    dn = F.pad(prev[..., 1:], (0, 1), value=BIG)      # L(d+1)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(up + p1, dn + p1))
    return (c + best) - m


def sgm_volume_path_plain(C: torch.Tensor, dy: int, dx: int, p1: float,
                          p2: float) -> torch.Tensor:
    """float32 path costs L of direction (dy, dx), unclamped, in plain
    torch: a Python loop over the scan axis, vectorised across the rest;
    diagonal paths shift the carry one column per row with a zero
    entering column."""
    c = (torch.where(C == U8_SENTINEL, BIG, C.to(torch.float32))
         if C.dtype == torch.uint8 else C)
    B, H, W, D = c.shape
    out = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    if dy == 0:
        prev = torch.zeros_like(c[:, :, 0])
        for x in (range(W) if dx > 0 else range(W - 1, -1, -1)):
            prev = _step(prev, c[:, :, x], p1, p2)
            out[:, :, x] = prev
        return out
    prev = torch.zeros_like(c[:, 0])
    for y in (range(H) if dy > 0 else range(H - 1, -1, -1)):
        if dx > 0:
            prev = F.pad(prev[:, :-1], (0, 0, 1, 0))
        elif dx < 0:
            prev = F.pad(prev[:, 1:], (0, 0, 0, 1))
        prev = _step(prev, c[:, y], p1, p2)
        out[:, y] = prev
    return out


def _check_planes(C, out, x, acc) -> None:
    if C.ndim != 4 or C.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"expected a float32 or uint8 (B, H, W, D) volume, "
                         f"got {tuple(C.shape)} {C.dtype}")
    if not 1 <= C.shape[-1] <= MAX_D:
        raise ValueError(f"sgm_volume takes 1 to {MAX_D} disparities, got "
                         f"{C.shape[-1]}")
    int_out = out.dtype == torch.int32
    accs = (torch.int32, torch.int16) if int_out else (torch.float32,)
    if out.dtype not in (torch.float32, torch.int32) \
            or (x is not None and x.dtype != torch.float32) \
            or (acc is not None and acc.dtype not in accs) \
            or (acc is not None and acc.dtype == torch.int16
                and C.dtype != torch.uint8) \
            or any(t is not None and t.shape != C.shape
                   for t in (out, x, acc)):
        raise ValueError(
            f"sgm_volume writes a float32 or int32 plane of the volume's "
            f"shape from a float32 x and a float32 (float32 out) or int32 / "
            f"int16 (int32 out, int16 with uint8 costs) acc, got out "
            f"{out.dtype}, x {None if x is None else x.dtype}, acc "
            f"{None if acc is None else acc.dtype}")


def sgm_volume_step_plain(C: torch.Tensor, dy: int, dx: int, p1: float,
                          p2: float, out: torch.Tensor, x=None,
                          acc=None) -> None:
    """Plain twin of one ``sgm_volume`` launch (see
    :func:`sgm_volume_step`), with torch arithmetic on any device."""
    v = sgm_volume_path_plain(C, dy, dx, p1, p2)
    if x is not None:
        v = x + v
    if out.dtype == torch.int32:
        v = torch.clamp(v, max=CLAMP).to(torch.int32)
        if acc is not None:
            v = acc.to(torch.int32) + v
    elif acc is not None:
        v = acc + v
    out.copy_(v)


def sgm_volume_step(C: torch.Tensor, dy: int, dx: int, p1: float, p2: float,
                    out: torch.Tensor, x=None, acc=None) -> None:
    """One path direction (dy, dx) (the path comes from (y-dy, x-dx)) of
    a (B, H, W, D) volume at exactly its D (at most 512), float32
    (invalid = 1e9) or uint8 (255 = invalid), folded into ``out``:

        v = L, or x + L                       (x: float32)
        v = v, or int(min(v, 10000))          (int32 out)
        out = v, or acc + v                   (acc: float32, int32, int16)

    with the float32 path costs L unclamped. ``x`` and ``acc`` may be
    ``out`` itself (in place). A CPU tensor takes the plain version; a
    CUDA tensor launches the ``sgm_volume`` kernel (or raises)."""
    if C.device.type == "cpu":
        return sgm_volume_step_plain(C, dy, dx, p1, p2, out, x, acc)
    _check_planes(C, out, x, acc)
    _build.require_cuda(C, out, *(t for t in (x, acc) if t is not None))
    B, H, W, D = C.shape
    acc_kind = (0 if acc is None else
                {torch.float32: 1, torch.int32: 2, torch.int16: 3}[acc.dtype])
    _build.launch("i3dr_sgm_volume", "sgm_volume", C.device,
                  C.data_ptr(), int(C.dtype == torch.uint8), out.data_ptr(),
                  int(out.dtype == torch.int32),
                  None if x is None else x.data_ptr(),
                  None if acc is None else acc.data_ptr(), acc_kind,
                  B, H, W, D, int(dy), int(dx), float(p1), float(p2),
                  _build.stream_of(C))


def sgm_volume_sum_plain(parts, group_sizes, int16_mode: bool):
    """The sum of per-direction float32 partials in the TPU's order,
    ``group_sizes`` consecutive partials per group: each group's total in
    order, then the totals in order (float32), or in int16 mode the int32
    sum of ``trunc(min(total, 10000))``. The reference that
    :func:`fold_paths` is held against."""
    S = None
    k = 0
    for n in group_sizes:
        t = parts[k]
        for p in parts[k + 1:k + n]:
            t = t + p
        k += n
        if int16_mode:
            t = torch.clamp(t, max=CLAMP).to(torch.int32)
        S = t if S is None else S + t
    return S


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def fold_paths(C: torch.Tensor, groups, int16_mode: bool,
               step=sgm_volume_step, S=None) -> torch.Tensor:
    """Run the directions of ``groups`` ([((p1, p2), [directions])], the
    TPU's launches in order) over the (B, H, W, D) volume ``C``, each
    folded into the running sum in place: a group of one adds to S, a
    larger group sums its directions in a float32 plane T first and adds
    the total with its last direction. ``S`` is the sum so far (the lean
    path's forward pass: float32, or int16 in int16 mode), or None.
    Returns S: float32, or int32 in int16 mode. ``step`` is
    :func:`sgm_volume_step` or its plain twin."""
    out_dtype = torch.int32 if int16_mode else torch.float32
    out = S if S is not None and S.dtype == out_dtype else torch.empty(
        C.shape, dtype=out_dtype, device=C.device)
    T = (torch.empty(C.shape, dtype=torch.float32, device=C.device)
         if any(len(ds) > 1 for _, ds in groups) else None)
    acc = S
    for (p1, p2), ds in groups:
        for i, (dy, dx) in enumerate(ds):
            if i < len(ds) - 1:
                step(C, dy, dx, p1, p2, T, x=T if i else None)
            else:
                step(C, dy, dx, p1, p2, out, x=T if len(ds) > 1 else None,
                     acc=acc)
                acc = out
    return acc if acc is out else acc.to(out_dtype)


def _aggregate(C, p1, p2, directions, per_direction_penalties, out_dtype,
               step):
    Cb, groups, int16_mode, (H, W, D) = plan(
        C, p1, p2, directions, per_direction_penalties, out_dtype)
    S = fold_paths(Cb, groups, int16_mode, step)[:, :H, :W, :D]
    return S if C.ndim == 4 else S[0]


def sgm_aggregate(C: torch.Tensor, p1=10.0, p2=120.0,
                  directions: Sequence[Tuple[int, int]] = DIRECTIONS_8,
                  per_direction_penalties=None,
                  out_dtype=None) -> torch.Tensor:
    """Sum of the SGM path costs L_r over ``directions``.

    C: (B, H, W, D) or (H, W, D) cost volume, float32 (invalid = 1e9) or
    uint8 (255 = invalid). ``per_direction_penalties`` gives (P1, P2) per
    direction in ``directions`` order; P1/P2 are runtime values.
    Returns float32 S, or with ``out_dtype=torch.int16`` the int32 sum of
    the int16-stored group totals. A CPU tensor runs the plain twins; a
    CUDA tensor launches the ``sgm_volume`` kernels (or raises)."""
    return _aggregate(C, p1, p2, directions, per_direction_penalties,
                      out_dtype, sgm_volume_step)


def sgm_aggregate_plain(C: torch.Tensor, p1=10.0, p2=120.0,
                        directions: Sequence[Tuple[int, int]] = DIRECTIONS_8,
                        per_direction_penalties=None,
                        out_dtype=None) -> torch.Tensor:
    """:func:`sgm_aggregate` through the plain twins, on any device."""
    return _aggregate(C, p1, p2, directions, per_direction_penalties,
                      out_dtype, sgm_volume_step_plain)
