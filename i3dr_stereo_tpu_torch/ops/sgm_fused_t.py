"""Census cost -> 4/8-path SGM -> winner-take-all: the flagship matcher
core (torch port of ``i3dr_stereo_tpu.ops.sgm_fused_t``).

The TPU runs this as four Pallas kernels on a transposed layout
(disparity on sublanes, image rows on lanes, a reversed right plane).
The port uses the layout of the work — (B, H, W, D) with D = 32
contiguous, one warp per pixel or scanline and one lane per disparity —
and three CUDA kernels (``csrc/``):

- ``census_cost``: the uint8 residual-window hamming cost volume C
  (cost half of the TPU's ``_fwd_kernel``);
- ``sgm_path``: one path direction per launch (the sweeps of
  ``_fwd_kernel``, ``_rev_kernel``, ``_vdown_kernel``,
  ``_vup_wta_kernel``), each writing its clamped float32 path costs;
- ``sum_wta``: the direction sum with the TPU's int16 truncation points
  rebuilt exactly, then the WTA (WTA half of ``_vup_wta_kernel``).

Each kernel has a plain torch twin here (``*_plain``). The public
wrapper takes the twin for a CPU tensor and the kernel for a CUDA tensor
(or raises) — nothing falls back. :func:`census_sgm_wta` chains the
three; its ``plain=True`` runs the twins on any device (the reference
run of ``chip_smoke.py``).

Semantics equal ``census_sgm_wta_t`` bit for bit (tests hold them to it)
for every census window the config allows. C holds min(ham, 254); with
more than 254 census bits (17x17) the TPU's forward-horizontal sweep
recurs on the unclamped distance, so ``census_cost`` then also returns an
int16 unclamped plane and the (0, 1) path reads it. At 9x9 nothing extra
is allocated or launched.
"""

from __future__ import annotations

import ctypes

import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.ops.sgm import DIRECTIONS_4, DIRECTIONS_8

BIG = 1.0e9
CLAMP = 10000.0          # per-direction partial-sum clamp
U8_SENTINEL = 255
U8_CLAMP = 254           # C holds min(hamming, 254)
NODATA = -1.0e9          # invalid-pixel marker of the WTA output
WARP_D = 32              # the warp kernels put one disparity on each lane

_DOWN = ((1, 0), (1, 1), (1, -1))
_UP = ((-1, 0), (-1, -1), (-1, 1))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _require_warp_d(D: int) -> None:
    if D != WARP_D:
        raise ValueError(f"the SGM kernels hold one disparity per lane: D "
                         f"must be {WARP_D}, got {D}")


# ---------------------------------------------------------------------------
# census_cost
# ---------------------------------------------------------------------------

def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2**32) (SWAR; torch has none)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _check_words(cl, cr):
    if cl.ndim != 4 or cl.shape != cr.shape or cl.dtype != torch.int32 \
            or cr.dtype != torch.int32:
        raise ValueError("census words must be two int32 (B, H, W, NW) "
                         f"tensors, got {tuple(cl.shape)} {cl.dtype} / "
                         f"{tuple(cr.shape)} {cr.dtype}")


def _needs_wide(NW: int) -> bool:
    """Whether NW census words can hold a distance above the clamp."""
    return NW * 32 > U8_CLAMP


def census_cost_plain(cl: torch.Tensor, cr: torch.Tensor, D: int, *,
                      bpm: int, H_real: int, W_real: int):
    """Plain torch twin of the ``census_cost`` kernel."""
    _check_words(cl, cr)
    B, H, W, NW = cl.shape
    xs = torch.arange(W, device=cl.device)
    C = torch.empty((B, H, W, D), dtype=torch.uint8, device=cl.device)
    Cw = (torch.empty((B, H, W, D), dtype=torch.int16, device=cl.device)
          if _needs_wide(NW) else None)
    for d in range(D):
        src = xs - bpm - d
        ok = (src >= 0) & (src < W_real)
        x = cl ^ cr[:, :, src.clamp(0, W - 1), :]
        ham = _popcount32(x.to(torch.int64) & 0xFFFFFFFF).sum(-1)
        C[..., d] = torch.where(ok, ham.clamp(max=U8_CLAMP),
                                U8_SENTINEL).to(torch.uint8)
        if Cw is not None:
            Cw[..., d] = torch.where(ok, ham, -1).to(torch.int16)
    for plane in (C, Cw):
        if plane is not None:
            plane[:, H_real:] = 0
            plane[:, :, W_real:] = 0
    return C, Cw


def census_cost(cl: torch.Tensor, cr: torch.Tensor, D: int, *, bpm: int,
                H_real: int, W_real: int):
    """(C, Cw): the uint8 (B, H, W, D) cost volume over the residual
    window and, only when the words hold more than 254 bits, its int16
    unclamped twin (else None).

    C[b, y, x, d] = min(hamming(cl[b,y,x], cr[b,y,x-bpm-d]), 254); 255
    where the source column is outside [0, W_real); 0 on pad rows
    (y >= H_real) and pad columns (x >= W_real), which makes a path cross
    the padding with a zero carry. Cw holds the unclamped distance, -1
    for an invalid source column and 0 on the padding."""
    if cl.device.type == "cpu":
        return census_cost_plain(cl, cr, D, bpm=bpm, H_real=H_real,
                                 W_real=W_real)
    _check_words(cl, cr)
    _build.require_cuda(cl, cr)
    B, H, W, NW = cl.shape
    C = torch.empty((B, H, W, D), dtype=torch.uint8, device=cl.device)
    Cw = (torch.empty((B, H, W, D), dtype=torch.int16, device=cl.device)
          if _needs_wide(NW) else None)
    _build.launch("i3dr_census_cost", "census_cost", cl.device,
                  cl.data_ptr(), cr.data_ptr(), C.data_ptr(),
                  None if Cw is None else Cw.data_ptr(), B, H, W, NW, D,
                  int(bpm), int(H_real), int(W_real), _build.stream_of(cl))
    return C, Cw


# ---------------------------------------------------------------------------
# sgm_path
# ---------------------------------------------------------------------------

def _check_cost(C, wide_ok=False):
    if C.ndim != 4 or not (C.dtype == torch.uint8
                           or wide_ok and C.dtype == torch.int16):
        raise ValueError(f"C must be uint8 (B, H, W, D)"
                         f"{' or int16' if wide_ok else ''}, got "
                         f"{tuple(C.shape)} {C.dtype}")


def _step(prev, c, p1, p2):
    """One SGM step over (..., D), the reference's float32 op order."""
    m = prev.min(-1, keepdim=True).values
    big = torch.full_like(prev[..., :1], BIG)
    up = torch.cat([big, prev[..., :-1]], -1)     # L(d-1)
    dn = torch.cat([prev[..., 1:], big], -1)      # L(d+1)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(up + p1, dn + p1))
    return (c + best) - m


def sgm_path_plain(C: torch.Tensor, dy: int, dx: int, p1,
                   p2) -> torch.Tensor:
    """Plain torch twin of the ``sgm_path`` kernel: a Python loop over
    the scan axis, vectorised across the perpendicular extent. Diagonal
    paths shift the carry one column per row with a zero entering
    column (the TPU's ``_shift_carry``)."""
    _check_cost(C, wide_ok=True)
    B, H, W, D = C.shape
    p1, p2 = _f32(p1, C.device), _f32(p2, C.device)
    bad = C == U8_SENTINEL if C.dtype == torch.uint8 else C < 0
    c = torch.where(bad, BIG, C.to(torch.float32))
    out = torch.empty(C.shape, dtype=torch.float32, device=C.device)
    if dy == 0:
        prev = torch.zeros((B, H, D), dtype=torch.float32, device=C.device)
        for x in (range(W) if dx > 0 else range(W - 1, -1, -1)):
            prev = _step(prev, c[:, :, x], p1, p2)
            out[:, :, x] = prev.clamp(max=CLAMP)
        return out
    prev = torch.zeros((B, W, D), dtype=torch.float32, device=C.device)
    for y in (range(H) if dy > 0 else range(H - 1, -1, -1)):
        if dx > 0:
            prev = torch.cat([torch.zeros_like(prev[:, :1]), prev[:, :-1]], 1)
        elif dx < 0:
            prev = torch.cat([prev[:, 1:], torch.zeros_like(prev[:, :1])], 1)
        prev = _step(prev, c[:, y], p1, p2)
        out[:, y] = prev.clamp(max=CLAMP)
    return out


def sgm_path(C: torch.Tensor, dy: int, dx: int, p1, p2) -> torch.Tensor:
    """Path costs of direction (dy, dx) (the path comes from (y-dy,
    x-dx)): float32 (B, H, W, D) ``min(L, 10000)``. ``C`` is the uint8
    volume (255 = invalid) or census_cost's int16 unclamped plane
    (negative = invalid). P1/P2 are runtime scalars. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (or raises)."""
    if C.device.type == "cpu":
        return sgm_path_plain(C, dy, dx, p1, p2)
    _check_cost(C, wide_ok=True)
    _build.require_cuda(C)
    B, H, W, D = C.shape
    _require_warp_d(D)
    out = torch.empty(C.shape, dtype=torch.float32, device=C.device)
    _build.launch("i3dr_sgm_path", "sgm_path", C.device,
                  C.data_ptr(), int(C.dtype == torch.int16), out.data_ptr(),
                  B, H, W, int(dy), int(dx), float(p1), float(p2),
                  _build.stream_of(C))
    return out


# ---------------------------------------------------------------------------
# sum_wta
# ---------------------------------------------------------------------------

def _check_parts(C, parts, n_down, n_up):
    _check_cost(C)
    if n_down < 1 or n_up < 1 or len(parts) != 2 + n_down + n_up:
        raise ValueError(f"expected fwd, rev, {n_down} down and {n_up} up "
                         f"path outputs, got {len(parts)}")
    for p in parts:
        if p.shape != C.shape or p.dtype != torch.float32:
            raise ValueError("path outputs must be float32 shaped like C")


def sum_wta_plain(C: torch.Tensor, parts, n_down: int, n_up: int, *,
                  subpixel: bool, uniqueness_ratio=0.0) -> torch.Tensor:
    """Plain torch twin of the ``sum_wta`` kernel."""
    _check_parts(C, parts, n_down, n_up)
    D = C.shape[-1]
    dev = C.device
    s_fwd = parts[0].to(torch.int32)
    s_h = (parts[1] + s_fwd.to(torch.float32)).to(torch.int32)
    down = parts[2]
    for k in range(1, n_down):
        down = down + parts[2 + k]
    S = (s_h + down.to(torch.int32)).to(torch.float32)
    for k in range(n_up):
        S = S + parts[2 + n_down + k]

    iota = torch.arange(D, dtype=torch.int32, device=dev)
    m = S.min(-1, keepdim=True).values
    db = torch.where(S == m, iota, D).min(-1, keepdim=True).values
    cmin = C.min(-1, keepdim=True).values
    valid = (m < 9999.0) & (cmin < U8_SENTINEL)
    ur = _f32(uniqueness_ratio, dev)
    far = (iota - db).abs() > 1
    min_far = torch.where(far, S, BIG).min(-1, keepdim=True).values
    valid = valid & ((ur <= 0.0) | (min_far * (100.0 - ur) >= m * 100.0))
    disp = db.to(torch.float32)
    if subpixel:
        Sm = S.gather(-1, (db - 1).clamp(min=0).long())
        Sp = S.gather(-1, (db + 1).clamp(max=D - 1).long())
        denom = (Sm + Sp) - 2.0 * m
        off = torch.where(denom > 1e-9, (Sm - Sp) / (2.0 * denom), 0.0)
        off = off.clamp(-0.5, 0.5)
        interior = (db > 0) & (db < D - 1)
        disp = disp + torch.where(interior, off, 0.0)
    return torch.where(valid, disp, NODATA)[..., 0]


def sum_wta(C: torch.Tensor, parts, n_down: int, n_up: int, *,
            subpixel: bool, uniqueness_ratio=0.0) -> torch.Tensor:
    """Direction sum + WTA -> float32 (B, H, W) residual disparity,
    NODATA (-1e9) where invalid.

    ``parts``: the ``sgm_path`` outputs in the order fwd (0, 1), rev
    (0, -1), the down directions, the up directions. The sum rebuilds
    the TPU's int16 stores: S_fwd = int(fwd), S_h = int(rev + S_fwd),
    S_down = int(sum of downs), S = float(S_h + S_down) + each up. The
    argmin takes the first minimum; a pixel is valid iff m < 9999, some
    cost is below the sentinel and (uniqueness_ratio > 0 only) the best
    cost beyond |d - db| > 1 clears the margin. Parabolic subpixel on
    interior disparities, clipped to +-0.5. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if C.device.type == "cpu":
        return sum_wta_plain(C, parts, n_down, n_up, subpixel=subpixel,
                             uniqueness_ratio=uniqueness_ratio)
    _check_parts(C, parts, n_down, n_up)
    _build.require_cuda(C, *parts)
    B, H, W, D = C.shape
    _require_warp_d(D)
    disp = torch.empty((B, H, W), dtype=torch.float32, device=C.device)
    ptrs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    _build.launch("i3dr_sum_wta", "sum_wta", C.device,
                  C.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), n_down,
                  n_up, disp.data_ptr(), B * H * W, int(bool(subpixel)),
                  float(uniqueness_ratio), _build.stream_of(C))
    return disp


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def census_sgm_wta(cl: torch.Tensor, cr: torch.Tensor, D: int, *, bpm: int,
                   W_real: int, H_real: int, pens, directions: int = 4,
                   subpixel: bool = True, uniqueness_ratio=0.0,
                   plain: bool = False):
    """Census cost + 4/8-path SGM + WTA on (B, H, W, NW) census words.

    ``pens``: per-direction (P1, P2) in DIRECTIONS_4/8 order.
    Returns ((B, H, W) residual disparity with NODATA at invalid pixels,
    C (B, H, W, D) uint8). Absolute disparity = bpm + value. ``plain``
    runs the plain twins of the kernels on whatever device the words are.
    """
    dirs = DIRECTIONS_4 if directions == 4 else DIRECTIONS_8
    pen = {d: (pens[i][0], pens[i][1]) for i, d in enumerate(dirs)}
    cost, path, wta = ((census_cost_plain, sgm_path_plain, sum_wta_plain)
                       if plain else (census_cost, sgm_path, sum_wta))

    C, Cw = cost(cl, cr, D, bpm=bpm, H_real=H_real, W_real=W_real)
    down = [d for d in _DOWN if d in dirs]
    up = [d for d in _UP if d in dirs]
    order = [(0, 1), (0, -1)] + down + up
    # the forward sweep recurs on the unclamped distance where one exists
    parts = [path(Cw if (dy, dx) == (0, 1) and Cw is not None else C,
                  dy, dx, *pen[(dy, dx)]) for dy, dx in order]
    disp = wta(C, parts, len(down), len(up), subpixel=subpixel,
               uniqueness_ratio=uniqueness_ratio)
    return disp, C


def right_disparity_from_C(C: torch.Tensor, bpm: int, W_real: int):
    """True backmatching: the right-anchored WTA from the same cost
    volume (plain torch on every device, as it is XLA code in JAX).

    C: (B, H, W, D) uint8, C[b, y, x, k] pairing left column x with right
    column x - (bpm + k). The right-anchored volume is the x-shifted
    reindex C_R[b, y, xr, k] = C[b, y, xr + bpm + k, k]; its first
    minimum over k gives the right disparity. Left columns x >= W_real
    are zero-cost padding and must not compete. Returns (d_r float32,
    valid_r bool), both (B, H, W), d_r = bpm + k.
    """
    B, H, W, D = C.shape
    xs = torch.arange(W, dtype=torch.int32, device=C.device)
    best = torch.full((B, H, W), 255 << 8, dtype=torch.int32, device=C.device)
    for k in range(D):
        s = bpm + k
        plane = torch.full((B, H, W), 255, dtype=torch.int32, device=C.device)
        lo, hi = max(0, -s), min(W, W - s)
        if lo < hi:
            plane[:, :, lo:hi] = C[:, :, lo + s:hi + s, k].to(torch.int32)
        plane = torch.where(xs + s >= W_real, 255, plane)
        # lexicographic (cost, k): ties resolve to the smallest k
        best = torch.minimum(best, (plane << 8) | k)
    cost = best >> 8
    bestk = torch.where(cost < 255, best & 255, 0)
    in_img = (xs + bpm + bestk >= 0) & (xs + bpm + bestk < W_real)
    valid_r = (cost < 255) & in_img
    return (bpm + bestk).to(torch.float32), valid_r
