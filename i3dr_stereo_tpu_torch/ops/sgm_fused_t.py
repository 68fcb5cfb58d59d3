"""Census cost -> 4/8-path SGM -> winner-take-all: the flagship matcher
core (torch port of ``i3dr_stereo_tpu.ops.sgm_fused_t``).

The TPU runs this as four Pallas kernels on a transposed layout
(disparity on sublanes, image rows on lanes, a reversed right plane)
that hand an int16 running sum from sweep to sweep and do the WTA inside
the last one. The port keeps that chain and uses the layout of the work
— (B, H, W, D) with D = 32 contiguous — in three CUDA kernels
(``csrc/``):

- ``census_cost``: the uint8 residual-window hamming cost volume C
  (cost half of the TPU's ``_fwd_kernel``);
- ``sgm_sweep``: one path direction per launch, folded into the running
  sum of the directions (the sweeps and stores of ``_fwd_kernel``,
  ``_rev_kernel`` and ``_vdown_kernel``). No per-direction volume is
  written;
- ``sgm_sweep_wta``: the last direction, added to the running sum in
  registers, and the WTA on it (``_vup_wta_kernel``): the summed volume
  never reaches memory.

The running sum is **updated in place** (the JAX side is pure and returns
a new array per kernel): a sweep reads and writes each element once, at
its own step, so ``acc16`` / ``acc32`` are overwritten and returned.

Each kernel has a plain torch twin here (``*_plain``). The public
wrapper takes the twin for a CPU tensor and the kernel for a CUDA tensor
(or raises) — nothing falls back. :func:`census_sgm_wta` chains them;
its ``plain=True`` runs the twins on any device (the reference run of
``chip_smoke.py``). ``sgm_path_plain`` and ``sum_wta_plain`` are what
the sweep twins are built from: one direction's clamped path costs as a
float32 volume, and the sum of such volumes with the TPU's truncation
points followed by the WTA.

Semantics equal ``census_sgm_wta_t`` bit for bit (tests hold them to it)
for every census window the config allows. C holds min(ham, 254); with
more than 254 census bits (17x17) the TPU's forward-horizontal sweep
recurs on the unclamped distance, so ``census_cost`` then also returns an
int16 unclamped plane and the (0, 1) sweep reads it. At 9x9 nothing extra
is allocated or launched.
"""

from __future__ import annotations

import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.ops.sgm import DIRECTIONS_4, DIRECTIONS_8

BIG = 1.0e9
CLAMP = 10000.0          # per-direction partial-sum clamp
U8_SENTINEL = 255
U8_CLAMP = 254           # C holds min(hamming, 254)
NODATA = -1.0e9          # invalid-pixel marker of the WTA output
WARP_D = 32              # the warp kernels put one disparity on each lane
MAX_COST_D = 4096        # census_cost: 256 threads a block, 16 disparities each

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
    if not 1 <= D <= MAX_COST_D:
        raise ValueError(f"the census_cost kernel takes D from 1 to "
                         f"{MAX_COST_D}, got {D}")
    C = torch.empty((B, H, W, D), dtype=torch.uint8, device=cl.device)
    Cw = (torch.empty((B, H, W, D), dtype=torch.int16, device=cl.device)
          if _needs_wide(NW) else None)
    _build.launch("i3dr_census_cost", "census_cost", cl.device,
                  cl.data_ptr(), cr.data_ptr(), C.data_ptr(),
                  None if Cw is None else Cw.data_ptr(), B, H, W, NW, D,
                  int(bpm), int(H_real), int(W_real), _build.stream_of(cl))
    return C, Cw


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

# what a sweep does with t = min(L, 10000) of its direction (the numbers
# are csrc/sgm_sweep.cuh's SweepOp)
SWEEP_OPS = {
    "i16_new": 0,    # returns a new int16 sum: int(t)
    "i16_addf": 1,   # acc16 = int(t + float(acc16))
    "i16_addi": 2,   # acc16 = acc16 + int(t)
    "f32_new": 3,    # returns a new float32 sum: t
    "f32_add": 4,    # acc32 = acc32 + t
    "f32_fin": 5,    # acc32 = float(acc16 + int(acc32 + t))
}
_READS_16 = ("i16_addf", "i16_addi", "f32_fin")
_READS_32 = ("f32_add", "f32_fin")


def _check_cost(C, wide_ok=False):
    if C.ndim != 4 or not (C.dtype == torch.uint8
                           or wide_ok and C.dtype == torch.int16):
        raise ValueError(f"C must be uint8 (B, H, W, D)"
                         f"{' or int16' if wide_ok else ''}, got "
                         f"{tuple(C.shape)} {C.dtype}")


def _check_sweep(C, op, acc16, acc32):
    if op not in SWEEP_OPS:
        raise ValueError(f"op must be one of {tuple(SWEEP_OPS)}, got {op!r}")
    _check_cost(C, wide_ok=(op == "i16_new"))
    for acc, dtype, users in ((acc16, torch.int16, _READS_16),
                              (acc32, torch.float32, _READS_32)):
        if (acc is not None) != (op in users):
            raise ValueError(f"op {op!r} takes "
                             f"{'an' if op in users else 'no'} "
                             f"{str(dtype)[6:]} running sum")
        if acc is not None and (acc.shape != C.shape or acc.dtype != dtype):
            raise ValueError(f"the running sum must be {str(dtype)[6:]} "
                             f"shaped like C, got {tuple(acc.shape)} "
                             f"{acc.dtype}")


def _check_acc(C, acc):
    _check_cost(C)
    if acc.shape != C.shape or acc.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"the running sum must be int16 or float32 shaped "
                         f"like C, got {tuple(acc.shape)} {acc.dtype}")


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
    """Path costs of direction (dy, dx) (the path comes from (y-dy,
    x-dx)) as a float32 (B, H, W, D) volume ``min(L, 10000)``, in plain
    torch: a Python loop over the scan axis, vectorised across the
    perpendicular extent. ``C`` is the uint8 volume (255 = invalid) or
    census_cost's int16 unclamped plane (negative = invalid). Diagonal
    paths shift the carry one column per row with a zero entering column
    (the TPU's ``_shift_carry``)."""
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


def sgm_sweep_plain(C: torch.Tensor, dy: int, dx: int, p1, p2, op: str,
                    acc16: torch.Tensor | None = None,
                    acc32: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch twin of the ``sgm_sweep`` kernel (in place, as it)."""
    _check_sweep(C, op, acc16, acc32)
    t = sgm_path_plain(C, dy, dx, p1, p2)
    if op == "i16_new":
        return t.to(torch.int32).to(torch.int16)
    if op == "f32_new":
        return t
    if op == "f32_add":
        return acc32.add_(t)
    if op == "f32_fin":
        return acc32.copy_(acc16.to(torch.int32)
                           + (acc32 + t).to(torch.int32))
    if op == "i16_addf":
        new = (t + acc16.to(torch.float32)).to(torch.int32)
    else:
        new = acc16.to(torch.int32) + t.to(torch.int32)
    return acc16.copy_(new)


def sgm_sweep(C: torch.Tensor, dy: int, dx: int, p1, p2, op: str,
              acc16: torch.Tensor | None = None,
              acc32: torch.Tensor | None = None) -> torch.Tensor:
    """One path direction (dy, dx) folded into the running sum of the
    directions; returns the sum it wrote.

    With L the path costs of the direction (zero carry where a path
    enters; P1/P2 runtime scalars) and t = min(L, 10000), ``op`` is one of
    :data:`SWEEP_OPS`: ``i16_new`` / ``f32_new`` return a new (B, H, W, D)
    sum; the others **overwrite** the running sum they are given
    (``acc16`` int16, ``acc32`` float32) and return it. ``int`` truncates,
    as the TPU's int16 stores do. ``C`` is the uint8 volume (255 =
    invalid) or, for ``i16_new`` only, census_cost's int16 unclamped plane
    (negative = invalid). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    if C.device.type == "cpu":
        return sgm_sweep_plain(C, dy, dx, p1, p2, op, acc16, acc32)
    _check_sweep(C, op, acc16, acc32)
    _build.require_cuda(C, *(a for a in (acc16, acc32) if a is not None))
    B, H, W, D = C.shape
    _require_warp_d(D)
    if op == "i16_new":
        acc16 = torch.empty(C.shape, dtype=torch.int16, device=C.device)
    elif op == "f32_new":
        acc32 = torch.empty(C.shape, dtype=torch.float32, device=C.device)
    _build.launch("i3dr_sgm_sweep", "sgm_sweep", C.device,
                  C.data_ptr(), int(C.dtype == torch.int16), SWEEP_OPS[op],
                  None if acc16 is None else acc16.data_ptr(),
                  None if acc32 is None else acc32.data_ptr(),
                  B, H, W, int(dy), int(dx), float(p1), float(p2),
                  _build.stream_of(C))
    return acc16 if op.startswith("i16") else acc32


# ---------------------------------------------------------------------------
# the WTA, and the sweep that ends in it
# ---------------------------------------------------------------------------

def _wta_plain(C: torch.Tensor, S: torch.Tensor, subpixel: bool,
               uniqueness_ratio) -> torch.Tensor:
    """WTA of the float32 sums S -> (B, H, W) disparity, NODATA where
    invalid."""
    D = C.shape[-1]
    dev = C.device
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


def sum_wta_plain(C: torch.Tensor, parts, n_down: int, n_up: int, *,
                  subpixel: bool, uniqueness_ratio=0.0) -> torch.Tensor:
    """The whole direction sum and WTA from per-direction volumes, in
    plain torch: what the chain of sweeps computes, written the long way.

    ``parts``: ``sgm_path_plain`` outputs in the order fwd (0, 1), rev
    (0, -1), the down directions, the up directions. The sum has the
    TPU's int16 stores: S_fwd = int(fwd), S_h = int(rev + S_fwd),
    S_down = int(sum of downs), S = float(S_h + S_down) + each up."""
    _check_cost(C)
    if n_down < 1 or n_up < 1 or len(parts) != 2 + n_down + n_up:
        raise ValueError(f"expected fwd, rev, {n_down} down and {n_up} up "
                         f"path outputs, got {len(parts)}")
    for p in parts:
        if p.shape != C.shape or p.dtype != torch.float32:
            raise ValueError("path outputs must be float32 shaped like C")
    s_fwd = parts[0].to(torch.int32)
    s_h = (parts[1] + s_fwd.to(torch.float32)).to(torch.int32)
    down = parts[2]
    for k in range(1, n_down):
        down = down + parts[2 + k]
    S = (s_h + down.to(torch.int32)).to(torch.float32)
    for k in range(n_up):
        S = S + parts[2 + n_down + k]
    return _wta_plain(C, S, subpixel, uniqueness_ratio)


def sgm_sweep_wta_plain(C: torch.Tensor, dy: int, dx: int, p1, p2,
                        acc: torch.Tensor, *, subpixel: bool,
                        uniqueness_ratio=0.0) -> torch.Tensor:
    """Plain torch twin of the ``sgm_sweep_wta`` kernel."""
    _check_acc(C, acc)
    S = acc.to(torch.float32) + sgm_path_plain(C, dy, dx, p1, p2)
    return _wta_plain(C, S, subpixel, uniqueness_ratio)


def sgm_sweep_wta(C: torch.Tensor, dy: int, dx: int, p1, p2,
                  acc: torch.Tensor, *, subpixel: bool,
                  uniqueness_ratio=0.0) -> torch.Tensor:
    """The last direction and the WTA: S = float(acc) + min(L, 10000) of
    direction (dy, dx), then per pixel the float32 (B, H, W) residual
    disparity, NODATA (-1e9) where invalid. ``acc`` is the running sum of
    the other directions, int16 (4 paths) or float32 (8 paths); it is
    only read.

    The argmin takes the first minimum; a pixel is valid iff m < 9999,
    some cost is below the sentinel and (uniqueness_ratio > 0 only) the
    best sum beyond |d - db| > 1 clears the margin. Parabolic subpixel on
    interior disparities, clipped to +-0.5. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if C.device.type == "cpu":
        return sgm_sweep_wta_plain(C, dy, dx, p1, p2, acc, subpixel=subpixel,
                                   uniqueness_ratio=uniqueness_ratio)
    _check_acc(C, acc)
    _build.require_cuda(C, acc)
    B, H, W, D = C.shape
    _require_warp_d(D)
    disp = torch.empty((B, H, W), dtype=torch.float32, device=C.device)
    _build.launch("i3dr_sgm_sweep_wta", "sgm_sweep_wta", C.device,
                  C.data_ptr(), acc.data_ptr(),
                  int(acc.dtype == torch.float32), disp.data_ptr(), B, H, W,
                  int(dy), int(dx), float(p1), float(p2), int(bool(subpixel)),
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
    cost, sweep, wta = (
        (census_cost_plain, sgm_sweep_plain, sgm_sweep_wta_plain) if plain
        else (census_cost, sgm_sweep, sgm_sweep_wta))

    C, Cw = cost(cl, cr, D, bpm=bpm, H_real=H_real, W_real=W_real)
    down = [d for d in _DOWN if d in dirs]
    up = [d for d in _UP if d in dirs]
    # the forward sweep recurs on the unclamped distance where one exists
    acc = sweep(C if Cw is None else Cw, 0, 1, *pen[(0, 1)], "i16_new")
    sweep(C, 0, -1, *pen[(0, -1)], "i16_addf", acc)
    if len(down) == 1:
        sweep(C, *down[0], *pen[down[0]], "i16_addi", acc)
    else:
        # several directions a group: summed in float32, truncated once
        acc32 = sweep(C, *down[0], *pen[down[0]], "f32_new")
        for d in down[1:-1]:
            sweep(C, *d, *pen[d], "f32_add", acc32=acc32)
        sweep(C, *down[-1], *pen[down[-1]], "f32_fin", acc, acc32)
        for d in up[:-1]:
            sweep(C, *d, *pen[d], "f32_add", acc32=acc32)
        acc = acc32
    disp = wta(C, *up[-1], *pen[up[-1]], acc, subpixel=subpixel,
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
