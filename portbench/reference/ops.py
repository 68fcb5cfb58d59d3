"""Plain torch operations of the matchers, frozen copies of the port's
plain twins (``ops/census.py``, ``ops/sgm_fused_t.py``, ``ops/sgm.py``,
``ops/cost.py``, ``ops/shift.py``, ``ops/block_gather.py``,
``ops/speckle.py``, ``ops/median.py``, ``ops/lr_check.py``,
``ops/wta.py``, ``ops/resize.py``), on whatever device the tensors are.
Only the branches the configurations of this benchmark take are kept."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1.0e9
CLAMP = 10000.0
U8_SENTINEL = 255
U8_CLAMP = 254
NODATA = -1.0e9
LANE, ROWS = 128, 8

DIRECTIONS_8 = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1),
                (-1, 1))
DIRECTIONS_4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
_DOWN = ((1, 0), (1, 1), (1, -1))
_UP = ((-1, 0), (-1, -1), (-1, 1))
_HORIZ = ((0, 1), (0, -1))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# padding, gathers, resizes
# ---------------------------------------------------------------------------

def pad_edge(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    if (h, w) == (H, W):
        return x
    rows = torch.arange(H, device=x.device).clamp_(max=h - 1)
    cols = torch.arange(W, device=x.device).clamp_(max=w - 1)
    return x[..., rows[:, None], cols[None, :]]


def block_anchors(pred: torch.Tensor) -> torch.Tensor:
    B, H, W = pred.shape
    Wb = (W + LANE - 1) // LANE
    pp = pad_edge(pred, H, Wb * LANE)
    return pp[:, ROWS // 2::ROWS, LANE // 2::LANE].contiguous()


def block_shift_gather(src, idx, q, radius: int) -> torch.Tensor:
    """out[b, y, x] = src[b, y, clip(x - clip(idx, q-r, q+r), 0, W-1)]."""
    B, H, W = src.shape
    q_up = (q.repeat_interleave(ROWS, 1)[:, :H]
            .repeat_interleave(LANE, 2)[:, :, :W])
    eff = torch.minimum(torch.maximum(idx, q_up - radius), q_up + radius)
    xs = torch.arange(W, dtype=torch.int32, device=src.device)
    col = (xs - eff).clamp(0, W - 1).long()
    return torch.gather(src, 2, col)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    B, H, W = img.shape
    H2, W2 = H // 2 * 2, W // 2 * 2
    x = img[:, :H2, :W2]
    x = x.reshape(B, H2, W2 // 2, 2).sum(-1)
    x = x.reshape(B, H2 // 2, 2, W2 // 2).sum(2)
    return x * 0.25


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    c = np.float32(n_in) * (np.float32(1.0) / np.float32(n_out))
    pos = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    return torch.from_numpy(np.floor(pos * c).astype(np.int64)).to(device)


def resize_nearest(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    ys = _nearest_index(H, x.shape[-2], x.device)
    xs = _nearest_index(W, x.shape[-1], x.device)
    return x[..., ys[:, None], xs[None, :]]


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------

def popcount32(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def census_transform(image: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, NW) int32 words: bit i of word i // 32 set
    where neighbour i (row-major, centre skipped) > centre; edges
    replicated."""
    img = image.to(torch.float32)
    ph, pw = height // 2, width // 2
    B, H, W = img.shape
    padded = F.pad(img[:, None], (pw, pw, ph, ph), mode="replicate")[:, 0]
    words = []
    word = torch.zeros((B, H, W), dtype=torch.int64, device=img.device)
    bit = 0
    for dy in range(-ph, ph + 1):
        for dx in range(-pw, pw + 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[:, dy + ph:dy + ph + H, dx + pw:dx + pw + W]
            word |= (nb > img).to(torch.int64) << bit
            bit += 1
            if bit == 32:
                words.append(word)
                word = torch.zeros_like(word)
                bit = 0
    if bit:
        words.append(word)
    out = torch.stack(words, dim=-1)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


# ---------------------------------------------------------------------------
# the flagship stage: census cost -> 4/8 sweeps -> WTA (census_sgm_wta)
# ---------------------------------------------------------------------------

def census_cost(cl, cr, D: int, bpm: int, H_real: int, W_real: int):
    B, H, W, NW = cl.shape
    xs = torch.arange(W, device=cl.device)
    C = torch.empty((B, H, W, D), dtype=torch.uint8, device=cl.device)
    wide = NW * 32 > U8_CLAMP
    Cw = (torch.empty((B, H, W, D), dtype=torch.int16, device=cl.device)
          if wide else None)
    for d in range(D):
        src = xs - bpm - d
        ok = (src >= 0) & (src < W_real)
        x = cl ^ cr[:, :, src.clamp(0, W - 1), :]
        ham = popcount32(x.to(torch.int64) & 0xFFFFFFFF).sum(-1)
        C[..., d] = torch.where(ok, ham.clamp(max=U8_CLAMP),
                                U8_SENTINEL).to(torch.uint8)
        if Cw is not None:
            Cw[..., d] = torch.where(ok, ham, -1).to(torch.int16)
    for plane in (C, Cw):
        if plane is not None:
            plane[:, H_real:] = 0
            plane[:, :, W_real:] = 0
    return C, Cw


def _step(prev, c, p1, p2):
    m = prev.min(-1, keepdim=True).values
    big = torch.full_like(prev[..., :1], BIG)
    up = torch.cat([big, prev[..., :-1]], -1)
    dn = torch.cat([prev[..., 1:], big], -1)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(up + p1, dn + p1))
    return (c + best) - m


def sweep_path(C, dy: int, dx: int, p1, p2) -> torch.Tensor:
    """min(L, 10000) of direction (dy, dx) over the uint8 volume (255
    invalid) or the int16 unclamped plane (negative invalid)."""
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


def _sweep(C, dy, dx, p1, p2, op, acc16=None, acc32=None):
    t = sweep_path(C, dy, dx, p1, p2)
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


def _wta_sums(C, S, subpixel: bool, uniqueness_ratio,
              dtype=torch.float32) -> torch.Tensor:
    """WTA of the float32 sums S; the subpixel offset in ``dtype``."""
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
    disp = db.to(dtype)
    if subpixel:
        Sm = S.gather(-1, (db - 1).clamp(min=0).long()).to(dtype)
        Sp = S.gather(-1, (db + 1).clamp(max=D - 1).long()).to(dtype)
        mm = m.to(dtype)
        denom = (Sm + Sp) - 2.0 * mm
        off = torch.where(denom > 1e-9, (Sm - Sp) / (2.0 * denom), 0.0)
        off = off.clamp(-0.5, 0.5)
        interior = (db > 0) & (db < D - 1)
        disp = disp + torch.where(interior, off, 0.0).to(dtype)
    return torch.where(valid, disp.to(torch.float32), NODATA)[..., 0]


def census_sgm_wta(cl, cr, D: int, *, bpm: int, W_real: int, H_real: int,
                   pens, directions: int, subpixel: bool,
                   uniqueness_ratio, dtype=torch.float32):
    """((B, H, W) residual disparity, NODATA where invalid; C uint8)."""
    dirs = DIRECTIONS_4 if directions == 4 else DIRECTIONS_8
    pen = {d: (pens[i][0], pens[i][1]) for i, d in enumerate(dirs)}
    C, Cw = census_cost(cl, cr, D, bpm, H_real, W_real)
    down = [d for d in _DOWN if d in dirs]
    up = [d for d in _UP if d in dirs]
    acc = _sweep(C if Cw is None else Cw, 0, 1, *pen[(0, 1)], "i16_new")
    _sweep(C, 0, -1, *pen[(0, -1)], "i16_addf", acc)
    if len(down) == 1:
        _sweep(C, *down[0], *pen[down[0]], "i16_addi", acc)
    else:
        acc32 = _sweep(C, *down[0], *pen[down[0]], "f32_new")
        for d in down[1:-1]:
            _sweep(C, *d, *pen[d], "f32_add", acc32=acc32)
        _sweep(C, *down[-1], *pen[down[-1]], "f32_fin", acc, acc32)
        for d in up[:-1]:
            _sweep(C, *d, *pen[d], "f32_add", acc32=acc32)
        acc = acc32
    S = acc.to(torch.float32) + sweep_path(C, *up[-1], *pen[up[-1]])
    return _wta_sums(C, S, subpixel, uniqueness_ratio, dtype), C


def right_disparity_from_C(C: torch.Tensor, bpm: int, W_real: int):
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
        best = torch.minimum(best, (plane << 8) | k)
    cost = best >> 8
    bestk = torch.where(cost < 255, best & 255, 0)
    in_img = (xs + bpm + bestk >= 0) & (xs + bpm + bestk < W_real)
    return (bpm + bestk).to(torch.float32), (cost < 255) & in_img


# ---------------------------------------------------------------------------
# the volume SGM (sgm_aggregate), with the TPU's padding and grouping
# ---------------------------------------------------------------------------

def _vmem_ok_vertical(W: int, D: int, n: int, itemsize: int) -> bool:
    return (n * 4 + 2 * itemsize + 2 * 2) * W * D < 10 * 1024 * 1024


def _groups(directions, pen, W: int, D: int, itemsize: int):
    out = [(pen[d], [d]) for d in _HORIZ if d in directions]
    for family in (_DOWN, _UP):
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


def _volume_step(prev, c, p1: float, p2: float):
    m = prev.amin(-1, keepdim=True)
    up = F.pad(prev[..., :-1], (1, 0), value=BIG)
    dn = F.pad(prev[..., 1:], (0, 1), value=BIG)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(up + p1, dn + p1))
    return (c + best) - m


def volume_path(C, dy: int, dx: int, p1: float, p2: float) -> torch.Tensor:
    """Unclamped float32 path costs L of direction (dy, dx)."""
    c = (torch.where(C == U8_SENTINEL, BIG, C.to(torch.float32))
         if C.dtype == torch.uint8 else C)
    B, H, W, D = c.shape
    out = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    if dy == 0:
        prev = torch.zeros_like(c[:, :, 0])
        for x in (range(W) if dx > 0 else range(W - 1, -1, -1)):
            prev = _volume_step(prev, c[:, :, x], p1, p2)
            out[:, :, x] = prev
        return out
    prev = torch.zeros_like(c[:, 0])
    for y in (range(H) if dy > 0 else range(H - 1, -1, -1)):
        if dx > 0:
            prev = F.pad(prev[:, :-1], (0, 0, 1, 0))
        elif dx < 0:
            prev = F.pad(prev[:, 1:], (0, 0, 0, 1))
        prev = _volume_step(prev, c[:, y], p1, p2)
        out[:, y] = prev
    return out


def sgm_aggregate(C: torch.Tensor, p1: float, p2: float,
                  directions) -> torch.Tensor:
    """float32 sum of the path costs of a float32 (B, H, W, D) volume
    (invalid 1e9), padded to multiples of 8 (zero cost) and D to a
    multiple of 128 (invalid), summed in the TPU's groups and order."""
    directions = tuple(tuple(d) for d in directions)
    B, H, W, D = C.shape
    padH, padW, padD = -(-H // 8) * 8, -(-W // 8) * 8, -(-D // 128) * 128
    Cb = C
    if (padH, padW) != (H, W):
        Cb = F.pad(Cb, (0, 0, 0, padW - W, 0, padH - H), value=0)
    if padD != D:
        Cb = F.pad(Cb, (0, padD - D), value=BIG)
    Cb = Cb.contiguous()
    pen = {d: (float(p1), float(p2)) for d in directions}
    S = None
    for (q1, q2), ds in _groups(directions, pen, padW, padD,
                                Cb.element_size()):
        T = None
        for dy, dx in ds:
            v = volume_path(Cb, dy, dx, q1, q2)
            T = v if T is None else T + v
        S = T if S is None else S + T
    return S[:, :H, :W, :D]


# ---------------------------------------------------------------------------
# pixel costs (SGBM)
# ---------------------------------------------------------------------------

def _taps(x: torch.Tensor, axis: int, offsets):
    n = x.shape[axis]
    base = torch.arange(n, device=x.device)
    return (x.index_select(axis, (base + o).clamp(0, n - 1))
            for o in offsets)


def xsobel_prefilter(img: torch.Tensor, cap: int) -> torch.Tensor:
    up, mid, dn = _taps(img, 1, (-1, 0, 1))
    (ul, ur), (ml, mr), (dl, dr) = (_taps(r, 2, (-1, 1))
                                    for r in (up, mid, dn))
    gx = (ur - ul) + 2.0 * (mr - ml) + (dr - dl)
    return (gx + cap).clamp(0.0, 2.0 * cap)


def gather_disparity_shifted(right, min_disparity: int, D: int):
    B, H, W = right.shape[:3]
    src = (torch.arange(W, device=right.device)[:, None]
           - torch.arange(D, device=right.device)[None, :]
           - int(min_disparity))
    valid = (src >= 0) & (src < W)
    return right[:, :, src.clamp(0, W - 1)], valid.expand(B, H, W, D)


def _half_sample_bounds(img: torch.Tensor):
    left, right = _taps(img, img.ndim - 1, (-1, 1))
    minus = 0.5 * (img + left)
    plus = 0.5 * (img + right)
    lo = torch.minimum(torch.minimum(minus, plus), img)
    hi = torch.maximum(torch.maximum(minus, plus), img)
    return lo, hi


def bt_cost_volume(left, right, min_disparity: int, D: int):
    lL, hL = _half_sample_bounds(left)
    lR, hR = _half_sample_bounds(right)
    Rg, valid = gather_disparity_shifted(right, min_disparity, D)
    lRg, _ = gather_disparity_shifted(lR, min_disparity, D)
    hRg, _ = gather_disparity_shifted(hR, min_disparity, D)
    L = left[..., None]
    dl = torch.maximum(L - hRg, lRg - L).clamp(min=0.0)
    dr = torch.maximum(Rg - hL[..., None], lL[..., None] - Rg).clamp(min=0.0)
    return torch.where(valid, torch.minimum(dl, dr), BIG), valid


def box_aggregate(C, valid, window: int) -> torch.Tensor:
    if window <= 1:
        return C
    x = torch.where(valid, C, 0.0)
    r = window // 2
    for ax in (1, 2):
        taps = _taps(x, ax, range(-r, r + 1))
        x = next(taps)
        for t in taps:
            x = x + t
    return torch.where(valid, x, BIG)


# ---------------------------------------------------------------------------
# WTA, LR check, speckle, median
# ---------------------------------------------------------------------------

def wta_disparity(S, min_disparity: int, *, uniqueness_ratio, subpixel,
                  dtype=torch.float32):
    """First argmin, uniqueness margin, parabolic subpixel (in ``dtype``)."""
    D = S.shape[-1]
    Sbest, best = S.min(-1, keepdim=True)
    valid = Sbest < BIG / 2
    ur = float(uniqueness_ratio)
    if ur > 0:
        d_idx = torch.arange(D, device=S.device)
        far = (d_idx - best).abs() > 1
        min_far = torch.where(far, S, torch.inf).amin(-1, keepdim=True)
        valid = valid & (min_far * (100.0 - ur) >= Sbest * 100.0)
    disp = best.to(dtype)
    if subpixel:
        Sm = S.gather(-1, (best - 1).clamp(min=0)).to(dtype)
        Sp = S.gather(-1, (best + 1).clamp(max=D - 1)).to(dtype)
        denom = (Sm + Sp) - 2.0 * Sbest.to(dtype)
        offset = torch.where(denom > 1e-9, (Sm - Sp) / (2.0 * denom), 0.0)
        offset = offset.clamp(-0.5, 0.5)
        interior = (best > 0) & (best < D - 1)
        disp = disp + torch.where(interior, offset, 0.0).to(dtype)
    disp = disp.to(torch.float32) + float(min_disparity)
    return disp[..., 0], valid[..., 0]


def lr_consistency(disp, valid, S, min_disparity: int, max_diff):
    B, H, W, D = S.shape
    src = (torch.arange(W, device=S.device)[:, None]
           + torch.arange(D, device=S.device)[None, :] + int(min_disparity))
    ok_src = (src >= 0) & (src < W)
    SR = torch.where(ok_src, S.gather(2, src.clamp(0, W - 1)
                                      .expand(B, H, W, D)), BIG)
    rmin, rbest = SR.min(-1)
    rbest = rbest + int(min_disparity)
    rvalid = rmin < BIG / 2
    d_int = torch.round(disp).to(torch.int64)
    xr = torch.arange(W, device=disp.device) - d_int
    in_img = (xr >= 0) & (xr < W)
    xr_c = xr.clamp(0, W - 1)
    consistent = (rbest.gather(2, xr_c) - d_int).abs() <= float(max_diff)
    return valid & in_img & rvalid.gather(2, xr_c) & consistent


_NEIGH = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _shift(x, dy: int, dx: int, fill):
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def speckle_keep(d, v, max_size: int, max_diff) -> torch.Tensor:
    """Exact ``cv::filterSpeckles`` keep-mask (the reference's bounded
    label propagation)."""
    B, H, W = d.shape
    dev = d.device
    md = torch.as_tensor(max_diff, dtype=torch.float32, device=dev)
    INF = H * W
    L = max_size + 2
    ids = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(1, H, W)
    label = torch.where(v, ids, INF)
    conn = [v & _shift(v, dy, dx, False)
            & ((d - _shift(d, dy, dx, float("inf"))).abs() <= md)
            for dy, dx in _NEIGH]

    def prop(lab):
        for (dy, dx), m in zip(_NEIGH, conn):
            lab = torch.minimum(lab, torch.where(
                m, _shift(lab, dy, dx, INF), INF))
        return lab

    for _ in range(L):
        label = prop(label)
    dirty = torch.zeros_like(v)
    for _ in range(3):
        nxt = prop(label)
        dirty = dirty | (nxt != label)
        label = nxt
    for _ in range(2 * L + 4):
        for (dy, dx), m in zip(_NEIGH, conn):
            dirty = dirty | (m & _shift(dirty, dy, dx, False))
    lab = label.reshape(B, H * W)
    safe = lab.clamp(0, H * W - 1).long()
    counts = torch.zeros((B, H * W), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, safe, (lab < INF).to(torch.int32))
    size = torch.gather(counts, 1, safe).reshape(B, H, W)
    return v & (dirty | (size > max_size))


def speckle_filter(disp, valid, *, max_size: int, max_diff,
                   downsample: int) -> torch.Tensor:
    if max_size <= 0:
        return valid
    d3, v3 = disp.to(torch.float32).contiguous(), valid.contiguous()
    B, H, W = d3.shape
    if downsample <= 1:
        return speckle_keep(d3, v3, max_size, max_diff)
    k = int(downsample)
    H2, W2 = -(-H // k), -(-W // k)
    pad = (0, W2 * k - W, 0, H2 * k - H)
    dp = F.pad(d3, pad)
    vp = F.pad(v3, pad)
    masked = torch.where(vp, dp, float("inf"))
    dd = masked.reshape(B, H2 * k, W2, k).amin(-1)
    dd = dd.reshape(B, H2, k, W2).amin(2).contiguous()
    vv = vp.reshape(B, H2 * k, W2, k).any(-1)
    vv = vv.reshape(B, H2, k, W2).any(2).contiguous()
    keep_small = speckle_keep(dd, vv, max(max_size // (k * k), 1),
                              float(np.float32(max_diff) * np.float32(k)))
    rejected = vv & ~keep_small
    rej = rejected[:, :, None, :, None].expand(B, H2, k, W2, k) \
        .reshape(B, H2 * k, W2 * k)
    return v3 & ~rej[:, :H, :W]


def _median9(v: list) -> torch.Tensor:
    v = list(v)

    def op(i, j):
        a, b = v[i], v[j]
        v[i] = torch.minimum(a, b)
        v[j] = torch.maximum(a, b)

    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        op(i, j)
    return v[4]


def _pad1(x, mode: str, value: float = 0.0):
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    p = (F.pad(x4, (1, 1, 1, 1), mode="replicate") if mode == "replicate"
         else F.pad(x4, (1, 1, 1, 1), mode="constant", value=value))
    return p.reshape(lead + p.shape[-2:])


def _shifts9(p, H: int, W: int):
    return [p[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]


def median3x3(x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape[-2:]
    return _median9(_shifts9(_pad1(x, "replicate"), H, W))


def median3x3_masked(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    H, W = x.shape[-2:]
    x = x.to(torch.float32)
    c = torch.where(valid, x, torch.nan)
    nbs = _shifts9(_pad1(c, "constant", torch.nan), H, W)
    return _median9([torch.where(torch.isnan(nb), x, nb) for nb in nbs])
