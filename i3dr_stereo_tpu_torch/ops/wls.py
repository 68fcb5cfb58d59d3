"""Edge-aware weighted-least-squares disparity filtering and hole filling
(torch port of ``i3dr_stereo_tpu.ops.wls``).

The reference's "interp" path runs cv::ximgproc's WLS disparity filter
(lambda = 8000, sigma = 1.5) over a forward and a backward match
(matcherOpenCVBlock.cpp:22-33, matcherOpenCVSGBM.cpp:22-33). Here, as in
the JAX package, it is the Fast Global Smoother form of WLS: alternating
horizontal and vertical 1-D passes, each a tridiagonal system a line,

    (a_i + lam (w_{i-1} + w_i)) u_i - lam w_{i-1} u_{i-1} - lam w_i u_{i+1}
        = a_i d_i,

with guide edge weights w_i = exp(-|I_{i+1} - I_i| / sigma) and data
weights a_i (1 on valid pixels, 0 in holes, the confidence for
:func:`wls_fill_lr`).

The line solve (the reference's two ``lax.scan``s of ``_thomas_rows``,
Thomas's algorithm) is :func:`thomas_lines`, which solves the same
system by a partition method (each line cut into 32 segments solved side
by side, then the segments' interface rows): on a CUDA tensor the
``wls_lines`` kernel (``csrc/wls_lines.cu``, a thread a segment, one
launch a pass, the vertical pass by strides with no transposed copy); on
a CPU tensor, or with ``plain=True``, its twin
:func:`thomas_lines_plain`, the same operations vectorised over the
segments. Everything else is plain torch on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python number ``c`` as XLA computes it: a product
    with the float32 reciprocal of float32(c) (its algebraic simplifier
    rewrites a division by a constant so), on every device."""
    return x * float(np.float32(1.0) / np.float32(c))


PARTS = 32   # segments a line of the partitioned solve


def _pivot(den: torch.Tensor) -> torch.Tensor:
    """A pivot that is exactly 0 (the reference divides by it: NaN, then
    NaN over the whole image) takes the 1e-8 the diagonal was given."""
    return torch.where(den == 0, 1e-8, den)


def thomas_lines_plain(a: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                       lam: float) -> torch.Tensor:
    """Plain torch twin of the ``wls_lines`` kernel: the 1-D WLS system of
    the reference's ``_thomas_rows`` solved along the last axis by the
    kernel's partition method, op for op (``csrc/wls_lines.cu`` says how):
    S = ceil(N / 32) made odd, segment k = [k S, min(k S + S, N)), its last
    element an interface; each interior eliminated from the left (a
    reciprocal of the pivot, three products) and its first
    element expressed by substituting back, the interface rows solved by
    Thomas's algorithm, the interiors substituted back.
    a, d: (..., N); w: (..., N-1) edge weights between i and i+1; ``lam`` a
    Python float (used as float32). Returns u (..., N)."""
    N = d.shape[-1]
    zeros = torch.zeros_like(d[..., :1])
    wl = torch.cat([zeros, w], -1)                 # w_{i-1}, 0 at i = 0
    wr = torch.cat([w, zeros], -1)                 # w_i, 0 at i = N-1
    diag = a + lam * (wl + wr) + 1e-8
    lower = -lam * wl                              # coefficient of u_{i-1}
    upper = -lam * wr                              # coefficient of u_{i+1}
    rhs = a * d
    S = -(-N // PARTS) | 1     # odd: the kernel's segments on different banks
    K = -(-N // S)

    def seg(x):                                    # (..., K, S)
        return torch.nn.functional.pad(x, (0, K * S - N)).unflatten(-1,
                                                                    (K, S))

    dg, lo, up, f = (seg(x) for x in (diag, lower, upper, rhs))
    m = torch.full((K,), S - 1, device=d.device)   # interior lengths
    m[-1] = N - (K - 1) * S - 1
    zero = torch.zeros_like(dg[..., 0])            # (..., K)
    # 1. each interior eliminated from the left (c, P, Q kept), then its
    # first element in terms of X_{k-1} and X_k (alpha, beta, gamma) by
    # substituting back over them
    c, P, Q = zero, zero, torch.ones_like(zero)
    cs, Ps, Qs = [], [], []
    for i in range(S - 1):
        on = i < m
        inv = torch.reciprocal(_pivot(dg[..., i] - lo[..., i] * c))
        c, P, Q = (torch.where(on, new, old) for new, old in (
            (up[..., i] * inv, c), ((f[..., i] - lo[..., i] * P) * inv, P),
            (-lo[..., i] * Q * inv, Q)))
        cs.append(c)
        Ps.append(P)
        Qs.append(Q)
    al, be, ga = zero, zero, torch.ones_like(zero)
    for i in range(S - 2, -1, -1):
        on = i < m
        al, be, ga = (torch.where(on, new, old) for new, old in (
            (Ps[i] - cs[i] * al, al), (Qs[i] - cs[i] * be, be),
            (-(cs[i] * ga), ga)))
    # 2. the interface rows (the next segment's first interior element, 0
    # past the last), then Thomas's algorithm on them
    al, be, ga = (torch.cat([x[..., 1:], zero[..., :1]], -1)
                  for x in (al, be, ga))
    ks = torch.arange(K, device=d.device)
    lb, db, ub, fb = (x[..., ks, m] for x in (lo, dg, up, f))
    A = lb * Q
    D = (db - lb * c) + ub * be
    C = ub * ga
    R = (fb - lb * P) - ub * al
    cr = dr = zero[..., 0]
    crs, drs = [], []
    for k in range(K):
        inv = torch.reciprocal(_pivot(D[..., k] - A[..., k] * cr))
        cr = C[..., k] * inv
        dr = (R[..., k] - A[..., k] * dr) * inv
        crs.append(cr)
        drs.append(dr)
    X = [drs[-1]]
    for k in range(K - 2, -1, -1):
        X.append(drs[k] - crs[k] * X[-1])
    X = torch.stack(X[::-1], -1)                   # (..., K)
    Xl = torch.cat([zero[..., :1], X[..., :-1]], -1)
    # 3. back substitution of the interiors
    u = torch.empty_like(dg)
    u[..., ks, m] = X
    x = X
    for i in range(S - 2, -1, -1):
        on = i < m
        x = torch.where(on, (Ps[i] - cs[i] * x) + Qs[i] * Xl, x)
        u[..., i] = torch.where(on, x, u[..., i])
    return u.flatten(-2)[..., :N]


def thomas_lines(a: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                 lam: float, *, vertical: bool = False,
                 plain: bool = False) -> torch.Tensor:
    """The 1-D WLS system of (B, H, W) planes solved along each row, or
    along each column when ``vertical`` (w then (B, H-1, W), else
    (B, H, W-1)). A CPU tensor, or ``plain=True``, runs the twin (on the
    transposed planes when ``vertical``, as the reference does); a CUDA
    tensor launches the kernel or raises."""
    if plain or d.device.type == "cpu":
        if not vertical:
            return thomas_lines_plain(a, w, d, lam)
        return thomas_lines_plain(a.transpose(-1, -2), w.transpose(-1, -2),
                                  d.transpose(-1, -2),
                                  lam).transpose(-1, -2)
    return _lines_kernel(*(x.to(torch.float32).contiguous()
                           for x in (a, w, d)), lam, vertical)


def _lines_kernel(a: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                  lam: float, vertical: bool) -> torch.Tensor:
    """One launch of the ``wls_lines`` kernel on contiguous (B, H, W)
    float32 planes on the card."""
    B, H, W = d.shape
    want = (B, H - 1, W) if vertical else (B, H, W - 1)
    if a.shape != d.shape or tuple(w.shape) != want:
        raise ValueError(f"thomas_lines: a {tuple(a.shape)}, d "
                         f"{tuple(d.shape)} and w {tuple(w.shape)} (expected "
                         f"{want})")
    _build.require_cuda(a, w, d)
    u = torch.empty_like(d)
    if vertical:   # lines are columns: L = W lines of N = H elements
        L, N, lay = W, H, (H * W, 1, W, (H - 1) * W, 1, W)
    else:          # lines are rows
        L, N, lay = H, W, (H * W, W, 1, H * (W - 1), W - 1, 1)
    _build.launch("i3dr_wls_lines", "wls_lines", d.device, a.data_ptr(),
                  w.data_ptr(), d.data_ptr(), u.data_ptr(), B, L, N, *lay,
                  float(lam), _build.stream_of(d))
    return u


def _edge_weights(guide: torch.Tensor, sigma: float, dim: int):
    diff = guide.diff(dim=dim).abs()
    return torch.exp(div_const(-diff, max(sigma, 1e-6)))


def wls_filter(disp: torch.Tensor, conf: torch.Tensor, guide: torch.Tensor,
               lam: float = 8000.0, sigma_color: float = 1.5,
               iters: int = 3, *, plain: bool = False) -> torch.Tensor:
    """Confidence-weighted WLS smoothing of (B, H, W) disparities guided
    by the left image: conf in [0, 1], guide in [0, 255] (normalised to
    [0, 1], sigma / 10 as in the reference). ``iters`` rounds of a
    horizontal and a vertical pass on the FGS lambda schedule
    ``1.5 lam 4^(T-t) / (4^T - 1)`` (in Python doubles); after the first
    round every data weight is at least 0.1."""
    if disp.ndim == 2:
        return wls_filter(disp[None], conf[None], guide[None], lam,
                          sigma_color, iters, plain=plain)[0]
    g = div_const(guide.to(torch.float32), 255.0)
    sigma = sigma_color / 10.0
    d = torch.where(conf > 0, disp, 0.0)
    a = conf.to(torch.float32)
    wh = _edge_weights(g, sigma, -1)
    wv = _edge_weights(g, sigma, -2)
    u = d
    T = iters
    for t in range(1, T + 1):
        lam_t = 1.5 * lam * (4.0 ** (T - t)) / (4.0 ** T - 1.0)
        u = thomas_lines(a, wh, u, lam_t, plain=plain)
        u = thomas_lines(a, wv, u, lam_t, vertical=True, plain=plain)
        a = torch.clamp(a, min=0.1)
    return u


def wls_fill(disp: torch.Tensor, valid: torch.Tensor, guide: torch.Tensor,
             *, plain: bool = False):
    """The reference's "interp" fill: smooth and fill holes, keep the
    valid disparities, then mark everything valid ("will smooth holes but
    give less accurate results", cfg/i3DR_Disparity.cfg:38)."""
    filled = wls_filter(disp, valid.to(torch.float32), guide, plain=plain)
    return torch.where(valid, disp, filled), torch.ones_like(valid)


def lr_confidence(disp: torch.Tensor, valid: torch.Tensor,
                  disp_right: torch.Tensor, valid_right: torch.Tensor,
                  lrc_thresh: float = 1.5) -> torch.Tensor:
    """Left-right consistency confidence in [0, 1]: 1 where
    |d_L(x) - d_R(x - round(d_L(x)))| is within the threshold, falling
    linearly to 0 at twice it; 0 where either side is invalid or x - d
    leaves the image. ``disp_right`` is right-anchored, positive."""
    batched = disp.ndim == 3
    d3, v3, dr3, vr3 = (x if batched else x[None]
                        for x in (disp, valid, disp_right, valid_right))
    W = d3.shape[-1]
    xr = (torch.arange(W, dtype=torch.int64, device=disp.device)
          - torch.round(d3).to(torch.int64))
    in_img = (xr >= 0) & (xr < W)
    xr_c = xr.clamp(0, W - 1)
    err = (d3 - dr3.gather(-1, xr_c)).abs()
    ramp = (2.0 - div_const(err, max(lrc_thresh, 1e-6))).clamp(0.0, 1.0)
    conf = torch.where(v3 & in_img & vr3.gather(-1, xr_c), ramp, 0.0)
    return conf if batched else conf[0]


def wls_fill_lr(disp: torch.Tensor, valid: torch.Tensor,
                disp_right: torch.Tensor, valid_right: torch.Tensor,
                guide: torch.Tensor, lam: float = 8000.0,
                sigma_color: float = 1.5, lrc_thresh: float = 1.5, *,
                plain: bool = False):
    """The reference's full interp path: the backward match's LR
    confidence weights the WLS filter; pixels below full confidence and
    holes take the filtered value; everything is returned valid."""
    conf = lr_confidence(disp, valid, disp_right, valid_right, lrc_thresh)
    filtered = wls_filter(disp, conf, guide, lam=lam,
                          sigma_color=sigma_color, plain=plain)
    return torch.where(conf >= 1.0, disp, filtered), torch.ones_like(valid)
