"""Belief-propagation stereo (torch port of ``i3dr_stereo_tpu.matchers.bp``):
the reference's backends 4 and 5, cv::cuda::createStereoBeliefPropagation
(matcherOpenCVBPCuda.cpp:20) and cv::cuda::createStereoConstantSpaceBP
(matcherOpenCVCSBPCuda.cpp:20), as min-sum loopy BP on the 4-connected
grid:

- data cost: the truncated absolute difference
  ``DATA_WEIGHT * min(|L - R|, MAX_DATA_TERM)``, ``0.7`` on invalid taps;
- message update: the linear truncated distance transform over the
  disparity axis (a forward and a backward min-scan with step ``jump``,
  capped at ``min + max_disc``), then the mean subtracted; all four
  directions updated synchronously from the previous iteration's
  messages;
- BP: a cost pyramid by 2x2 sum pooling (at most 5 levels, stopping
  below 8 px), iterations coarse to fine, messages upsampled by nearest
  x2 (the odd last row and column left zero); WTA over the belief, no
  uniqueness check and no speckle filter;
- CSBP: an image pyramid by 2x2 mean pooling (at most 4 levels, stopping
  below 16 px); dense BP at the coarsest level over ``max(K, D // scale)``
  disparities from 0 (CSBP ignores ``min_disparity``, as the reference
  does), then the K best planes per pixel, refined down the pyramid by BP
  on the planes (an O(K^2) message update); the argmin plane, then the
  speckle filter at ``max(speckle_range, 1)``.

Layout: the port holds a cost or message volume disparity-major, data
(B, D, H, W) and messages (4, B, D, H, W) (the reference holds D last), so
that a warp reading 32 neighbouring pixels' d-th entries makes one
transaction. Message ``i`` flows towards ``_DIRS[i]``; the message pixel
p receives from direction i is neighbour ``p - _DIRS[i]``'s message i.

The two message updates are kernels on a CUDA tensor and their plain
torch twins on a CPU tensor (or with ``plain=True``):

- :func:`bp_iterate` launches ``bp_messages`` (``csrc/bp_messages.cu``)
  once an iteration, its scans kept in shared memory where
  :func:`messages_shared` finds them room (D <= 446);
  :func:`bp_iterate_plain` is its twin;
- :func:`bp_iterate_planes` launches ``bp_planes`` (``csrc/bp_planes.cu``,
  K <= 16) once an iteration; :func:`bp_iterate_planes_plain` is its twin.

Both keep the reference's rounding points: the total is
``(((data + inc0) + inc1) + inc2) + inc3``, the excluded message is then
subtracted, and the mean is a sequential sum over d times the float32
reciprocal of D (as XLA rewrites the division), so kernel and twin are
bit-equal and the twin is within ulps of the reference (whose reduction
order for the mean is XLA's).

Memory and spans. Dense BP holds the cost pyramid (1.33 data volumes),
one message volume (four data volumes) and, while a level iterates, its
ping-pong buffer: the upsampled messages are written straight into their
level's volume and handed to the kernel to overwrite, and the belief adds
the four messages in place. The span ``bp.data_cost`` (``D``, ``H``,
``W``) covers the data volume and its pyramid, ``bp.level`` (``level``,
``H``, ``W``, ``iters``, ``bytes``: the level's message volume) a level's
upsampling and iterations, ``bp.belief`` the belief and WTA; each counts
``held_bytes`` on a CUDA device (``torch.cuda.memory_allocated`` at its
end). CSBP holds the image pyramid, the coarsest level's dense volumes
and then K planes a pixel; its spans are ``csbp.coarse``,
``csbp.select``, ``csbp.level`` and ``csbp.belief``
(:func:`_constant_space_match`), each with ``held_bytes`` too. They
record only while the tracer does (``utils/metrics.py``).

CUDA graphs. On a CUDA tensor CSBP, the speckle filter included, runs as
one CUDA graph once its key has been seen (:data:`CSBP_GRAPHS`, the
pyramid's :class:`~i3dr_stereo_tpu_torch.matchers.pyramid.PyramidGraphs`
under the span ``csbp.match``): a key's first call runs eagerly, its
second is captured and replayed, and every later call copies its two
images into the graph's inputs and replays it, so the host makes none
of its ~170 launches a frame. The stage spans above then record only in
the eager and the captured call; ``csbp.match`` records in every call,
its ``held_bytes`` counting the free bytes of the graph's pool too. A
CPU tensor, or ``plain=True``, runs eagerly on every call. Dense BP runs
eagerly: its frame is a few hundred ms of kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.config.params import MatcherConfig
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.matchers.pyramid import (PyramidGraphs,
                                                    _downsample2,
                                                    graph_key)
from i3dr_stereo_tpu_torch.ops.shift import gather_disparity_shifted
from i3dr_stereo_tpu_torch.ops.speckle import speckle_filter
from i3dr_stereo_tpu_torch.ops.wta import wta_disparity
from i3dr_stereo_tpu_torch.utils.metrics import _OFF
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS as METRICS

BIG = 1.0e9

# cv::cuda::StereoBeliefPropagation defaults
DATA_WEIGHT = 0.07
MAX_DATA_TERM = 10.0
DISC_SINGLE_JUMP = 1.0
MAX_DISC_TERM = 1.7

# message directions: index i holds messages flowing *towards* +dy/+dx;
# the opposite of direction i is i ^ 1
_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_OPP = tuple(i ^ 1 for i in range(4))

PLANES_MAX = 16   # the bp_planes kernel's largest K (its planes in registers)
# the dynamic shared memory a block may ask for on an H100 (sm_90); the
# pixels of a bp_messages strip block and the disparities its copies run
# ahead of its scan (STRIP and AHEAD in csrc/bp_messages.cu)
SHARED_MAX = 232448
MESSAGES_STRIP = 32
MESSAGES_AHEAD = 16


# ---------------------------------------------------------------------------
# the helpers and the plain twins
# ---------------------------------------------------------------------------

def distance_transform_d(h: torch.Tensor, jump: float, max_disc: float,
                         dim: int = 1) -> torch.Tensor:
    """``min_d' (h(d') + min(jump |d - d'|, max_disc))`` along ``dim``:
    the reference's two scans (a forward and a backward min-scan from
    ``BIG``, each step adding ``jump``), then the cap ``min h + max_disc``.
    Bit-equal to the reference's ``_distance_transform_d``."""
    hm = h.movedim(dim, 0)
    out = torch.empty_like(hm)
    carry = torch.full_like(hm[0], BIG)
    for d in range(hm.shape[0]):
        carry = torch.minimum(hm[d], carry + jump)
        out[d] = carry
    carry = torch.full_like(hm[0], BIG)
    for d in range(hm.shape[0] - 1, -1, -1):
        carry = torch.minimum(out[d], carry + jump)
        out[d] = carry
    cap = hm.amin(0) + max_disc
    return torch.minimum(out, cap).movedim(0, dim)


def _mean_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The kernels' mean over ``dim`` (kept): a sum from d = 0 upwards,
    then the product with float32(1 / n)."""
    xs = x.movedim(dim, 0)
    s = torch.zeros_like(xs[0])
    for d in range(xs.shape[0]):
        s = s + xs[d]
    inv = float(np.float32(1.0) / np.float32(xs.shape[0]))
    return (s * inv).unsqueeze(dim)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., y, x] = x[..., y - dy, x - dx]``, zero outside."""
    H, W = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def _incoming(m: torch.Tensor) -> torch.Tensor:
    """(4, B, D, H, W) messages -> what each pixel receives from each
    direction: message i of neighbour ``p - _DIRS[i]``."""
    return torch.stack([_shift2d(m[i], dy, dx)
                        for i, (dy, dx) in enumerate(_DIRS)])


def _excluding(data: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """h_i = (data + the four incoming) - the one from direction i ^ 1, in
    the reference's order of additions. (4, B, D, H, W)."""
    total = data + inc[0] + inc[1] + inc[2] + inc[3]
    return total[None] - inc[list(_OPP)]


def bp_iterate_plain(data: torch.Tensor, msgs: torch.Tensor, iters: int,
                     jump: float, max_disc: float) -> torch.Tensor:
    """Plain torch twin of ``bp_messages``: ``iters`` synchronous min-sum
    updates. data (B, D, H, W), msgs (4, B, D, H, W) -> new messages."""
    _check_volume(data, msgs)
    m = msgs
    for _ in range(iters):
        out = distance_transform_d(_excluding(data, _incoming(m)), jump,
                                   max_disc, dim=2)
        m = out - _mean_seq(out, 2)
    return m


def pairwise_smoothness(dvals: torch.Tensor, jump: float,
                        max_disc: float) -> torch.Tensor:
    """V[k', k] = min(jump |d_k' - d_k|, max_disc) for per-pixel candidate
    disparities dvals (B, K, H, W) -> (B, K', K, H, W)."""
    diff = (dvals[:, :, None] - dvals[:, None, :]).abs()
    return (jump * diff).clamp(max=max_disc)


def bp_iterate_planes_plain(data: torch.Tensor, dvals: torch.Tensor,
                            msgs: torch.Tensor, iters: int, jump: float,
                            max_disc: float) -> torch.Tensor:
    """Plain torch twin of ``bp_planes``: min-sum BP over per-pixel
    candidate planes. data, dvals (B, K, H, W); msgs (4, B, K, H, W).
    ``msg[k] = min_k' (h[k'] + V[k', k])`` with V from the sender's
    candidates on both axes (the classic CSBP approximation), then the
    mean subtracted."""
    _check_volume(data, msgs, dvals)
    V = pairwise_smoothness(dvals, jump, max_disc)[None]
    m = msgs
    for _ in range(iters):
        h = _excluding(data, _incoming(m))
        out = (h[:, :, :, None] + V).amin(2)
        m = out - _mean_seq(out, 2)
    return m


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 sum pool of the last two axes, cropped to even sizes (cv BP's
    level construction), added in XLA's order of the reference's
    ``sum(axis=(2, 4))``."""
    H2, W2 = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :H2, :W2]
    return ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2]) \
        + x[..., 1::2, 1::2]


def _upsample_msgs(m: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Nearest x2 of (..., h, w) to (..., H, W); the odd last row and
    column stay zero. Written straight into the output, one strided copy
    for each of the 2x2 offsets (no repeated temporaries)."""
    out = m.new_empty(m.shape[:-2] + (H, W))
    h, w = min(H, 2 * m.shape[-2]), min(W, 2 * m.shape[-1])
    out[..., h:, :] = 0
    out[..., :h, w:] = 0
    for a in (0, 1):
        for b in (0, 1):
            dst = out[..., a:h:2, b:w:2]
            dst.copy_(m[..., :dst.shape[-2], :dst.shape[-1]])
    return out


def _up2(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Nearest x2 of (..., h, w) to (..., H, W); the odd last row, then
    the odd last column, replicate their neighbours."""
    out = _upsample_msgs(x, H, W)
    h, w = min(H, 2 * x.shape[-2]), min(W, 2 * x.shape[-1])
    if h < H:
        out[..., h:, :] = out[..., h - 1:h, :]
    if w < W:
        out[..., :, w:] = out[..., :, w - 1:w]
    return out


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_volume(data: torch.Tensor, msgs: torch.Tensor,
                  dvals: torch.Tensor | None = None) -> None:
    ok = (data.ndim == 4 and data.dtype == torch.float32
          and msgs.dtype == torch.float32
          and tuple(msgs.shape) == (4,) + tuple(data.shape)
          and (dvals is None or (dvals.shape == data.shape
                                 and dvals.dtype == torch.float32)))
    if not ok:
        raise ValueError(
            f"expected float32 data (B, D, H, W), messages (4, B, D, H, W)"
            f"{' and candidates like data' if dvals is not None else ''}, "
            f"got {tuple(data.shape)} {data.dtype} / {tuple(msgs.shape)} "
            f"{msgs.dtype}")


def _ping_pong(msgs: torch.Tensor, iters: int, launch) -> torch.Tensor:
    """``iters`` launches of ``launch(src, dst)``, each reading the
    previous messages and writing a second buffer (the update is
    synchronous). The caller's buffer is that second buffer from the
    second launch on: ``msgs`` is consumed (one message volume less)."""
    bufs = (torch.empty_like(msgs), msgs)
    src = msgs
    for i in range(iters):
        launch(src, bufs[i % 2])
        src = bufs[i % 2]
    return src


def messages_shared(D: int) -> int:
    """The dynamic shared memory of a ``bp_messages`` block for D
    disparities, from D alone, which also picks the kernel: a pixel takes
    4 * (4 D + 2 AHEAD) bytes (its four forward scans and a ring of data
    costs), so the strip kernel runs while a 32-pixel strip's fits
    ``SHARED_MAX`` (D <= 446); beyond that the cut gives 0, the kernel
    that stages the scans in device memory. On an H100 the strip kernel
    is the faster of the two at every D up to the cut: 1.8-2.3x to D = 218
    (two or three blocks an SM), 4.7-8.1 % from D = 219 (one block an SM;
    ``kernel_probes/probe9.py --only cut``)."""
    shared = 4 * (4 * D + 2 * MESSAGES_AHEAD) * MESSAGES_STRIP
    return shared if shared <= SHARED_MAX else 0


def bp_iterate(data: torch.Tensor, msgs: torch.Tensor, iters: int,
               jump: float, max_disc: float, *,
               plain: bool = False) -> torch.Tensor:
    """``iters`` synchronous min-sum updates of (4, B, D, H, W) messages
    over (B, D, H, W) data costs, any D >= 1. A CUDA tensor launches the
    ``bp_messages`` kernel once an iteration, the one
    :func:`messages_shared` picks from D (or raises), and consumes
    ``msgs`` (:func:`_ping_pong`); a CPU tensor, or ``plain=True``, runs
    :func:`bp_iterate_plain`."""
    if plain or data.device.type == "cpu":
        return bp_iterate_plain(data, msgs, iters, jump, max_disc)
    _check_volume(data, msgs)
    _build.require_cuda(data, msgs)
    B, D, H, W = data.shape
    inv_d = float(np.float32(1.0) / np.float32(D))
    shared = messages_shared(D)
    stream = _build.stream_of(data)

    def launch(src, dst):
        _build.launch("i3dr_bp_messages", "bp_messages", data.device,
                      data.data_ptr(), src.data_ptr(), dst.data_ptr(), B, D,
                      H, W, float(jump), float(max_disc), inv_d, shared,
                      stream)

    return _ping_pong(msgs, iters, launch)


def bp_iterate_planes(data: torch.Tensor, dvals: torch.Tensor,
                      msgs: torch.Tensor, iters: int, jump: float,
                      max_disc: float, *, plain: bool = False) -> torch.Tensor:
    """``iters`` min-sum updates on K candidate planes: data, dvals (B, K,
    H, W), msgs (4, B, K, H, W). A CUDA tensor launches the ``bp_planes``
    kernel once an iteration (2 <= K <= 16, else it raises) and consumes
    ``msgs`` (:func:`_ping_pong`); a CPU tensor, or ``plain=True``, runs
    :func:`bp_iterate_planes_plain` (any K)."""
    if plain or data.device.type == "cpu":
        return bp_iterate_planes_plain(data, dvals, msgs, iters, jump,
                                       max_disc)
    _check_volume(data, msgs, dvals)
    B, K, H, W = data.shape
    if not 1 <= K <= PLANES_MAX:
        raise ValueError(f"bp_planes holds at most {PLANES_MAX} planes in "
                         f"registers, got K = {K}; plain=True takes any K")
    _build.require_cuda(data, dvals, msgs)
    inv_k = float(np.float32(1.0) / np.float32(K))
    stream = _build.stream_of(data)

    def launch(src, dst):
        _build.launch("i3dr_bp_planes", "bp_planes", data.device,
                      data.data_ptr(), dvals.data_ptr(), src.data_ptr(),
                      dst.data_ptr(), B, K, H, W, float(jump),
                      float(max_disc), inv_k, stream)

    return _ping_pong(msgs, iters, launch)


# ---------------------------------------------------------------------------
# the matchers
# ---------------------------------------------------------------------------

def data_cost(l: torch.Tensor, r: torch.Tensor, min_disparity: int,
              D: int) -> torch.Tensor:
    """The truncated AD cost (B, D, H, W) of (B, H, W) images, 0.7 where
    the tap leaves the image."""
    Rg, valid = gather_disparity_shifted(r, min_disparity, D)
    data = DATA_WEIGHT * (l[..., None] - Rg).abs().clamp(max=MAX_DATA_TERM)
    data = torch.where(valid, data, DATA_WEIGHT * MAX_DATA_TERM)
    return data.permute(0, 3, 1, 2).contiguous()


def _batched(left, right):
    left, right = torch.as_tensor(left), torch.as_tensor(right)
    batched = left.ndim == 3
    l = (left if batched else left[None]).float()
    r = (right if right.ndim == 3 else right[None]).float()
    return l, r, batched


def _constant_space_match(l, r, cfg: MatcherConfig, plain: bool):
    """CSBP: dense BP at the coarsest level, then the best K candidate
    planes per pixel refined down the image pyramid, each under a span of
    its own: ``csbp.coarse`` (``D``, ``H``, ``W``, ``iters``: the image
    pyramid, the coarsest level's data cost and its dense BP),
    ``csbp.select`` (``K``: the coarse belief, the sort and the gathers),
    ``csbp.level`` (``level``, ``H``, ``W``, ``K``, ``iters``, ``bytes``:
    the level's message volume; the upsampling, the plane costs and the
    plane updates) and ``csbp.belief`` (the final belief and argmin).
    Returns the argmin plane's disparity and validity, (B, H, W)."""
    D = cfg.disparity_range
    levels = max(1, min(cfg.bp_levels, 4))
    iters = max(1, cfg.bp_iters)
    K = max(2, min(cfg.csbp_planes, D))

    with METRICS.span("csbp.coarse") as span:
        pyr = [(l, r)]
        for _ in range(levels - 1):
            if min(pyr[-1][0].shape[1], pyr[-1][0].shape[2]) < 16:
                break
            pyr.append((_downsample2(pyr[-1][0]), _downsample2(pyr[-1][1])))
        if len(pyr) < 2:
            # the reference adds the coarsest level's dense costs to the K
            # planes' messages here and fails too
            raise ValueError(
                f"CSBP needs at least two pyramid levels: bp_levels="
                f"{cfg.bp_levels} on a {tuple(l.shape[1:])} image gives one "
                f"(a level halves an image of at least 16 px a side)")

        # the coarsest level: the full (scaled) disparity axis from 0,
        # dense BP
        lc, rc = pyr[-1]
        Dc = max(K, D // 2 ** (len(pyr) - 1))
        span.set(D=Dc, H=lc.shape[-2], W=lc.shape[-1], iters=iters)
        data = data_cost(lc, rc, 0, Dc)
        msgs = bp_iterate(data, data.new_zeros((4,) + data.shape), iters,
                          DISC_SINGLE_JUMP, MAX_DISC_TERM, plain=plain)
        _held(span, l.device)

    with METRICS.span("csbp.select", K=K) as span:
        belief = data + sum(_incoming(msgs))
        # the K best planes, the lower index first among equal beliefs (as
        # XLA's top_k orders them; torch.topk promises no order)
        idx = torch.sort(belief, dim=1, stable=True).indices[:, :K]
        dvals = idx.to(torch.float32)
        msgs = torch.stack([msgs[i].gather(1, idx) for i in range(4)])
        _held(span, l.device)

    for level in range(len(pyr) - 2, -1, -1):
        lf, rf = pyr[level]
        B, Hh, Wh = lf.shape
        with METRICS.span("csbp.level", level=level, H=Hh, W=Wh, K=K,
                          iters=iters, bytes=4 * 4 * B * K * Hh * Wh) as span:
            dvals = 2.0 * _up2(dvals, Hh, Wh)
            msgs = _up2(msgs, Hh, Wh)
            xs = torch.arange(Wh, dtype=torch.int32, device=lf.device)
            src = xs - torch.round(dvals).to(torch.int32)
            ok = (src >= 0) & (src < Wh)
            Rg = rf[:, None].expand(B, K, Hh, Wh).gather(
                3, src.clamp(0, Wh - 1).long())
            data = DATA_WEIGHT * (lf[:, None] - Rg).abs().clamp(
                max=MAX_DATA_TERM)
            data = torch.where(ok, data, DATA_WEIGHT * MAX_DATA_TERM)
            msgs = bp_iterate_planes(data, dvals, msgs.contiguous(), iters,
                                     DISC_SINGLE_JUMP, MAX_DISC_TERM,
                                     plain=plain)
            _held(span, l.device)

    with METRICS.span("csbp.belief") as span:
        belief = data + sum(_incoming(msgs))
        kbest = belief.argmin(1, keepdim=True)
        disp, valid = dvals.gather(1, kbest)[:, 0], ok.gather(1, kbest)[:, 0]
        _held(span, l.device)
    return disp, valid


def _held(span, device: torch.device) -> None:
    """A span's ``held_bytes``: what the caching allocator holds for
    tensors at its end, a count on the host (no sync); CUDA only."""
    if span is not _OFF and device.type == "cuda":
        span.set(held_bytes=torch.cuda.memory_allocated(device))


def _belief(data: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """``data + inc0 + inc1 + inc2 + inc3`` (:func:`_incoming`) in that
    order, each message added in place over the pixels it reaches, with
    no shifted copies. Elsewhere the sum would add a 0, which leaves it
    unchanged: data is never -0.0, so no partial sum is."""
    belief = data.clone()
    H, W = data.shape[-2:]
    for i, (dy, dx) in enumerate(_DIRS):
        belief[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] \
            += msgs[i][..., max(-dy, 0):H + min(-dy, 0),
                       max(-dx, 0):W + min(-dx, 0)]
    return belief


def _dense_match(l, r, cfg: MatcherConfig, plain: bool):
    """BP on (B, H, W) images: the cost pyramid, the levels coarse to
    fine, then the belief and WTA, each under a span of its own
    (``bp.data_cost``, ``bp.level``, ``bp.belief``). Each level's message
    volume is the only one beside the pyramid and its ping-pong buffer:
    the upsampled messages are handed to :func:`bp_iterate` to overwrite.
    Returns the disparity and validity, (B, H, W)."""
    D = cfg.disparity_range
    levels = max(1, min(cfg.bp_levels, 5))
    iters = max(1, cfg.bp_iters)
    with METRICS.span("bp.data_cost", D=D, H=l.shape[-2],
                      W=l.shape[-1]) as span:
        pyr = [data_cost(l, r, cfg.min_disparity, D)]
        for _ in range(levels - 1):
            if min(pyr[-1].shape[-2:]) < 8:
                break
            pyr.append(_pool2(pyr[-1]))
        _held(span, l.device)

    msgs = pyr[0].new_zeros((4,) + pyr[-1].shape)
    for level in range(len(pyr) - 1, -1, -1):
        data = pyr[level]
        with METRICS.span("bp.level", level=level, H=data.shape[-2],
                          W=data.shape[-1], iters=iters,
                          bytes=4 * data.numel() * data.element_size()) \
                as span:
            if msgs.shape[-2:] != data.shape[-2:]:
                msgs = _upsample_msgs(msgs, *data.shape[-2:])
            msgs = bp_iterate(data, msgs, iters, DISC_SINGLE_JUMP,
                              MAX_DISC_TERM, plain=plain)
            _held(span, l.device)

    with METRICS.span("bp.belief") as span:
        belief = _belief(pyr[0], msgs)
        del msgs, pyr, data
        _, valid = gather_disparity_shifted(r, cfg.min_disparity, D)
        belief = torch.where(valid, belief.permute(0, 2, 3, 1), BIG)
        # no speckle filter: the reference's gate on it is dead on this path
        disp, ok = wta_disparity(belief, cfg.min_disparity,
                                 uniqueness_ratio=0.0, subpixel=cfg.subpixel)
        _held(span, l.device)
    return disp, ok


def belief_propagation_match(left, right, cfg: MatcherConfig, *,
                             constant_space: bool,
                             plain: bool = False) -> MatchResult:
    """BP (``constant_space=False``) or CSBP on (H, W) or (B, H, W)
    images. ``plain=True`` runs the kernels' plain torch twins (and the
    speckle filter's) on whatever device the images are on. CSBP on CUDA
    tensors replays a CUDA graph from its key's second call
    (:data:`CSBP_GRAPHS`); the span ``csbp.match`` says which of
    ``eager``, ``capture`` and ``replay`` the call was."""
    l, r, batched = _batched(left, right)
    if constant_space:
        match = functools.partial(_csbp_filtered, cfg=cfg, plain=plain)
        key = graph_key(l, r, cfg, None, lean=False, plain=plain)
        if key is None:
            with METRICS.span("csbp.match", graph="eager"):
                res = match(l, r)
        else:
            res = CSBP_GRAPHS.run(key, l, r, match)
        disp, ok = res.disparity, res.valid
    else:
        disp, ok = _dense_match(l, r, cfg, plain)
    if not batched:
        disp, ok = disp[0], ok[0]
    return MatchResult(disparity=disp, valid=ok)


CSBP_GRAPHS = PyramidGraphs(span="csbp.match")


def _csbp_filtered(l: torch.Tensor, r: torch.Tensor, *, cfg: MatcherConfig,
                   plain: bool) -> MatchResult:
    """CSBP on (B, H, W) float32 images, then the speckle filter: what a
    capture records."""
    disp, ok = _constant_space_match(l, r, cfg, plain)
    if cfg.speckle_size > 0:
        ok = speckle_filter(disp, ok, max_size=cfg.speckle_size,
                            max_diff=max(cfg.speckle_range, 1.0),
                            plain=plain)
    return MatchResult(disparity=disp, valid=ok)
