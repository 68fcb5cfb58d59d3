"""Frame-to-frame depth odometry (torch port of
``i3dr_stereo_tpu.mapping.odometry``): the pose source for the mapping
hook, in the rtabmap-odometry role of the reference's processing graph
(launch/stereo_processing.launch:88-102).

Projective point-to-plane ICP on a depth pyramid, coarse to fine (the
KinectFusion tracker): transform the current vertex map, project it into
the previous frame, read the hit pixel's vertex and normal, and take one
Gauss-Newton step on the 6-DoF normal equations, ``(4, 7, 10)`` steps at
levels ``(0, 1, 2)``. On the card a whole track is one launch of the
``icp_step`` kernel (``csrc/icp_step.cu``: a cooperative grid runs every
step of every level, each step's sums, damped 6x6 solve and pose update,
with no host sync; the reference's step is XLA, not a Pallas kernel); on
the CPU, or with ``plain=True``, the plain torch twin
:func:`icp_step_plain` runs step by step. A whole :func:`estimate_motion`
copies to the host once, at its end: the pose, the rmse and the inlier
fraction together.

The maps take the port's packed layout: per pyramid level the current
map ``(H, W, 4)`` = [x, y, z, valid], read in order, and the record
``(H, W, 8)`` = [x, y, z, valid, nx, ny, nz, ok] that the next frame
gathers from (one 32-byte record a pixel), ok being a valid normal of a
valid pixel. The reference's normals wrap around the image border
(``jnp.roll``); here a normal on the 1-pixel border is not valid (a
reference fault repaired).

Pose conventions: ``T_cw`` maps world -> camera, ``T_wc = inv(T_cw)``;
:func:`estimate_motion` returns ``T_pc`` mapping current-frame points into
the previous camera frame, so ``T_wc_cur = T_wc_prev @ T_pc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.mapping.tsdf import to_device

# the step's state, float32: T (0-15, row-major), rmse (16), inlier
# fraction (17), A undamped (18-53), b (54-59), sum w r^2 (60), sum w (61)
STATE = 64
# the levels one launch of the kernel takes, at most
MAX_LEVELS = 8
# floats of one block's partial sums in the kernel's scratch
_SLOT = 32


def _backproject(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame vertex map (0 invalid).
    K is a (3, 3) tensor on depth's device (so the divisions are by
    tensors, as in the reference)."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    return torch.stack([x, y, depth], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return (a0 * b0 + a1 * b1) + a2 * b2


def _normals(verts: torch.Tensor, valid: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference surface normals of a vertex map (unit, camera
    frame, oriented toward the camera: n . p < 0) and their validity.
    Interior pixels as the reference; the 1-pixel border has no two
    neighbours on an axis, so its normals are not valid (the reference's
    ``jnp.roll`` pairs it with the opposite edge)."""
    dx = torch.roll(verts, -1, 1) - torch.roll(verts, 1, 1)
    dy = torch.roll(verts, -1, 0) - torch.roll(verts, 1, 0)
    n = _cross(dx, dy)
    norm = torch.sqrt(_dot3(n, n))
    ok = (norm > 1e-9) & valid \
        & torch.roll(valid, 1, 0) & torch.roll(valid, -1, 0) \
        & torch.roll(valid, 1, 1) & torch.roll(valid, -1, 1)
    ok[0, :] = False
    ok[-1, :] = False
    ok[:, 0] = False
    ok[:, -1] = False
    n = n / norm.clamp(min=1e-9)[..., None]
    flip = _dot3(n, verts) > 0
    n = torch.where(flip[..., None], -n, n)
    return n, ok


def _downsample_depth(d: torch.Tensor) -> torch.Tensor:
    """2x2 mean-of-valid downsample (pair sums along W, then along H, in
    the reference's order)."""
    H, W = d.shape
    x = d[:H // 2 * 2, :W // 2 * 2]
    v = (x > 0).to(d.dtype)
    xv = x * v
    xs = xv[:, 0::2] + xv[:, 1::2]
    xs = xs[0::2] + xs[1::2]
    c = v[:, 0::2] + v[:, 1::2]
    c = c[0::2] + c[1::2]
    return torch.where(c > 0, xs / c.clamp(min=1.0), 0.0)


def _so3_hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    wx, wy, wz = w[0], w[1], w[2]
    return torch.stack([torch.stack([z, -wz, wy]), torch.stack([wz, z, -wx]),
                        torch.stack([-wy, wx, z])])


def _se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exact SE(3) exponential of [omega; t] (Rodrigues) -> 4x4, with the
    reference's small-angle forms."""
    w, u = xi[:3], xi[3:]
    th = torch.sqrt((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2])
    Wh = _so3_hat(w)
    big = th > 1e-8
    a = torch.where(big, torch.sin(th) / th.clamp(min=1e-12), 1.0)
    b = torch.where(big, (1.0 - torch.cos(th)) / (th * th).clamp(min=1e-12),
                    0.5)
    c = torch.where(big, (th - torch.sin(th)) / (th * th * th).clamp(
        min=1e-12), 1.0 / 6.0)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    W2 = Wh @ Wh
    R = eye + a * Wh + b * W2
    V = eye + b * Wh + c * W2
    top = torch.cat([R, (V @ u)[:, None]], dim=1)
    bottom = torch.eye(4, dtype=xi.dtype, device=xi.device)[3:]
    return torch.cat([top, bottom], dim=0)


def level_intrinsics(K, level: int) -> np.ndarray:
    """The reference's intrinsics of pyramid level ``level`` (float32):
    ``fx / s``, ``(cx + 0.5) / s - 0.5``, s = 2^level."""
    K = np.asarray(K, np.float32)
    s = np.float32(2.0 ** level)
    half = np.float32(0.5)
    Kl = np.zeros((3, 3), np.float32)
    Kl[0, 0] = K[0, 0] / s
    Kl[1, 1] = K[1, 1] / s
    Kl[0, 2] = (K[0, 2] + half) / s - half
    Kl[1, 2] = (K[1, 2] + half) / s - half
    Kl[2, 2] = 1.0
    return Kl


def pack_maps(depth: torch.Tensor, K, levels: int) -> List[tuple]:
    """Per pyramid level, finest first, the packed maps of a depth image
    on its device: ``(cur, rec)``, float32, cur ``(H, W, 4)`` = [x, y, z,
    valid] (read in order where this frame is the current one) and rec
    ``(H, W, 8)`` = [x, y, z, valid, nx, ny, nz, ok] (gathered where it is
    the previous one)."""
    maps = []
    d = depth
    for li in range(levels):
        if li:
            d = _downsample_depth(d)
        Kl = to_device(level_intrinsics(K, li), d.device)
        valid = d > 0
        V = _backproject(d, Kl)
        N, ok = _normals(V, valid)
        cur = torch.cat([V, valid[..., None].to(V.dtype)], -1)
        nrm = torch.cat([N, (ok & valid)[..., None].to(N.dtype)], -1)
        # one copy of 16-byte halves: a 3-way concatenation of the narrow
        # fields costs the card 2.8x as much at 2448x2048
        # (kernel_probes/probe10.py at commit 1dd326f)
        maps.append((cur, torch.stack([cur, nrm], -2).reshape(
            *cur.shape[:2], 8)))
    return maps


@functools.lru_cache(maxsize=256)
def _step_scalars(dist_thresh: float, H: int, W: int):
    """The step's float32 constants: dist_thresh^2 and 1 / (H W) (XLA
    multiplies by the reciprocal of a constant divisor)."""
    return (np.float32(dist_thresh) * np.float32(dist_thresh),
            np.float32(1.0) / np.float32(H * W))


def icp_step_plain(cur: torch.Tensor, prev: torch.Tensor, cam,
                   state: torch.Tensor, dist_thresh: float) -> torch.Tensor:
    """Plain torch twin of the ``icp_step`` kernel: one Gauss-Newton step
    of the reference's ``_icp_level`` on packed maps (the current frame's
    ``cur`` and the previous frame's record ``prev``); returns the new
    state (``STATE`` floats: T, rmse, frac, A, b, the two sums).

    ``cam`` = (fx, fy, cx, cy) of the level (float32 values). The
    per-pixel arithmetic is the reference's, op by op in its order; A is
    one product ``Jw^T J`` and the damped solve ``torch.linalg.solve_ex``
    (no host sync)."""
    dev = cur.device
    H, W = cur.shape[:2]
    fx, fy, cx, cy = (torch.full((), float(v), dtype=torch.float32,
                                 device=dev) for v in cam)
    T = state[:16].reshape(4, 4)
    Vc, okc = cur[..., :3], cur[..., 3] > 0
    p = torch.stack([(Vc[..., 0] * T[r, 0] + Vc[..., 1] * T[r, 1]
                      + Vc[..., 2] * T[r, 2]) + T[r, 3] for r in range(3)],
                    dim=-1)
    pz = p[..., 2].clamp(min=1e-9)
    u = (fx * p[..., 0]) / pz + cx
    v = (fy * p[..., 1]) / pz + cy
    ui = torch.round(u).clamp(-1, W).to(torch.int64)
    vi = torch.round(v).clamp(-1, H).to(torch.int64)
    inb = (p[..., 2] > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
    hit = prev.reshape(-1, 8)[flat]
    q, n, hit_ok = hit[..., :3], hit[..., 4:7], hit[..., 7] > 0
    d = p - q
    r = _dot3(d, n)
    thr2, inv_hw = _step_scalars(dist_thresh, H, W)
    close = _dot3(d, d) < torch.full((), float(thr2), device=dev)
    wgt = (okc & inb & hit_ok & close).to(torch.float32)
    J = torch.cat([_cross(p, n), n], dim=-1).reshape(-1, 6)
    Jw = J * wgt.reshape(-1, 1)
    A = Jw.T @ J
    b = -(Jw.T @ r.reshape(-1))
    sr2 = (wgt * r * r).sum()
    sw = wgt.sum()
    Ad = A + 1e-6 * torch.eye(6, dtype=A.dtype, device=dev)
    xi = torch.linalg.solve_ex(Ad, b)[0]
    T_new = _se3_exp(xi) @ T
    nw = sw.clamp(min=1.0)
    out = torch.zeros(STATE, dtype=torch.float32, device=dev)
    out[:16] = T_new.reshape(-1)
    out[16] = torch.sqrt(sr2 / nw)
    out[17] = nw * float(inv_hw)
    out[18:54] = A.reshape(-1)
    out[54:60] = b
    out[60] = sr2
    out[61] = sw
    return out


def check_level(cur: torch.Tensor, prev: torch.Tensor) -> None:
    """Raise ``ValueError`` unless ``cur`` is an (H, W, 4) and ``prev`` an
    (H, W, 8) float32 map, contiguous, on one device, 16- and 32-byte
    aligned (the kernel reads a pixel as float4s and a record as one
    32-byte sector)."""
    cs, ps = cur.shape, prev.shape
    if (cur.dtype != torch.float32 or prev.dtype != torch.float32
            or len(cs) != 3 or cs[2] != 4 or cs[0] < 1 or cs[1] < 1
            or ps != (cs[0], cs[1], 8)):
        raise ValueError(f"an ICP level takes float32 maps (H, W, 4) and "
                         f"(H, W, 8), got {cur.dtype} {tuple(cs)} and "
                         f"{prev.dtype} {tuple(ps)}")
    if not (cur.is_contiguous() and prev.is_contiguous()) \
            or cur.device != prev.device:
        raise ValueError("an ICP level's maps are contiguous, on one device")
    if cur.data_ptr() % 16 or prev.data_ptr() % 32:
        raise ValueError("an ICP level's maps are 16- (cur) and 32-byte "
                         "(prev) aligned")


def _check_state(state: torch.Tensor) -> None:
    if (state.dtype != torch.float32 or state.numel() < STATE
            or not state.is_contiguous()):
        raise ValueError(f"ICP takes a contiguous float32 state of {STATE}")


def launch_table(levels, dist_thresh: float):
    """What one launch of the kernel takes for ``levels`` [(cur, prev, cam,
    steps), ...] in the order they run: the maps' addresses (n, 2) uint64,
    (H, W, steps) (n, 3) int32, (fx, fy, cx, cy, 1 / (H W)) (n, 5)
    float32 and dist_thresh^2 in float32."""
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"one ICP launch takes at most {MAX_LEVELS} "
                         f"levels, got {len(levels)}")
    maps, dims, cams = [], [], []
    for cur, prev, cam, steps in levels:
        check_level(cur, prev)
        if steps < 0:
            raise ValueError(f"a level takes 0 or more steps, got {steps}")
        H, W = cur.shape[:2]
        maps += (cur.data_ptr(), prev.data_ptr())
        dims += (H, W, steps)
        cams += (*cam, _step_scalars(dist_thresh, H, W)[1])
    return (np.array(maps, np.uint64).reshape(-1, 2),
            np.array(dims, np.int32).reshape(-1, 3),
            np.array(cams, np.float32).reshape(-1, 5),
            _step_scalars(dist_thresh, 1, 1)[0])


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, max_pixels: int) -> int:
    """The kernel's cooperative grid on this card for this largest level
    (its C entry asks the card's occupancy): once per card and shape."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().i3dr_icp_grid(max_pixels,
                                             ctypes.addressof(blocks))
    if err:
        raise RuntimeError(f"i3dr_icp_grid: CUDA error {err}")
    return blocks.value


def icp_track(levels, state: torch.Tensor, dist_thresh: float, *,
              plain: bool = False) -> torch.Tensor:
    """Every step of ``levels`` [(cur, prev, cam, steps), ...] in the order
    they run (coarse to fine), rmse and the fraction zeroed where each
    level starts. A CUDA state launches the ``icp_step`` kernel once for
    all of them, which rewrites ``state`` in place and returns it; a grid
    the card cannot hold at once, or a failed build, raises (nothing falls
    back). A CPU state, or ``plain=True``, runs the twin step by step and
    returns a new state."""
    _check_state(state)
    if plain or state.device.type == "cpu":
        for cur, prev, cam, steps in levels:
            check_level(cur, prev)
            state = state.clone()
            state[16:18] = 0.0
            for _ in range(steps):
                state = icp_step_plain(cur, prev, cam, state, dist_thresh)
        return state
    _build.require_cuda(state, *(m for lv in levels for m in lv[:2]))
    maps, dims, cams, thr2 = launch_table(levels, dist_thresh)
    blocks = _grid(state.device.index,
                   max((int(h) * int(w) for h, w, _ in dims), default=1))
    partials = torch.empty(2 * blocks * _SLOT, dtype=torch.float32,
                           device=state.device)
    _build.launch("i3dr_icp_track", "icp_step", state.device, len(levels),
                  maps.ctypes.data, dims.ctypes.data, cams.ctypes.data,
                  float(thr2), partials.data_ptr(), state.data_ptr(), blocks,
                  _build.stream_of(state))
    return state


def icp_step(cur: torch.Tensor, prev: torch.Tensor, cam, state: torch.Tensor,
             dist_thresh: float, *, plain: bool = False) -> torch.Tensor:
    """One Gauss-Newton step (the arguments of :func:`icp_step_plain`):
    :func:`icp_track` of one level of one step."""
    return icp_track([(cur, prev, cam, 1)], state, dist_thresh, plain=plain)


def _icp_level(prev_maps, cur_maps, cam, state: torch.Tensor, iters: int,
               dist_thresh, *, plain: bool = False) -> torch.Tensor:
    """Gauss-Newton point-to-plane iterations at one pyramid level (the
    reference's ``_icp_level`` on packed maps): ``prev_maps`` /
    ``cur_maps`` are a level's (cur, rec) maps of each frame; the state's
    T is the estimate of T_pc. Returns the state after ``iters`` steps;
    with no step its rmse and fraction are 0, as the reference's."""
    return icp_track([(cur_maps[0], prev_maps[1], cam, iters)], state,
                     dist_thresh, plain=plain)


def track_levels(prev_pyr, cur_pyr, K, iters: Tuple[int, ...]) -> list:
    """The levels a track runs, coarse to fine: (cur, prev, cam, steps)
    of each, with the level's intrinsics and ``iters`` indexed by pyramid
    level (0 = finest; its last entry for deeper levels): more steps at
    the cheap coarse levels, a few polish steps at full resolution."""
    Kt = tuple(np.asarray(K, np.float32).ravel().tolist())
    return [(cur_pyr[li][0], prev_pyr[li][1], _level_cam(Kt, li),
             iters[min(li, len(iters) - 1)])
            for li in range(len(cur_pyr) - 1, -1, -1)]


@functools.lru_cache(maxsize=64)
def _level_cam(Kt: tuple, li: int) -> tuple:
    """(fx, fy, cx, cy) of pyramid level ``li`` of the flat intrinsics."""
    Kl = level_intrinsics(np.array(Kt, np.float32).reshape(3, 3), li)
    return (Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2])


def _track(prev_pyr, cur_pyr, K, T_init: torch.Tensor,
           iters: Tuple[int, ...] = (4, 7, 10), dist_thresh=0.5, *,
           plain: bool = False) -> torch.Tensor:
    """Coarse-to-fine projective ICP over two frames' packed pyramids
    (finest first): one launch on the card, the twin step by step on the
    CPU or with ``plain=True``. Returns the state (T_pc, rmse, inlier
    fraction, the last step's sums) on the device; nothing is copied to
    the host."""
    state = torch.zeros(STATE, dtype=torch.float32, device=T_init.device)
    state[:16] = T_init.reshape(-1)
    return icp_track(track_levels(prev_pyr, cur_pyr, K, iters), state,
                     dist_thresh, plain=plain)


def _readout(state: torch.Tensor):
    """(T_pc, diagnostics) from the state: one copy to the host."""
    out = state[:18].cpu().numpy()
    return (out[:16].reshape(4, 4).copy(),
            {"rmse": float(out[16]), "inlier_frac": float(out[17])})


def _initial_pose(T_init, device: torch.device) -> torch.Tensor:
    if T_init is None:
        return torch.eye(4, dtype=torch.float32, device=device)
    return to_device(T_init, device)


def estimate_motion(depth_prev, depth_cur, K, *,
                    T_init: Optional[np.ndarray] = None,
                    levels: int = 3, iters: Tuple[int, ...] = (4, 7, 10),
                    dist_thresh: float = 0.5, device="cuda"):
    """Estimate T_pc mapping current-frame points into the previous
    camera frame, by coarse-to-fine projective point-to-plane ICP.

    depth_*: (H, W) metres, 0 = invalid (numpy or tensors). Runs on
    ``device`` (the card unless the caller asks for the CPU). Returns
    (T_pc 4x4 np.ndarray, diagnostics dict with rmse [m] and inlier
    fraction)."""
    dev = _build.resolve_device(device)
    prev = pack_maps(to_device(depth_prev, dev), K, levels)
    cur = pack_maps(to_device(depth_cur, dev), K, levels)
    state = _track(prev, cur, K, _initial_pose(T_init, dev), tuple(iters),
                   dist_thresh)
    return _readout(state)


@dataclasses.dataclass
class DepthOdometry:
    """Incremental tracker: feed depth frames, read world poses.

    Maintains ``T_wc`` (camera -> world) of the latest frame, composing
    frame-to-frame ICP motions; feed :attr:`T_cw` to
    :meth:`~i3dr_stereo_tpu_torch.mapping.tsdf.TSDFVolume.integrate`. The
    previous frame's packed pyramid stays on the device between calls
    (each frame's maps are built once).
    """

    K: np.ndarray
    levels: int = 3
    iters: Tuple[int, ...] = (4, 7, 10)
    dist_thresh: float = 0.5
    device: object = "cuda"

    def __post_init__(self):
        self.device = _build.resolve_device(self.device)
        self._prev = None
        self.T_wc = np.eye(4, dtype=np.float32)
        self.last_diag = {"rmse": 0.0, "inlier_frac": 0.0}

    @property
    def T_cw(self) -> np.ndarray:
        T = self.T_wc
        R, t = T[:3, :3], T[:3, 3]
        inv = np.eye(4, dtype=np.float32)
        inv[:3, :3] = R.T
        inv[:3, 3] = -R.T @ t
        return inv

    def track(self, depth) -> np.ndarray:
        """Process one depth frame; returns the updated T_wc."""
        maps = pack_maps(to_device(depth, self.device), self.K, self.levels)
        if self._prev is not None:
            state = _track(self._prev, maps, self.K,
                           _initial_pose(None, self.device),
                           tuple(self.iters), self.dist_thresh)
            T_pc, diag = _readout(state)
            self.T_wc = (self.T_wc @ T_pc).astype(np.float32)
            self.last_diag = diag
        self._prev = maps
        return self.T_wc


# ---------------------------------------------------------------------------
# analytic scene renderer (tests / demos): depth of axis-aligned planes
# ---------------------------------------------------------------------------

def render_plane_depth(K, T_wc, planes, H: int, W: int,
                       z_max: float = 100.0) -> np.ndarray:
    """Ray-cast depth of a scene of finite planes from pose T_wc.

    ``planes``: list of (point, normal, half_extents) in world coords —
    the ray hits the plane iff the hit point lies within half_extents of
    ``point`` along every axis. Closed-form, host-side; exact ground
    truth for odometry tests (no stereo matching noise)."""
    K = np.asarray(K, np.float64)
    T_wc = np.asarray(T_wc, np.float64)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    rays_c = np.stack([(u - K[0, 2]) / K[0, 0],
                       (v - K[1, 2]) / K[1, 1],
                       np.ones_like(u, np.float64)], axis=-1)
    Rwc, twc = T_wc[:3, :3], T_wc[:3, 3]
    rays_w = rays_c @ Rwc.T
    org = twc

    depth = np.full((H, W), np.inf)
    for point, normal, half in planes:
        p0 = np.asarray(point, np.float64)
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        denom = rays_w @ n
        tnum = (p0 - org) @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = np.where(np.abs(denom) > 1e-9, tnum / denom, np.inf)
        hit = rays_w * np.where(np.isfinite(tt), tt, 0.0)[..., None] + org
        inside = np.all(np.abs(hit - p0) <= np.asarray(half) + 1e-9, axis=-1)
        ok = (np.abs(denom) > 1e-9) & (tt > 1e-6) & inside
        z_cam = tt  # rays have unit z in camera frame -> t IS camera depth
        depth = np.where(ok & (z_cam < depth), z_cam, depth)
    depth = np.where(np.isfinite(depth) & (depth < z_max), depth, 0.0)
    return depth.astype(np.float32)
