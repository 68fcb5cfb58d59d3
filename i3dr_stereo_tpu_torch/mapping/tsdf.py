"""TSDF voxel mapping (torch port of ``i3dr_stereo_tpu.mapping.tsdf``).

The downstream consumer of the cloud topic: the reference's
stereo_processing.launch wires external mapping packages (rtabmap, pcl)
onto /points2 (stereo_processing.launch:88-122); this is a first-party
consumer for the ``map_consumer`` hook of
:func:`i3dr_stereo_tpu_torch.bridge.launch.launch_processing`, a
truncated-signed-distance-field voxel volume fused from depth.

Integration is voxel-projective: every voxel centre is projected into the
depth image and reads the depth at its rounded pixel. On a CUDA tensor
:func:`integrate` runs the ``tsdf_integrate`` kernel
(``csrc/tsdf_integrate.cu``: one pass over the grid, in place; the
reference's update is XLA, not a Pallas kernel); on a CPU tensor, or with
``plain=True``, the plain torch twin :func:`integrate_plain`, bit-equal to
the kernel. The volume's arrays stay on the device; its outputs reduce
there and copy only the result to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build

# the twin works on slabs of the grid's first axis of at most this many
# voxels, to bound its intermediates (~30 slab-sized tensors)
TWIN_SLAB = 1 << 24


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _geometry(K, T_cw, origin, voxel_size, trunc_vox):
    """K, T_cw, origin as float32 host arrays, the voxel size and
    ``trunc = trunc_vox * voxel`` as float32 (the reference's values)."""
    voxel = np.float32(voxel_size)
    return (_host_f32(K), _host_f32(T_cw), _host_f32(origin), voxel,
            np.float32(trunc_vox) * voxel)


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or tensor) as a float32 tensor on ``device``. A host
    array bound for the card is staged through pinned memory and copied
    without waiting (a pageable copy makes the host wait for the card)."""
    if isinstance(x, torch.Tensor) and x.device == device:
        return x.to(torch.float32)
    t = x.detach().cpu() if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.require(x, np.float32, ["C", "W"]))
    t = t.to(torch.float32).contiguous()
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def integrate_plain(tsdf: torch.Tensor, weight: torch.Tensor,
                    depth: torch.Tensor, K, T_cw, origin, voxel_size: float,
                    trunc_vox: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the ``tsdf_integrate`` kernel: one TSDF fusion
    step, returned as new ``(tsdf, weight)`` tensors.

    tsdf / weight: (X, Y, Z) float32; depth: (H, W) metres (0 = invalid),
    on their device; K (3, 3), T_cw (4, 4) world->camera, origin (3,):
    host arrays. The reference's float32 operations in its order, each
    rounded on its own; divisions by tensors (torch divides by a Python
    scalar as a product with its reciprocal on the card). The projection's
    rounded pixel is clamped in float before the int cast (torch's cast of
    an out-of-range float differs between the CPU and CUDA)."""
    dev = tsdf.device
    X, Y, Z = tsdf.shape
    H, W = depth.shape
    K, T, o, voxel, trunc = _geometry(K, T_cw, origin, voxel_size, trunc_vox)

    def s(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    trunc_t, eps_t = s(trunc), s(1e-9)
    k00, k02, k11, k12 = s(K[0, 0]), s(K[0, 2]), s(K[1, 1]), s(K[1, 2])
    flat_depth = depth.reshape(-1)

    def axis(n, o_i, shape):
        i = torch.arange(n, dtype=torch.float32, device=dev)
        return (s(o_i) + (i + 0.5) * s(voxel)).reshape(shape)

    wy = axis(Y, o[1], (1, Y, 1))
    wz = axis(Z, o[2], (1, 1, Z))
    tsdf_out = torch.empty_like(tsdf)
    w_out = torch.empty_like(weight)
    slab = max(1, TWIN_SLAB // max(Y * Z, 1))
    for x0 in range(0, X, slab):
        x1 = min(X, x0 + slab)
        wx = axis(X, o[0], (X, 1, 1))[x0:x1]

        def cam(r):
            return (s(T[r, 0]) * wx + s(T[r, 1]) * wy
                    + s(T[r, 2]) * wz) + s(T[r, 3])

        cx, cy, cz = cam(0), cam(1), cam(2)
        u = (k00 * cx) / cz + k02
        v = (k11 * cy) / cz + k12
        uf = torch.nan_to_num(torch.round(u), nan=-1.0).clamp(-1, W)
        vf = torch.nan_to_num(torch.round(v), nan=-1.0).clamp(-1, H)
        ui, vi = uf.to(torch.int64), vf.to(torch.int64)
        in_img = (cz > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        d = flat_depth[vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)]
        sdf = d - cz
        seen = in_img & (d > 0.0) & (sdf > -trunc_t)
        t_new = (sdf / trunc_t).clamp(-1.0, 1.0)
        w_new = seen.to(torch.float32)
        t0, w0 = tsdf[x0:x1], weight[x0:x1]
        w_tot = w0 + w_new
        fused = (t0 * w0 + t_new * w_new) / torch.maximum(w_tot, eps_t)
        tsdf_out[x0:x1] = torch.where(w_tot > 0.0, fused, t0)
        w_out[x0:x1] = w_tot
    return tsdf_out, w_out


def integrate(tsdf: torch.Tensor, weight: torch.Tensor, depth: torch.Tensor,
              K, T_cw, origin, voxel_size: float, trunc_vox: int = 3, *,
              plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One TSDF fusion step (the arguments of :func:`integrate_plain`).
    A CPU tensor, or ``plain=True``, runs the twin and returns new
    tensors; a CUDA tensor launches the kernel, which updates ``tsdf`` and
    ``weight`` in place and returns them, or raises."""
    if plain or tsdf.device.type == "cpu":
        return integrate_plain(tsdf, weight, depth, K, T_cw, origin,
                               voxel_size, trunc_vox)
    depth = depth.to(torch.float32).contiguous()
    _build.require_cuda(tsdf, weight, depth)
    if tsdf.dtype != torch.float32 or weight.dtype != torch.float32 \
            or tsdf.shape != weight.shape or tsdf.ndim != 3:
        raise ValueError("tsdf_integrate takes (X, Y, Z) float32 tsdf and "
                         "weight of one shape")
    X, Y, Z = tsdf.shape
    H, W = depth.shape
    K, T, o, voxel, trunc = _geometry(K, T_cw, origin, voxel_size, trunc_vox)
    _build.launch("i3dr_tsdf_integrate", "tsdf_integrate", tsdf.device,
                  tsdf.data_ptr(), weight.data_ptr(), depth.data_ptr(), X, Y,
                  Z, H, W, float(K[0, 0]), float(K[0, 2]), float(K[1, 1]),
                  float(K[1, 2]), *(float(v) for v in T[:3].reshape(-1)),
                  *(float(v) for v in o), float(voxel), float(trunc),
                  _build.stream_of(tsdf))
    return tsdf, weight


@dataclasses.dataclass
class TSDFVolume:
    """Fixed world-aligned voxel grid accumulating TSDF from depth maps.

    ``shape`` voxels of ``voxel_size`` metres anchored at ``origin``
    (world coords of the grid's min corner). Camera poses are 4x4
    world->camera transforms (identity = camera at world origin looking
    +Z, the rig's optical convention). ``tsdf`` and ``weight`` live on
    ``device`` (the card unless the caller asks for the CPU; a CUDA device
    that is not there raises).
    """

    shape: Tuple[int, int, int] = (96, 96, 96)
    voxel_size: float = 0.05
    origin: Tuple[float, float, float] = (-2.4, -2.4, 0.0)
    trunc_vox: int = 3
    device: object = "cuda"

    def __post_init__(self):
        self.device = _build.resolve_device(self.device)
        self.tsdf = torch.zeros(self.shape, dtype=torch.float32,
                                device=self.device)
        self.weight = torch.zeros_like(self.tsdf)
        self.frames_integrated = 0

    def integrate(self, depth, K, T_cw: Optional[np.ndarray] = None) -> None:
        """Fuse one depth map (H, W) metres (numpy or tensor) with
        intrinsics K and camera pose T_cw (default identity). The depth is
        copied to the device once."""
        T = np.eye(4, dtype=np.float32) if T_cw is None else T_cw
        self.tsdf, self.weight = integrate(
            self.tsdf, self.weight, to_device(depth, self.device), K, T,
            self.origin, self.voxel_size, self.trunc_vox)
        self.frames_integrated += 1

    # -- outputs ----------------------------------------------------------

    def _occupied(self, band: float, min_weight: float) -> torch.Tensor:
        return (self.tsdf.abs() < band) & (self.weight >= min_weight)

    def occupied_points(self, *, band: float = 0.5, min_weight: float = 1.0
                        ) -> np.ndarray:
        """World-coordinate centers of near-surface voxels (one point per
        occupied voxel, in ``np.argwhere``'s row-major order): the indices
        are found on the device and only they are copied to the host."""
        idx = torch.nonzero(self._occupied(band, min_weight)).to(torch.int32)
        idx = idx.cpu().numpy().astype(np.float32)
        return np.asarray(self.origin, np.float32) + \
            (idx + 0.5) * np.float32(self.voxel_size)

    def occupancy_grid(self, *, band: float = 0.5, min_weight: float = 1.0
                       ) -> np.ndarray:
        """(X, Y) top-down occupancy projection (max over Z), reduced on
        the device."""
        return self._occupied(band, min_weight).any(dim=2).cpu().numpy()


def make_map_consumer(volume: TSDFVolume, rig, *, pose_lookup=None):
    """Bind a TSDFVolume to the ``map_consumer`` hook of
    :func:`~i3dr_stereo_tpu_torch.bridge.launch.launch_processing`.

    The hook delivers (stamp, points2-dict) with numpy arrays; the consumer
    rebuilds the ordered depth image from the cloud's Z channel (points2
    is organized H*W) where ``valid`` is true, and integrates it (one copy
    to the volume's device). ``pose_lookup(stamp) -> 4x4 T_cw`` supplies
    per-frame camera poses; default is a static camera.
    """
    K = np.array([[rig.left.fx, 0.0, rig.left.cx],
                  [0.0, rig.left.fy, rig.left.cy],
                  [0.0, 0.0, 1.0]], np.float32)
    H, W = rig.left.height, rig.left.width

    def consume(stamp, points) -> None:
        xyz = np.asarray(points["xyz"]).reshape(H, W, 3)
        valid = np.asarray(points["valid"]).reshape(H, W)
        depth = np.where(valid, xyz[..., 2], 0.0).astype(np.float32)
        T = None if pose_lookup is None else pose_lookup(stamp)
        volume.integrate(depth, K, T)

    return consume
