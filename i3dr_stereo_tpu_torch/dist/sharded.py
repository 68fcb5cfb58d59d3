"""Sharded matching over a (data x spatial) mesh (torch port of
``i3dr_stereo_tpu.dist.sharded``).

Frames are split over the ``data`` axis; image rows over ``spatial``.
Row-sharding needs context across the cut for (a) window ops (census /
box windows) and (b) the vertical/diagonal SGM path recurrences. Both
are handled with a **halo exchange**: each row block takes its edge rows
from its spatial neighbours, the matcher runs on the extended block on
that block's device, and the halo is cropped again. SGM path costs are a
contraction toward local evidence (the - min_k normalization bounds
each step's influence), so a halo of H rows makes cross-boundary error
decay geometrically; tests measure agreement with the unsharded run
away from the cuts.

The blocks run one after another from this process (a device's kernels
are queued without waiting, but the matchers' host syncs serialize the
blocks). Every result is returned on the mesh's first device.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from i3dr_stereo_tpu_torch.config.params import MatcherConfig
from i3dr_stereo_tpu_torch.dist.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.matchers.registry import MATCHER_REGISTRY


def _exchange_halo(blocks: Sequence[torch.Tensor], halo: int
                   ) -> List[torch.Tensor]:
    """Extend each (B, Hloc, W) row block of one data shard with ``halo``
    rows from each spatial neighbour, on the block's own device: block i
    gets the last rows of block i-1 above it and the first rows of block
    i+1 below it. The end blocks get zeros there (the reference's
    ``ppermute`` semantics), i.e. the image simply ends — same as the
    unsharded image border."""
    n = len(blocks)
    if n == 1 or halo == 0:
        return list(blocks)
    out = []
    for i, x in enumerate(blocks):
        above = (blocks[i - 1][:, -halo:].to(x.device) if i > 0
                 else torch.zeros_like(x[:, -halo:]))
        below = (blocks[i + 1][:, :halo].to(x.device) if i < n - 1
                 else torch.zeros_like(x[:, :halo]))
        out.append(torch.cat([above, x, below], dim=1))
    return out


def _crop_halo(x: torch.Tensor, halo: int, n: int) -> torch.Tensor:
    """Drop the rows :func:`_exchange_halo` added to a block of a row
    split into ``n`` blocks."""
    if n == 1 or halo == 0:
        return x
    return x[:, halo:-halo]


def _data_shards(x, mesh: Mesh) -> List[torch.Tensor]:
    """(B, H, W) frames as one tensor per data shard on its device: a
    :class:`~i3dr_stereo_tpu_torch.dist.multihost.FrameBatch`'s shards, a
    list of shards as given, or an array split over the data axis."""
    n = mesh.shape[DATA_AXIS]
    shards = getattr(x, "shards", x)
    if isinstance(shards, (list, tuple)):
        if len(shards) != n:
            raise ValueError(f"{len(shards)} shards for {n} data shards")
        return list(shards)
    x = torch.as_tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} "
                         "data shards")
    b = x.shape[0] // n
    return [x[i * b:(i + 1) * b].to(mesh.devices[i][0]) for i in range(n)]


def make_sharded_matcher(cfg: MatcherConfig, mesh: Mesh, halo: int = 32
                         ) -> Callable[..., MatchResult]:
    """Build a (B, H, W) matcher sharded over the mesh.

    B must divide by mesh.shape[data], H by mesh.shape[spatial]. The
    matcher takes arrays or tensors (or a ``FrameBatch``, or a list of
    data shards) and returns one MatchResult on the mesh's first device.
    """
    cfg = cfg.sanitize()
    impl = MATCHER_REGISTRY[cfg.algorithm]
    ns = mesh.shape[SPATIAL_AXIS]

    def blocks(x: torch.Tensor, devices) -> List[torch.Tensor]:
        if x.shape[1] % ns:
            raise ValueError(f"height {x.shape[1]} does not divide over "
                             f"{ns} row blocks")
        h = x.shape[1] // ns
        return [x[:, j * h:(j + 1) * h].to(d) for j, d in enumerate(devices)]

    def matched(left, right) -> MatchResult:
        disp, valid = [], []
        for devices, l, r in zip(mesh.devices, _data_shards(left, mesh),
                                 _data_shards(right, mesh)):
            le = _exchange_halo(blocks(l, devices), halo)
            re_ = _exchange_halo(blocks(r, devices), halo)
            res = [impl(a, b, cfg) for a, b in zip(le, re_)]
            disp.append(torch.cat([_crop_halo(x.disparity, halo, ns)
                                   .to(mesh.first) for x in res], dim=1))
            valid.append(torch.cat([_crop_halo(x.valid, halo, ns)
                                    .to(mesh.first) for x in res], dim=1))
        return MatchResult(disparity=torch.cat(disp), valid=torch.cat(valid))

    return matched


def make_sharded_pipeline_step(rig, cfg: MatcherConfig, cloud, mesh: Mesh,
                               halo: int = 32):
    """Full step over the mesh: rectify (data-sharded, full rows) ->
    sharded match (data x spatial + halo) -> depth.

    Rectification gathers cross arbitrary rows (lens distortion), so it
    runs on each data shard's first device before the row split, with
    linear maps built once per device (``csrc/remap.cu``: both cameras
    in one launch). Returns the reference's six-key dict on the mesh's
    first device.
    """
    from i3dr_stereo_tpu_torch.ops.depth import disparity_to_depth
    from i3dr_stereo_tpu_torch.ops.rectify import (make_rectify_map,
                                                   rectify_pair)

    cfg = cfg.sanitize()
    match = make_sharded_matcher(cfg, mesh, halo)
    Q = torch.as_tensor(rig.Q, dtype=torch.float32, device=mesh.first)
    maps = {}

    def rectify(l, r, dev):
        if dev not in maps:
            maps[dev] = tuple(make_rectify_map(c, interpolation="linear",
                                               device=dev)
                              for c in (rig.left, rig.right))
        l, r = (x.to(dev) for x in (l, r))
        l, r = (x if x.dtype == torch.uint8 else x.float() for x in (l, r))
        return rectify_pair(l, r, *maps[dev])

    def step(left, right):
        rect = [rectify(l, r, row[0]) for row, l, r in zip(
            mesh.devices, _data_shards(left, mesh),
            _data_shards(right, mesh))]
        res = match([x[0] for x in rect], [x[1] for x in rect])
        depth, dvalid = disparity_to_depth(res.disparity, res.valid, Q,
                                           cloud.depth_min, cloud.depth_max)
        return {
            "rect_left": torch.cat([x[0].to(mesh.first) for x in rect]),
            "rect_right": torch.cat([x[1].to(mesh.first) for x in rect]),
            "disparity": res.disparity,
            "valid": res.valid,
            "depth": depth,
            "depth_valid": dvalid,
        }

    return step
