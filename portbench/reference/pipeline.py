"""What the stereo_matcher graph publishes for one raw pair, in plain
torch: rectify both raw images, match, clamp the disparities to the depth
range, then depth and the point cloud (the port's
``pipeline/stereo_pipeline.py`` and ``ops/depth.py``)."""

from __future__ import annotations

import importlib

import torch

from portbench.reference import rectify

MISSING_Z = 10000.0


class Reference:
    """The maps and Q of a configuration's rig, worked out once, and
    :meth:`frame` for each raw pair. ``dtype`` is the precision of the
    stages the configuration states in float32 (the remap's sums, the
    subpixel step, depth and the cloud); the control passes bfloat16."""

    def __init__(self, config: dict, device, dtype=torch.float32):
        self.cfg = config
        self.device = torch.device(device)
        self.dtype = dtype
        left, right = rectify.cameras(config["rig"])
        self.maps = (rectify.rectify_map(left, self.device),
                     rectify.rectify_map(right, self.device))
        self.Q = torch.as_tensor(rectify.calc_q(left, right),
                                 dtype=torch.float32, device=self.device)
        fx = left["P"][0, 0]
        baseline = -right["P"][0, 3] / right["P"][0, 0]
        self.fx_b = fx * baseline
        self.matcher = importlib.import_module(
            f"portbench.reference.matchers.{config['matcher']['algorithm']}")

    def _scalar(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def frame(self, raw_left, raw_right) -> dict:
        """Two raw (H, W) uint8 images (numpy or tensors) -> the graph's
        outputs: ``rect_left``, ``rect_right``, ``disparity``, ``valid``,
        ``depth``, ``xyz``, ``cloud_valid``, ``rgb``, as tensors."""
        dt = self.dtype
        l = rectify.remap(torch.as_tensor(raw_left, device=self.device),
                          self.maps[0], dt)
        r = rectify.remap(torch.as_tensor(raw_right, device=self.device),
                          self.maps[1], dt)
        disp, valid = self.matcher.match(l[None], r[None],
                                         self.cfg["matcher"], dt)
        disp, valid = disp[0], valid[0]
        cloud = self.cfg["cloud"]
        depth_min = self._scalar(cloud["depth_min"])
        depth_max = self._scalar(cloud["depth_max"])
        fx_t = self._scalar(self.fx_b)
        lo = fx_t / torch.where(depth_max > 0, depth_max, torch.inf)
        valid = valid & ((depth_max <= 0) | (disp >= lo))
        hi = fx_t / torch.clamp(depth_min, min=1e-6)
        valid = valid & ((depth_min <= 0) | (disp <= hi))

        Q = self.Q.to(dt)
        q03, q13, q23, q32, q33 = Q[0, 3], Q[1, 3], Q[2, 3], Q[3, 2], Q[3, 3]
        d = disp.to(dt)
        w = q32 * d + q33
        ok = valid & (disp != 0.0) & (disp.abs() < MISSING_Z) & (w > 0.0)
        wsafe = torch.where(w == 0, 1.0, w).to(dt)
        z = torch.where(ok, q23 / wsafe, 0.0).to(dt)
        okz = ok & (z >= depth_min.to(dt)) & (z <= depth_max.to(dt))
        depth = torch.where(okz, z, 0.0).to(torch.float32)

        H, W = disp.shape
        ys = torch.arange(H, dtype=dt, device=self.device)[:, None]
        xs = torch.arange(W, dtype=dt, device=self.device)[None, :]
        X = (xs + q03) / wsafe
        Y = (ys + q13) / wsafe
        Z = q23 / wsafe
        okc = ok & (Z >= depth_min.to(dt)) & (Z <= depth_max.to(dt))
        xyz = torch.stack([X, Y, Z], dim=-1).reshape(H * W, 3) \
            .to(torch.float32)
        rgb = torch.stack([l] * 3, dim=-1).reshape(H * W, 3)
        return dict(rect_left=l, rect_right=r, disparity=disp, valid=valid,
                    depth=depth, xyz=xyz, cloud_valid=okc.reshape(H * W),
                    rgb=rgb)
