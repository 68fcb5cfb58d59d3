"""Directional Gauss gap interpolator (torch port of
``i3dr_stereo_tpu.ops.gauss_interp``): the engine's "Interpolator Mode =
Gauss" with "Interpolator Number Of Directions = 32" (quick.param:111-117).
Each invalid pixel is filled from the nearest valid disparity along N
rays, blended with Gaussian distance weights.

The nearest valid pixel along a ray is found by the reference's distance
doubling: ``ceil(log2(max_radius))`` rounds, round r moving the state
(value, distance) of p + o_r onto p when its distance plus |o_r| is
strictly smaller, o_r = (round(sin a * 2^r), round(cos a * 2^r)) (Python's
round, half to even). It is not an exact ray walk; both functions here
compute exactly what the reference computes.

- :func:`gauss_interpolate` launches the ``gauss_rays`` kernel
  (``csrc/gauss_rays.cu``: one launch for all directions, each hole's
  doubling evaluated as the recursion it unrolls into, its last two
  levels' leaves gathered at once) for a CUDA tensor, and runs
  :func:`gauss_interpolate_plain` for a CPU tensor or with
  ``plain=True``.
- :func:`gauss_interpolate_plain` is a line-for-line port of the
  reference's rounds: about 10 launches a round, 192 rounds at 32
  directions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.ops.wls import div_const

BIG = 1.0e9
KERNEL_ROUNDS = 6   # the kernel's one instance: 32 < max_radius <= 64,
                    # the radius every caller in the package passes


def _rounds(max_radius: int) -> int:
    return max(1, math.ceil(math.log2(max(max_radius, 2))))


def ray_offsets(n_directions: int, max_radius: int) -> list:
    """The doubling's (dy, dx) offsets: one list a direction, one entry a
    round, (0, 0) where the reference skips the round."""
    out = []
    for k in range(n_directions):
        ang = 2.0 * math.pi * k / n_directions
        uy, ux = math.sin(ang), math.cos(ang)
        out.append([(int(round(uy * 2.0 ** r)), int(round(ux * 2.0 ** r)))
                    for r in range(_rounds(max_radius))])
    return out


@functools.cache
def _ray_table(n_directions: int, max_radius: int,
               device: torch.device) -> torch.Tensor:
    """The kernel's table on ``device``: a row a direction, each round's
    (dy, dx) as int32 words, then each round's length |o_r| in float32
    (the reference adds that Python float, rounded to float32)."""
    offsets = ray_offsets(n_directions, max_radius)
    steps = torch.tensor([[c for o in dirs for c in o] for dirs in offsets],
                         dtype=torch.int32)
    lengths = torch.tensor([[math.hypot(*o) for o in dirs]
                            for dirs in offsets], dtype=torch.float32)
    return torch.cat([steps.view(torch.float32), lengths], 1).to(device)


def _shift_with_fill(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[p] = x[p + (dy, dx)], ``fill`` where p + (dy, dx) leaves the
    image."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, ye = max(-dy, 0), H - max(dy, 0)
    xs, xe = max(-dx, 0), W - max(dx, 0)
    if ys < ye and xs < xe:
        out[..., ys:ye, xs:xe] = x[..., ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def _check(d: torch.Tensor, v: torch.Tensor) -> None:
    if d.ndim != 3 or v.shape != d.shape or v.dtype != torch.bool:
        raise ValueError(f"expected (B, H, W) disparities and a bool mask "
                         f"of that shape, got {tuple(d.shape)} / "
                         f"{tuple(v.shape)} {v.dtype}")


def gauss_interpolate_plain(disp: torch.Tensor, valid: torch.Tensor, *,
                            n_directions: int = 32, max_radius: int = 64,
                            sigma: float = 16.0, min_elements: int = 0):
    """Plain torch twin of the ``gauss_rays`` kernel: the reference's
    rounds, op for op. (B, H, W) or (H, W) -> (filled, new_valid)."""
    batched = disp.ndim == 3
    d = (disp if batched else disp[None]).to(torch.float32)
    v = valid if batched else valid[None]
    _check(d, v)
    wsum = torch.zeros_like(d)
    vsum = torch.zeros_like(d)
    nrays = torch.zeros_like(d)
    for offsets in ray_offsets(n_directions, max_radius):
        val = torch.where(v, d, 0.0)
        dst = torch.where(v, 0.0, BIG)
        for dy, dx in offsets:
            if dy or dx:
                sl = math.hypot(dy, dx)
                v2 = _shift_with_fill(val, dy, dx, 0.0)
                d2 = _shift_with_fill(dst, dy, dx, BIG) + sl
                take = d2 < dst
                val = torch.where(take, v2, val)
                dst = torch.where(take, d2, dst)
        hit = dst < min(max_radius, BIG / 2)
        w = torch.where(hit, torch.exp(div_const(-(dst * dst),
                                                   2.0 * sigma * sigma)), 0.0)
        wsum = wsum + w
        vsum = vsum + w * val
        nrays = nrays + hit.to(torch.float32)
    filled = torch.where(wsum > 0, vsum / torch.clamp(wsum, min=1e-20), 0.0)
    # wsum can underflow to 0 when every hit sits many sigma away: a
    # "filled" 0.0 must not be marked valid
    ok_fill = (nrays >= max(min_elements, 1)) & (wsum > 0)
    out = torch.where(v, d, filled)
    new_valid = v | ok_fill
    if not batched:
        out, new_valid = out[0], new_valid[0]
    return out, new_valid


def _gauss_kernel(d: torch.Tensor, v: torch.Tensor, n_directions: int,
                  max_radius: int, sigma: float, min_elements: int):
    """One launch of the ``gauss_rays`` kernel on (B, H, W) float32
    disparities and a bool mask on the card."""
    _check(d, v)
    rounds = _rounds(max_radius)
    if rounds != KERNEL_ROUNDS:
        raise ValueError(f"gauss_rays is built for {KERNEL_ROUNDS} doubling "
                         f"rounds ({2 ** (KERNEL_ROUNDS - 1)} < max_radius <= "
                         f"{2 ** KERNEL_ROUNDS}), got max_radius={max_radius}; "
                         f"plain=True runs any radius")
    _build.require_cuda(d, v)
    B, H, W = d.shape
    table = _ray_table(n_directions, max_radius, d.device)
    out = torch.empty_like(d)
    new_valid = torch.empty_like(v)
    _build.launch("i3dr_gauss_rays", "gauss_rays", d.device, d.data_ptr(),
                  v.data_ptr(), table.data_ptr(), out.data_ptr(),
                  new_valid.data_ptr(), B, H, W, n_directions, rounds,
                  float(min(max_radius, BIG / 2)),
                  float(np.float32(1.0) / np.float32(2.0 * sigma * sigma)),
                  float(max(min_elements, 1)), _build.stream_of(d))
    return out, new_valid


def gauss_interpolate(disp: torch.Tensor, valid: torch.Tensor, *,
                      n_directions: int = 32, max_radius: int = 64,
                      sigma: float = 16.0, min_elements: int = 0,
                      plain: bool = False):
    """Fill invalid pixels of (B, H, W) or (H, W) disparities from
    N-ray nearest-valid Gaussian blending. Returns (filled, new_valid):
    valid pixels pass through; a hole becomes valid when at least
    ``max(min_elements, 1)`` rays found support within ``max_radius`` px
    and its weights did not underflow. A CPU tensor, or ``plain=True``,
    runs the twin (any radius); a CUDA tensor launches the kernel (32 <
    max_radius <= 64) or raises."""
    kw = dict(n_directions=n_directions, max_radius=max_radius, sigma=sigma,
              min_elements=min_elements)
    if plain or disp.device.type == "cpu":
        return gauss_interpolate_plain(disp, valid, **kw)
    batched = disp.ndim == 3
    d = (disp if batched else disp[None]).to(torch.float32).contiguous()
    v = (valid if batched else valid[None]).contiguous()
    out, new_valid = _gauss_kernel(d, v, **kw)
    if not batched:
        out, new_valid = out[0], new_valid[0]
    return out, new_valid
