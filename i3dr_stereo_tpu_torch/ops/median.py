"""3x3 median filters (torch port of ``i3dr_stereo_tpu.ops.median``):
the engine's "Disparity Median Optimizer" (ini/quick.param:89-90) and the
between-level hole fill of the pyramid.

Median-of-9 as Paeth's 19-exchange min/max network over nine shifted
views — min and max are exact, so the result equals the reference bit
for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifts9(p: torch.Tensor, H: int, W: int) -> list[torch.Tensor]:
    """Nine shifted (…, H, W) views of a 1-pixel-padded (…, H+2, W+2)."""
    return [p[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]


def _pad1(x: torch.Tensor, mode: str, value: float = 0.0) -> torch.Tensor:
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    if mode == "replicate":
        p = F.pad(x4, (1, 1, 1, 1), mode="replicate")
    else:
        p = F.pad(x4, (1, 1, 1, 1), mode="constant", value=value)
    return p.reshape(lead + p.shape[-2:])


def _median9(v: list[torch.Tensor]) -> torch.Tensor:
    v = list(v)

    def op(i, j):
        a, b = v[i], v[j]
        v[i] = torch.minimum(a, b)
        v[j] = torch.maximum(a, b)

    op(1, 2); op(4, 5); op(7, 8)
    op(0, 1); op(3, 4); op(6, 7)
    op(1, 2); op(4, 5); op(7, 8)
    op(0, 3); op(5, 8); op(4, 7)
    op(3, 6); op(1, 4); op(2, 5)
    op(4, 7); op(4, 2); op(6, 4)
    op(4, 2)
    return v[4]


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """(…, H, W) -> same shape, 3x3 median with edge-replicated borders."""
    H, W = x.shape[-2:]
    return _median9(_shifts9(_pad1(x, "replicate"), H, W))


def median3x3_masked(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median that ignores invalid samples ("Nodata Policy = Ignore"):
    invalid or out-of-image neighbours take the centre value first."""
    H, W = x.shape[-2:]
    x = x.to(torch.float32)
    c = torch.where(valid, x, torch.nan)
    nbs = _shifts9(_pad1(c, "constant", torch.nan), H, W)
    return _median9([torch.where(torch.isnan(nb), x, nb) for nb in nbs])
