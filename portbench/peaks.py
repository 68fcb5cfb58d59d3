"""The card's published peaks and the least time of a piece of work
(``chip_smoke.py:set_bound``'s rule): every input byte read once and
every output byte written once over the memory rate, or its operations
over the float32 rate, whichever is larger.

NVIDIA's data sheet for one H100 SXM at its 700 W limit: 3.35 TB/s of
HBM3 and 67 TFLOP/s in float32 outside the tensor cores. A card set below
700 W runs slower under load; the readers print its limit beside each
share."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def least_seconds(nbytes: float, nops: float) -> tuple:
    """(seconds, "bytes" or "operations"): the least time the card could
    take for ``nbytes`` moved and ``nops`` operations, and which bounds."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, nops / PEAK_OPS_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
