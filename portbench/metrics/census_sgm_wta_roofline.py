"""census_sgm_wta_roofline: the flagship SGM stage's share of its
roofline, in %. The stage is what ``ops/sgm_fused_t.py:census_sgm_wta``
computes at each pyramid level: from the two images' census words, the
residual-window cost volume, the path sums and the winner.

Its least time counts the stage's own inputs read once and its outputs
written once, at each level's padded shape (H, W) with D = 32 and NW
census words a pixel: the two word planes (2 * H * W * NW * 4 bytes) in,
the uint8 cost volume the backmatch reads (H * W * D) and the float32
disparity (H * W * 4) out; and its operations: a popcount a word and
disparity (H * W * D * NW) and an add and a minimum a disparity and path
(2 * H * W * D * paths). Bytes over 3.35 TB/s or operations over 67
TFLOP/s, whichever is larger (the reader prints which); nothing an
implementation passes between its kernels counts. Divided by the device
time, in the trace, of the kernels that compute the stage
(``census_cost_kernel``, ``sgm_sweep_kernel``)."""

import sys

from portbench.card import device_line
from portbench.peaks import least_seconds

KERNELS = ("census_cost_kernel", "sgm_sweep_kernel")
D = 32


def level_shapes(H: int, W: int, levels: int) -> list:
    out = []
    for _ in range(levels):
        out.append((-(-H // 128) * 128, -(-W // 128) * 128))
        H, W = H // 2, W // 2
    return out


def work(config: dict) -> tuple:
    """(bytes, operations) of one frame's stage, over every level."""
    m = config["matcher"]
    H, W = int(config["rig"]["height"]), int(config["rig"]["width"])
    n = max(1, int(m["max_pyramid_level"]))
    n = min(n, max(0, min(H, W).bit_length() - 6) + 1)
    NW = (int(m["census_width"]) * int(m["census_height"]) - 1 + 31) // 32
    paths = int(m["num_directions"])
    nbytes = nops = 0
    for h, w in level_shapes(H, W, n):
        nbytes += 2 * h * w * NW * 4 + h * w * D + h * w * 4
        nops += h * w * D * NW + 2 * h * w * D * paths
    return nbytes, nops


def read(run):
    t = run.trace
    if t is None:
        return None
    kernel_s = sum(e - s for s, e, n in t.device
                   if any(k in n for k in KERNELS)) * 1e-6
    if kernel_s <= 0:
        return None
    nbytes, nops = work(run.config)
    least, by = least_seconds(nbytes * t.frames, nops * t.frames)
    share = 100.0 * least / kernel_s
    print(f"census_sgm_wta_roofline {share} % ({by}-bound; least "
          f"{least * 1e3 / t.frames} ms a frame, kernels "
          f"{kernel_s * 1e3 / t.frames} ms a frame; {device_line()})",
          file=sys.stderr)
    return share
