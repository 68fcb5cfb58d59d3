"""sgbm_cost_roofline: the share of its roofline, in %, of SGBM's cost
stage, ``ops/cost.py:bt_box_cost_volume``: the Birchfield-Tomasi pixel
cost of the two prefiltered images and its box sum over the correlation
window, the aggregated (H, W, D) float32 volume that SGM reads.

Its least time counts its own input read once and its output written
once: the two prefiltered (H, W) float32 images in and the volume out at
its exact shape (2 * H * W * 4 + H * W * D * 4 bytes), and 9 operations
for the cost plus 2 * (window - 1) adds an element
((9 + 2 * (window - 1)) * H * W * D). Bytes over 3.35 TB/s or operations
over 67 TFLOP/s, whichever is larger (the reader prints which). Divided
by the device time, in the trace, of the kernels that compute it (names
holding ``bt_box_cost_kernel``: the one pass, or at windows of 19 and
wider its two, ``_cols`` and ``_rows``); a program without them reads
nothing."""

import sys

from portbench.card import device_line
from portbench.peaks import least_seconds

KERNELS = ("bt_box_cost_kernel",)


def work(config: dict) -> tuple:
    m = config["matcher"]
    H, W = int(config["rig"]["height"]), int(config["rig"]["width"])
    n = H * W * int(m["disparity_range"])
    window = max(int(m["window_size"]), 1)
    return 2 * H * W * 4 + 4 * n, (9 + 2 * (window - 1)) * n


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
    print(f"sgbm_cost_roofline {share} % ({by}-bound; least "
          f"{least * 1e3 / t.frames} ms a frame, kernel "
          f"{kernel_s * 1e3 / t.frames} ms a frame; {device_line()})",
          file=sys.stderr)
    return share
