"""bp_planes_roofline: the share of its roofline, in %, of CSBP's plane
updates, ``matchers/bp.py:bp_iterate_planes``: one launch of the
``bp_planes`` kernel an iteration at every level of the image pyramid
finer than the coarsest (the coarsest runs dense BP), the four
directions' messages on K candidate planes of every pixel from the
previous ones.

Its least time counts, an iteration, the data costs and the candidates
read once, the four incoming message planes read once and the four new
ones written once ((2 + 8) x 4 bytes an element), and the kernel
header's operations (``csrc/bp_planes.cu``): a pixel's 4 K^2 (add, min)
pairs and K^2 smoothness terms (sub, abs, mul, min), 12 K^2 a pixel; the
elements are K times the pixels of each finer level as
``_constant_space_match`` builds the pyramid (2x2 means cropped to even
sizes, a level added while the smaller side is at least 16 px, at most 4
levels), times the iterations. Bytes over 3.35 TB/s or operations over
67 TFLOP/s, whichever is larger (the reader prints which). Divided by the
device time, in the trace, of the kernels whose names hold
``bp_planes``; a program without them reads nothing."""

import sys

from portbench.card import device_line
from portbench.peaks import least_seconds

KERNELS = ("bp_planes",)
LEVELS_MAX = 4
MIN_SIDE = 16
BYTES_PER_ELEMENT = (2 + 8) * 4
OPS_PER_PIXEL_PER_K2 = 4 * 2 + 4


def planes(config: dict) -> int:
    m = config["matcher"]
    return max(2, min(int(m["csbp_planes"]), int(m["disparity_range"])))


def level_shapes(config: dict) -> list:
    """(H, W) of each level of the image pyramid, finest first."""
    m = config["matcher"]
    shapes = [(int(config["rig"]["height"]), int(config["rig"]["width"]))]
    for _ in range(max(1, min(int(m["bp_levels"]), LEVELS_MAX)) - 1):
        if min(shapes[-1]) < MIN_SIDE:
            break
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    return shapes


def work(config: dict) -> tuple:
    """(bytes, operations) of a frame's plane updates: every level but
    the coarsest."""
    K = planes(config)
    iters = max(1, int(config["matcher"]["bp_iters"]))
    pixels = sum(h * w for h, w in level_shapes(config)[:-1]) * iters
    return BYTES_PER_ELEMENT * K * pixels, OPS_PER_PIXEL_PER_K2 * K * K * pixels


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
    print(f"bp_planes_roofline {share} % ({by}-bound; least "
          f"{least * 1e3 / t.frames} ms a frame, kernel "
          f"{kernel_s * 1e3 / t.frames} ms a frame; {device_line()})",
          file=sys.stderr)
    return share
