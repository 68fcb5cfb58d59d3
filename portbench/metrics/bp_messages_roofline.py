"""bp_messages_roofline: the share of its roofline, in %, of dense BP's
message updates, ``matchers/bp.py:bp_iterate``: one launch of the
``bp_messages`` kernel an iteration at every level of the cost pyramid,
the four directions' messages of every pixel from the previous ones.

Its least time counts, an iteration, the data volume and the four
incoming message planes read once and the four new ones written once (9
x 4 bytes an element), and ~30 operations an element (the two min-scans,
the cap, the sums and the mean, as ``chip_smoke.py:phase_bp`` counts
them); the elements are D times the pixels of each level as the pyramid
crops it (2x2 sum pooling of even sizes, while the smaller side is at
least 8 px, at most 5 levels), times the iterations. Bytes over 3.35 TB/s
or operations over 67 TFLOP/s, whichever is larger (the reader prints
which). Divided by the device time, in the trace, of the kernels whose
names hold ``bp_messages`` (the strip kernel and the staged one); a
program without them reads nothing."""

import sys

from portbench.card import device_line
from portbench.peaks import least_seconds

KERNELS = ("bp_messages",)
LEVELS_MAX = 5
BYTES_PER_ELEMENT = 9 * 4
OPS_PER_ELEMENT = 30


def level_shapes(config: dict) -> list:
    """(H, W) of each level of the cost pyramid, finest first."""
    m = config["matcher"]
    shapes = [(int(config["rig"]["height"]), int(config["rig"]["width"]))]
    for _ in range(max(1, min(int(m["bp_levels"]), LEVELS_MAX)) - 1):
        if min(shapes[-1]) < 8:
            break
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    return shapes


def work(config: dict) -> tuple:
    """(bytes, operations) of a frame's message updates."""
    m = config["matcher"]
    n = int(m["disparity_range"]) * sum(h * w for h, w in level_shapes(config))
    n *= max(1, int(m["bp_iters"]))
    return BYTES_PER_ELEMENT * n, OPS_PER_ELEMENT * n


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
    print(f"bp_messages_roofline {share} % ({by}-bound; least "
          f"{least * 1e3 / t.frames} ms a frame, kernel "
          f"{kernel_s * 1e3 / t.frames} ms a frame; {device_line()})",
          file=sys.stderr)
    return share
