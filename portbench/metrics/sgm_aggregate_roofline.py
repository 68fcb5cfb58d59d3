"""sgm_aggregate_roofline: the share of its roofline, in %, of SGBM's
path aggregation, ``ops/sgm.py:sgm_aggregate``: the sum over the paths
of the SGM path costs of the (H, W, D) float32 cost volume.

Its least time counts its own input read once and its output written
once: the float32 volume in and the float32 sum out (2 * H * W * D * 4
bytes, at the volume's padded shape: H and W to multiples of 8, D to 128,
as the stage pads it), and an add and a minimum a disparity and path
(2 * H * W * D * paths operations). Bytes over 3.35 TB/s or operations
over 67 TFLOP/s, whichever is larger (the reader prints which); the
per-path planes an implementation writes between its launches do not
count. Divided by the device time, in the trace, of the kernel that
computes it (``sgm_volume_kernel``)."""

import sys

from portbench.card import device_line
from portbench.peaks import least_seconds

KERNELS = ("sgm_volume_kernel",)


def work(config: dict) -> tuple:
    m = config["matcher"]
    H, W = int(config["rig"]["height"]), int(config["rig"]["width"])
    H, W = -(-H // 8) * 8, -(-W // 8) * 8
    D = -(-int(m["disparity_range"]) // 128) * 128
    paths = int(m["num_directions"])
    return 2 * H * W * D * 4, 2 * H * W * D * paths


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
    print(f"sgm_aggregate_roofline {share} % ({by}-bound; least "
          f"{least * 1e3 / t.frames} ms a frame, kernel "
          f"{kernel_s * 1e3 / t.frames} ms a frame; {device_line()})",
          file=sys.stderr)
    return share
