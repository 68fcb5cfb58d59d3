"""csbp_glue_ms: device ms a frame, over the traced frames, of everything
but CSBP's message updates and the copies: the device activities whose
names hold neither ``bp_planes`` nor ``bp_messages`` and do not begin
``Memcpy``. That is CSBP's plain torch (``matchers/bp.py:
_constant_space_match``: the image pyramid, the coarse data cost and
belief, the sort and the gathers, the upsampling, the plane costs, the
final belief and argmin) and the graph's other device work
(rectification, the speckle filter, the depth clamp, depth and the
cloud), so it holds more than the CSBP matcher's layer. A trace without
a ``bp_planes`` kernel reads nothing."""

KERNELS = ("bp_planes", "bp_messages")
COPIES = "Memcpy"


def read(run):
    t = run.trace
    if t is None or not t.frames or not any(
            KERNELS[0] in n for _, _, n in t.device):
        return None
    glue_us = sum(e - s for s, e, n in t.device
                  if not n.startswith(COPIES)
                  and not any(k in n for k in KERNELS))
    return glue_us * 1e-3 / t.frames
