"""bp_glue_ms: device ms a frame, over the traced frames, of everything
but dense BP's message updates and the copies: the device activities
whose names hold neither ``bp_messages`` nor begin ``Memcpy``. That is
BP's plain torch (``matchers/bp.py``: the data cost, the pooling, the
message upsampling, the belief and the WTA) and the graph's other device
work (rectification, the depth clamp, depth and the cloud), so it holds
more than the BP matcher's layer. A trace without a ``bp_messages``
kernel reads nothing."""

KERNELS = ("bp_messages",)
COPIES = "Memcpy"


def read(run):
    t = run.trace
    if t is None or not t.frames or not any(
            k in n for _, _, n in t.device for k in KERNELS):
        return None
    glue_us = sum(e - s for s, e, n in t.device
                  if not n.startswith(COPIES)
                  and not any(k in n for k in KERNELS))
    return glue_us * 1e-3 / t.frames
