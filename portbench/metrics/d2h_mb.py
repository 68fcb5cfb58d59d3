"""d2h_mb: MB a frame that the graph node copies to the host, the
``bytes`` counted on its ``node.copy`` spans (the ``nbytes`` of each
output array it publishes), summed over a frame ÷ 1e6, mean over the
window's frames after the traced ones."""

from portbench import spans


def read(run):
    got = spans.frames(run, traced=False)
    return None if got is None else got.total("node.copy", "bytes") * 1e-6
