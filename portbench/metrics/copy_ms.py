"""copy_ms: host ms a frame in the graph node's copies of its outputs to
host numpy, the program's ``node.copy`` spans (each ``to_numpy`` of
``bridge/nodes.py:GenerateDisparityNode._process``), mean over the
window's frames after the traced ones (the profiler off)."""

from portbench import spans


def read(run):
    got = spans.frames(run, traced=False)
    return None if got is None else got.ms("node.copy")
