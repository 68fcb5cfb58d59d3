"""publish_ms: host ms a frame from the return of the node's
``StereoPipeline.process`` to the arrival of its last output topic: the
node's copies of every output to host numpy and its publishing
(``bridge/nodes.py:GenerateDisparityNode._process``), mean over the
window's delivered frames. The harness's own span, by the host clock."""

from portbench.load import mean_ms


def read(run):
    return mean_ms(run.frames, "t_proc1", "t_done")
