"""dispatch_ms: host ms a frame inside ``StereoPipeline.process``
(``pipeline/stereo_pipeline.py``), its waits at host syncs included,
mean over the window's delivered frames: a span the harness wraps around
the node's pipeline object (the port unedited), by the host clock."""

from portbench.load import mean_ms


def read(run):
    return mean_ms(run.frames, "t_proc0", "t_proc1")
