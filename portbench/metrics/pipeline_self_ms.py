"""pipeline_self_ms: host ms a frame in ``StereoPipeline.process`` but
not in its matcher: the program's ``pipeline.process`` span less its
``pipeline.match`` child (upload, rectify, depth clamp, depth and cloud,
with their waits at host syncs), mean over the window's frames after the
traced ones (the profiler off). Prints each stage's ms on standard
error."""

import sys

from portbench import spans

STAGES = ("upload", "rectify", "clamp", "depth", "cloud")


def read(run):
    got = spans.frames(run, traced=False)
    if got is None:
        return None
    proc = {s.id for s in got.named("pipeline.process")}
    match = sum(s.end_ns - s.start_ns for s in got.named("pipeline.match")
                if s.parent in proc) * 1e-6 / got.frames
    run.log("pipeline_self_ms by stage: " + ", ".join(
        f"{k} {got.ms('pipeline.' + k):.3f} ms" for k in STAGES)
        + f"; upload {got.total('pipeline.upload', 'bytes') * 1e-6:.3f}"
        " MB a frame", file=sys.stderr)
    return got.ms("pipeline.process") - match
