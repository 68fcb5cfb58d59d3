"""match_ms: host ms a frame in the matcher, the program's
``pipeline.match`` span (the ``MATCHER_REGISTRY`` call of
``StereoPipeline.process``), mean over the window's frames after the
traced ones (the profiler off). Prints the ms a frame of each of the
pyramid's passes (``pyramid.level``) on standard error."""

import sys

from portbench import spans


def read(run):
    got = spans.frames(run, traced=False)
    if got is None:
        return None
    passes: dict = {}
    by_frame: dict = {}
    for s in got.named("pyramid.level"):
        by_frame.setdefault(s.frame, []).append(s)
    for levels in by_frame.values():
        for i, s in enumerate(sorted(levels, key=lambda s: s.start_ns)):
            key = (i, s.attrs.get("level"))
            passes[key] = passes.get(key, 0) + (s.end_ns - s.start_ns)
    if passes:
        run.log("match_ms by pass: " + ", ".join(
            f"pass {i} (level {lv}) {ns * 1e-6 / got.frames:.3f} ms"
            for (i, lv), ns in sorted(passes.items())), file=sys.stderr)
    return got.ms("pipeline.match")
