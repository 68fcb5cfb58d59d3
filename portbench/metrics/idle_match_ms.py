"""idle_match_ms: device idle ms a frame inside the matcher: the idle
gaps of the traced window (``portbench.trace.gaps``) whose midpoint
falls inside a ``pipeline.match`` span of the program on a frame's
thread, the program's spans mapped onto the trace's clock, summed ÷ the
traced frames. Prints the whole idle time a frame split by the innermost
program span at each gap's midpoint on standard error."""

import sys

from portbench import spans
from portbench import trace as tr

OUTSIDE = "outside the program's spans"


def read(run):
    got, t = spans.frames(run, traced=True), run.trace
    if got is None or not t.device:
        return None
    mapped = spans.on_trace(run, got)
    if mapped is None:
        return None
    threads = {s.thread for s in got.named("node.frame")}
    # spans on one thread nest: one sweep with a stack of the open ones
    ev = sorted(((a, -b, s) for a, b, s in mapped if s.thread in threads),
                key=lambda x: (x[0], x[1]))
    split: dict = {}
    inside = 0.0
    stack, i = [], 0
    for gs, ge in tr.gaps(t, [t.window]):
        mid = 0.5 * (gs + ge)
        while i < len(ev) and ev[i][0] <= mid:
            stack.append((-ev[i][1], ev[i][2].name))
            i += 1
        stack = [x for x in stack if x[0] > mid]
        name = stack[-1][1] if stack else OUTSIDE
        split[name] = split.get(name, 0.0) + (ge - gs)
        if any(n == "pipeline.match" for _, n in stack):
            inside += ge - gs
    run.log("idle a frame by program span: " + ", ".join(
        f"{k} {v * 1e-3 / got.frames:.3f} ms"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1])),
        file=sys.stderr)
    return inside * 1e-3 / got.frames
