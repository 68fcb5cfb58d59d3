"""The program's own spans (``i3dr_stereo_tpu_torch.utils.metrics``)
of a traced run's frames, for the per-layer readers that read them.

The program starts recording spans when the run's profiler starts, each
with the ``stamp`` of its frame (``node.frame``, its root), and goes on
after the profiler stops. :func:`frames` takes those of the window's
frames, by stamp, begun after the harness published the frame (a stamp
repeats from run to run in one process): the traced frames, or the rest
of the window, which the profiler no longer records. :func:`on_trace` maps
spans onto the profiler's clock through the anchors the program leaves
in the trace. A program without the tracer gives neither: the readers
then return None."""

from __future__ import annotations


class Frames:
    """The spans of ``frames`` frames."""

    def __init__(self, spans: list, frames: int):
        self.spans, self.frames = spans, frames

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def ms(self, name: str) -> float:
        """Host ms a frame inside the spans ``name``."""
        return sum(s.end_ns - s.start_ns
                   for s in self.named(name)) * 1e-6 / self.frames

    def total(self, name: str, attr: str) -> float:
        """The attribute ``attr`` of the spans ``name``, summed, a frame."""
        return sum(s.attrs.get(attr, 0)
                   for s in self.named(name)) / self.frames


def _metrics():
    try:
        from i3dr_stereo_tpu_torch.utils import metrics
    except ImportError:
        return None
    return metrics if hasattr(metrics, "trace_clock") else None


def frames(run, traced: bool):
    """The program's spans of the run's traced frames (``traced``) or of
    the rest of its window, or None."""
    t, metrics = run.trace, _metrics()
    if t is None or not t.frames or metrics is None:
        return None
    chosen = run.frames[:t.frames] if traced else run.frames[t.frames:]
    pub = {f.stamp: f.t_pub * 1e9 for f in chosen if f.t_pub is not None}
    spans = [s for s in metrics.GLOBAL_METRICS.spans()
             if s.frame in pub and s.start_ns >= pub[s.frame]]
    n = sum(1 for s in spans if s.name == "node.frame")
    return Frames(spans, n) if n else None


def on_trace(run, frames: Frames):
    """``(start_us, end_us, span)`` of each span on the trace's clock, or
    None where the trace holds no anchor."""
    to_us = _metrics().trace_clock((n, s, e, th)
                                   for s, e, n, th in run.trace.cpu)
    if to_us is None:
        return None
    return [(to_us(s.start_ns), to_us(s.end_ns), s) for s in frames.spans]
