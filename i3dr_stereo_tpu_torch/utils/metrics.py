"""Observability: counters, stage latency histograms, FPS, and the
program's spans.

The reference has none of this — ROS_INFO prints and commented-out
timing probes only (SURVEY.md §5). This module provides the metrics
surface a production deployment needs, plus a profiler hook for device
traces (torch port of ``i3dr_stereo_tpu.utils.metrics``; the trace is
``torch.profiler``'s).

Spans. ``Metrics.span(name, **attrs)`` times one stretch of host work on
``time.perf_counter_ns``, with its parent (the enclosing span on the same
thread), the ``stamp`` its root span carries and counts such as
``bytes=`` as attributes. It starts recording when a PyTorch profiler
runs in the process, and goes on after the profiler stops, so that the
frames after a trace are timed without the profiler recording them on the
host; :meth:`Metrics.clear` stops it until the next profiler. Before
that, a span is a shared no-op context after one flag check. Spans are
not profiler ranges, so they add no row to a device trace. At the start
and the end of each root span under a profiler the tracer leaves an
anchor in the profiler's trace: an empty ``record_function``
range that holds a clock reading, then one named after it
(:data:`CLOCK`); :func:`trace_clock` finds the anchors among a trace's
host events and maps span times onto the trace's microseconds, which is
how :func:`device_trace` writes the spans into its ``trace.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import random
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

SPAN_BUFFER = 65536      # the newest spans a registry keeps
RESERVOIR = 4096         # the samples a histogram keeps for percentiles
CLOCK = "metrics.clock@"  # the anchors: this, then this + perf_counter_ns


@dataclasses.dataclass
class _Hist:
    """Latency histogram: count, sum, min and max of every sample, and
    exact percentiles of a uniform reservoir of at most ``RESERVOIR`` of
    them (all of them up to that many)."""

    total: float = 0.0
    n: int = 0
    vmin: float = math.inf
    vmax: float = 0.0
    samples: list = dataclasses.field(default_factory=list)
    _rng: random.Random = dataclasses.field(
        default_factory=lambda: random.Random(0), repr=False)

    def add(self, seconds: float) -> None:
        self.n += 1
        self.total += seconds
        self.vmin = min(self.vmin, seconds)
        self.vmax = max(self.vmax, seconds)
        if len(self.samples) < RESERVOIR:
            self.samples.append(seconds)
        else:
            j = self._rng.randrange(self.n)
            if j < RESERVOIR:
                self.samples[j] = seconds

    def percentile(self, q: float) -> float:
        """The ``q`` quantile (0..1) of the kept samples, linearly
        interpolated between the two nearest ranks."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        x = q * (len(s) - 1)
        i = min(int(x), len(s) - 1)
        j = min(i + 1, len(s) - 1)
        return s[i] + (s[j] - s[i]) * (x - i)

    def summary(self) -> dict:
        return {
            "count": self.n,
            "mean_ms": (self.total / self.n * 1e3) if self.n else 0.0,
            "min_ms": 0.0 if self.n == 0 else self.vmin * 1e3,
            "max_ms": self.vmax * 1e3,
            "p50_ms": self.percentile(0.5) * 1e3,
            "p95_ms": self.percentile(0.95) * 1e3,
        }


class Span(NamedTuple):
    """One recorded span. ``parent`` is the ``id`` of the span that
    enclosed it on its thread; ``frame`` the ``stamp`` of its root."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    frame: object
    thread: int
    attrs: dict
    id: int


class _Off:
    """The span handed out while no profiler runs: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _anchor() -> None:
    """A point both clocks know: an empty profiler range named
    :data:`CLOCK` with a clock reading taken inside it, then a range
    named after the reading."""
    with torch.profiler.record_function(CLOCK):
        ns = time.perf_counter_ns()
    with torch.profiler.record_function(f"{CLOCK}{ns}"):
        pass


class _Recording:
    """A span being recorded."""

    __slots__ = ("metrics", "name", "attrs", "id", "parent", "frame",
                 "start")

    def __init__(self, metrics: "Metrics", name: str, attrs: dict):
        self.metrics, self.name, self.attrs = metrics, name, attrs

    def set(self, **attrs) -> None:
        """Add attributes (counts known only inside the span)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self.metrics._stack()
        if stack:
            self.parent, self.frame = stack[-1].id, stack[-1].frame
        else:
            self.parent, self.frame = None, self.attrs.get("stamp")
            if _profiler._is_profiler_enabled:
                _anchor()
        self.id = next(self.metrics._ids)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = self.metrics._stack()
        stack.pop()
        self.metrics._spans.append(Span(
            self.name, self.start, end, self.parent, self.frame,
            threading.get_ident(), self.attrs, self.id))
        if not stack and _profiler._is_profiler_enabled:
            _anchor()
        return False


class Metrics:
    """Process-wide registry: counters, stage latency histograms and the
    newest ``SPAN_BUFFER`` spans."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.stages: Dict[str, _Hist] = defaultdict(_Hist)
        self._spans: deque = deque(maxlen=SPAN_BUFFER)
        self._ids = itertools.count()
        self._local = threading.local()
        self._on = False         # a profiler has run since the last clear

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def observe(self, stage: str, seconds: float) -> None:
        self.stages[stage].add(seconds)

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(stage, time.perf_counter() - t0)

    # -- spans ----------------------------------------------------------------
    def span(self, name: str, **attrs):
        """A context manager that records the span ``name`` once a
        PyTorch profiler has run (since the last :meth:`clear`), and does
        nothing before. Its ``set`` adds attributes from inside it."""
        if _profiler._is_profiler_enabled:
            self._on = True
        elif not self._on:
            return _OFF
        return _Recording(self, name, attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def spans(self) -> list:
        """The recorded spans, oldest first by end."""
        return list(self._spans)

    def clear(self) -> None:
        """Empty the span buffer, and record no more spans until a
        profiler runs again."""
        self._spans.clear()
        self._on = False

    def summary(self) -> dict:
        return {
            "counters": dict(self.counters),
            "stages": {k: h.summary() for k, h in self.stages.items()},
        }

    def dump_json(self) -> str:
        return json.dumps(self.summary(), indent=2, sort_keys=True)


GLOBAL_METRICS = Metrics()


class FPSMeter:
    """Frames a second: the frames ticked since the first tick over the
    time since it, so a stall lowers it."""

    def __init__(self):
        self._first: Optional[float] = None
        self.fps: float = 0.0
        self.frames = 0

    def tick(self, now: Optional[float] = None) -> float:
        now = time.perf_counter() if now is None else now
        self.frames += 1
        if self._first is None:
            self._first = now
        else:
            self.fps = (self.frames - 1) / max(now - self._first, 1e-9)
        return self.fps


def trace_clock(events: Iterable) -> Optional[Callable[[int], float]]:
    """From a trace's host events, ``(name, start_us, end_us, thread)``,
    the map of a ``time.perf_counter_ns`` reading onto the trace's
    microseconds, or None where the trace holds no anchor. Each anchor is
    a range named :data:`CLOCK` that held the reading, followed on its
    thread by the range named after it; the reading is put at the middle
    of the shortest such range, which bounds the error by half its
    length."""
    by_thread: dict = {}
    for n, s, e, th in events:
        if n.startswith(CLOCK):
            by_thread.setdefault(th, []).append((s, e, n))
    best = None
    for ev in by_thread.values():
        ev.sort()
        for (s0, e0, n0), (_, _, n1) in zip(ev, ev[1:]):
            if n0 == CLOCK and n1 != CLOCK and (best is None
                                                or e0 - s0 < best[0]):
                best = (e0 - s0, 0.5 * (s0 + e0) - int(n1[len(CLOCK):]) * 1e-3)
    if best is None:
        return None
    offset = best[1]
    return lambda ns: ns * 1e-3 + offset


def _write_spans(path: str, spans: list) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` on its clock: a row
    of their own for each thread that recorded, under the process's id
    (none where the trace holds no anchor)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    to_us = trace_clock((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
                        for e in events if e.get("cat") == "user_annotation")
    if to_us is None:
        return
    pid = os.getpid()
    rows = {}
    for s in spans:
        tid = rows.get(s.thread)
        if tid is None:
            # past any thread id of the host's: a row of its own
            tid = rows[s.thread] = 2 ** 31 - 1 - len(rows)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {
                               "name": f"program spans ({s.thread})"}})
        events.append({"ph": "X", "cat": "program", "name": s.name,
                       "pid": pid, "tid": tid, "ts": to_us(s.start_ns),
                       "dur": (s.end_ns - s.start_ns) * 1e-3,
                       "args": dict(s.attrs, frame=s.frame)})
    with open(path, "w") as f:
        json.dump(trace, f, default=str)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the host and, where there is a card, the
    device; written to ``logdir`` as a Chrome trace (view it in Perfetto or
    chrome://tracing) with the spans recorded meanwhile, on its clock."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter_ns()
        yield
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, [s for s in GLOBAL_METRICS.spans()
                        if s.start_ns >= t0])
