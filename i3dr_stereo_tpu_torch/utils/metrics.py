"""Observability: counters, per-stage timing, FPS, latency histograms.

The reference has none of this — ROS_INFO prints and commented-out
timing probes only (SURVEY.md §5). This module provides the metrics
surface a production deployment needs, plus a profiler hook for device
traces (torch port of ``i3dr_stereo_tpu.utils.metrics``: a stage waits for
the card through a CUDA event, the trace is ``torch.profiler``'s).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class _Hist:
    """Fixed log-bucket latency histogram (us .. 100s)."""

    counts: list = dataclasses.field(default_factory=lambda: [0] * 32)
    total: float = 0.0
    n: int = 0
    vmin: float = math.inf
    vmax: float = 0.0

    def add(self, seconds: float) -> None:
        self.n += 1
        self.total += seconds
        self.vmin = min(self.vmin, seconds)
        self.vmax = max(self.vmax, seconds)
        b = min(31, max(0, int((math.log10(max(seconds, 1e-6)) + 6) * 4)))
        self.counts[b] += 1

    def percentile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        target = q * self.n
        acc = 0
        for b, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return 10 ** (b / 4.0 - 6)
        return self.vmax

    def summary(self) -> dict:
        return {
            "count": self.n,
            "mean_ms": (self.total / self.n * 1e3) if self.n else 0.0,
            "min_ms": 0.0 if self.n == 0 else self.vmin * 1e3,
            "max_ms": self.vmax * 1e3,
            "p50_ms": self.percentile(0.5) * 1e3,
            "p95_ms": self.percentile(0.95) * 1e3,
        }


class Metrics:
    """Process-wide registry: counters + stage latency histograms."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.stages: Dict[str, _Hist] = defaultdict(_Hist)

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

    def summary(self) -> dict:
        return {
            "counters": dict(self.counters),
            "stages": {k: h.summary() for k, h in self.stages.items()},
        }

    def dump_json(self) -> str:
        return json.dumps(self.summary(), indent=2, sort_keys=True)


GLOBAL_METRICS = Metrics()


def _tensors(tree):
    """The tensors in a tensor, a dataclass, or a dict, list or tuple of
    them (the pytrees a stage may wait on)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def wait_for(tree) -> None:
    """Block the host until the work queued so far on the current stream
    of each CUDA device holding a tensor of ``tree`` has finished: one
    CUDA event a device, recorded and waited on. CPU tensors are ready
    when they exist, so they need no wait."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class StageTimer:
    """Per-stage timer bound to a Metrics registry; blocks on device
    results so device time is attributed to the stage."""

    def __init__(self, metrics: Optional[Metrics] = None):
        self.metrics = metrics or GLOBAL_METRICS

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                wait_for(block_on)
            self.metrics.observe(name, time.perf_counter() - t0)


class FPSMeter:
    """Exponentially-weighted frames/sec meter."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._last: Optional[float] = None
        self.fps: float = 0.0
        self.frames = 0

    def tick(self, now: Optional[float] = None) -> float:
        now = time.perf_counter() if now is None else now
        self.frames += 1
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = 1.0 / dt
            self.fps = inst if self.fps == 0 else \
                (1 - self.alpha) * self.fps + self.alpha * inst
        self._last = now
        return self.fps


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the host and, where there is a card, the
    device; written to ``logdir`` as a Chrome trace (view it in Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
