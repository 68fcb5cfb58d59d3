"""Streaming runner: source -> pairing -> batches -> pipeline -> sinks
(torch port of ``i3dr_stereo_tpu.pipeline.runner``).

The live loop the reference spreads over roslaunch'd processes. Keeps
the device busy by dispatching batch N+1 while batch N's outputs are
fetched (CUDA's asynchronous launches: the host queues a batch's kernels
and goes on), tracks FPS/latency via utils.metrics, and hands results to
sink callbacks (publish, save, view).

A batch in flight is its result plus a CUDA event recorded on the
device's current stream after the pipeline call; draining waits on that
event alone, the counterpart of the reference's ``jax.block_until_ready``.
A pipeline on the CPU computes as it is called, so its batches need no
event.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from i3dr_stereo_tpu_torch.pipeline.pairing import FrameBatcher, Stamped
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import PipelineResult, StereoPipeline
from i3dr_stereo_tpu_torch.utils.metrics import FPSMeter, Metrics


@dataclasses.dataclass
class StreamStats:
    frames_in: int = 0
    batches: int = 0
    frames_out: int = 0
    fps: float = 0.0


class StreamRunner:
    def __init__(self, pipeline: StereoPipeline, *, batch_size: int = 1,
                 metrics: Optional[Metrics] = None):
        self.pipeline = pipeline
        self.batcher = FrameBatcher(batch_size=batch_size)
        self.metrics = metrics or Metrics()
        self.stats = StreamStats()
        self._meter = FPSMeter()
        self._inflight: List[Tuple[np.ndarray, int, PipelineResult,
                                   Optional[torch.cuda.Event]]] = []

    def run(self, pairs: Iterable[Tuple[Stamped, Stamped]],
            sink: Callable[[np.ndarray, int, PipelineResult], None],
            *, depth: int = 2) -> StreamStats:
        """Process a stream of paired frames.

        ``sink(stamps, count, result)`` is called once per batch with
        results on the pipeline's device, once the device has computed
        them (fetch to the host lazily — they are tensors).
        ``depth`` = number of batches allowed in flight before draining.
        """
        for l, r in pairs:
            self.stats.frames_in += 1
            batch = self.batcher.push(l, r)
            if batch is not None:
                self._dispatch(batch)
            while len(self._inflight) > depth:
                self._drain_one(sink)
        tail = self.batcher.flush()
        if tail is not None:
            self._dispatch(tail)
        while self._inflight:
            self._drain_one(sink)
        return self.stats

    def _dispatch(self, batch) -> None:
        with self.metrics.time("dispatch"):
            res = self.pipeline.process(batch.left, batch.right)
            done = None
            if self.pipeline.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.pipeline.device))
        self._inflight.append((batch.stamps, batch.count, res, done))
        self.stats.batches += 1

    def _drain_one(self, sink) -> None:
        stamps, count, res, done = self._inflight.pop(0)
        with self.metrics.time("drain"):
            if done is not None:
                done.synchronize()
            sink(stamps, count, res)
        self.stats.frames_out += count
        for _ in range(count):
            self.stats.fps = self._meter.tick()
