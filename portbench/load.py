"""The load on the graph: the harness stands in for the two capture nodes
and for the ``stereo_gui`` subscriber of every output topic.

- The spinner, a thread of its own, publishes each raw pair on
  ``<ns>/left/image_raw`` and ``<ns>/right/image_raw``. The graph's
  pub/sub is synchronous, so the node's whole frame (``process``, the
  copies to the host and every publish) runs inside that call.
- The collector's callbacks receive every output topic; a frame is
  delivered when the last of them arrives.
- The generator (:func:`closed_loop`, :func:`open_loop`) is the load's
  third component: closed, it hands the spinner the next pair once the
  previous was delivered; open, it hands each pair to the spinner's queue
  at its due time and never waits for the graph.

A reservoir drawn from the seed keeps the outputs of ``CHECK_FRAMES``
frames of the window for the comparison; the others are dropped on
arrival."""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
from contextlib import nullcontext
from typing import Callable, Optional

OUTPUTS = ("left/image_rect", "right/image_rect", "disparity", "depth",
           "points2")
WARMUP_FRAMES = 3    # through the graph before the window, one at a time
TRACE_FRAMES = 8     # the window's first frames under the profiler
CHECK_FRAMES = 1     # frames of the window kept for the comparison
LATE_WAIT_S = 60.0   # how long past the close a frame due is waited for

now = time.perf_counter


@dataclasses.dataclass(eq=False)
class Frame:
    seq: int                       # publish order, warm-up included
    pool: int                      # index of its raw pair in the pool
    stamp: float
    window: bool                   # counted in the window
    due: Optional[float] = None    # open loop: when it was due
    t_enq: Optional[float] = None  # handed to the spinner
    t_pub: Optional[float] = None  # the spinner began publishing it
    t_proc0: Optional[float] = None
    t_proc1: Optional[float] = None
    t_done: Optional[float] = None  # its last output topic arrived
    error: Optional[str] = None
    outputs: Optional[dict] = None
    arrived: int = 0
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


class GraphLoad:
    """The spinner and the collector around one launched graph.

    ``pipeline`` is the node's ``StereoPipeline``; its ``process`` is
    wrapped (on the instance, the port unedited) to time the host's
    ``process`` span of each frame. ``trace`` profiles the window's first
    ``TRACE_FRAMES`` frames, started and stopped on the spinner's
    thread."""

    def __init__(self, graph, pipeline, pool, *, namespace: str = "/stereo",
                 seed: int = 0, trace: bool = False):
        self.graph, self.pool, self.ns = graph, pool, namespace
        self.frames: list = []
        self.by_stamp: dict = {}
        self.sample: list = []
        self.check_frames = CHECK_FRAMES
        self._rng = random.Random(int(seed) * 7919 + 17)
        self._seen = 0
        self._cur: Optional[Frame] = None
        self.trace_frames = TRACE_FRAMES if trace else 0
        self.prof = None
        self.traced = 0
        self.trace_done = False
        self.q: queue.SimpleQueue = queue.SimpleQueue()
        self.spans = self.trace_frames > 0
        self._pub = None
        self._n = 0
        orig = pipeline.process

        def process(left, right):
            f = self._cur
            with self._span("dispatch"):
                f.t_proc0 = now()
                res = orig(left, right)
                f.t_proc1 = now()
            if self.spans:
                self._pub = self._span("publish")
                self._pub.__enter__()
            return res

        pipeline.process = process
        for t in OUTPUTS:
            graph.subscribe(f"{namespace}/{t}", self._on_output(t))
        graph.subscribe(f"{namespace}/match_errors", self._on_error)
        self.thread = threading.Thread(target=self._spin, name="spinner",
                                       daemon=True)
        self.thread.start()

    # -- spans ------------------------------------------------------------
    def _span(self, what: str):
        if not self.spans:
            return nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{what}")

    # -- the collector ----------------------------------------------------
    def _keep(self, f: Frame) -> bool:
        """Reservoir sampling over the window's frames, decided at a
        frame's first output."""
        if not f.window:
            return False
        self._seen += 1
        if len(self.sample) < self.check_frames:
            self.sample.append(f)
            return True
        j = self._rng.randrange(self._seen)
        if j < self.check_frames:
            self.sample[j].outputs = None
            self.sample[j] = f
            return True
        return False

    def _on_output(self, topic: str):
        def cb(stamp, data):
            f = self.by_stamp[stamp]
            if f.arrived == 0 and self._keep(f):
                f.outputs = {}
            if f.outputs is not None:
                f.outputs[topic] = data
            f.arrived += 1
            if f.arrived == len(OUTPUTS):
                f.t_done = now()
                if self._pub is not None:
                    self._pub.__exit__(None, None, None)
                    self._pub = None
                f.done.set()
        return cb

    def _on_error(self, stamp, text):
        f = self.by_stamp[stamp]
        f.error = str(text)
        f.t_done = now()
        f.done.set()

    # -- the spinner ------------------------------------------------------
    def _spin(self):
        while True:
            with self._span("spinner_wait"):
                item = self.q.get()
            if item is None:
                return
            if callable(item):
                item()
                continue
            self._publish(item)

    def _publish(self, f: Frame):
        self._cur = f
        left, right = self.pool.left[f.pool], self.pool.right[f.pool]
        with self._span("frame" if f.window else "warmup_frame"):
            f.t_pub = now()
            self.graph.publish(f"{self.ns}/left/image_raw", f.stamp, left)
            self.graph.publish(f"{self.ns}/right/image_raw", f.stamp, right)
        if not f.done.is_set():       # the pair never reached the matcher
            f.error = f.error or "no output"
            f.done.set()
        if f.window and self.prof is not None and not self.trace_done:
            self.traced += 1
            if self.traced == self.trace_frames:
                self.stop_trace()

    def start_trace(self):
        """Start the profiler (on the spinner's thread, where the frames
        run) and push one frame through it outside the window, so the
        profiler's own start-up is set-up; the window's first
        ``trace_frames`` frames are then traced."""
        self.call(self._start_trace)
        warm_up(self, 1)

    def _start_trace(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop_trace(self):
        """Stop the profiler, on the spinner's thread."""
        import torch

        if self.trace_done:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.trace_done = True

    # -- the generator's side ---------------------------------------------
    def new_frame(self, window: bool, pool: Optional[int] = None) -> Frame:
        seq = self._n
        self._n += 1
        f = Frame(seq=seq, pool=seq % len(self.pool.left) if pool is None
                  else pool, stamp=1000.0 + seq, window=window)
        self.frames.append(f)
        self.by_stamp[f.stamp] = f
        return f

    def submit(self, f: Frame) -> None:
        f.t_enq = now()
        self.q.put(f)

    def call(self, fn: Callable):
        """Run ``fn`` on the spinner's thread, after what is queued, and
        wait for it."""
        ev = threading.Event()
        out = {}

        def run():
            try:
                out["value"] = fn()
            finally:
                ev.set()

        self.q.put(run)
        ev.wait()
        return out.get("value")

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()


def warm_up(drv: GraphLoad, n: int, timeout: float = 600.0) -> None:
    """``n`` frames through the graph, one at a time, outside the window."""
    for _ in range(n):
        f = drv.new_frame(window=False)
        drv.submit(f)
        if not f.done.wait(timeout):
            raise RuntimeError("a warm-up frame did not come back")
        if f.error:
            raise RuntimeError(f"a warm-up frame failed: {f.error}")


def closed_loop(drv: GraphLoad, seconds: float) -> tuple:
    """The next pair once the previous was delivered, until the window
    closes; the frame in flight then is waited for, ``LATE_WAIT_S`` past
    the close at most. Returns (start, end) of the window."""
    t0 = now()
    t_end = t0 + seconds
    while now() < t_end:
        f = drv.new_frame(window=True)
        drv.submit(f)
        if not f.done.wait(max(t_end - now(), 0.0) + LATE_WAIT_S):
            break
    return t0, t_end


def open_loop(drv: GraphLoad, seconds: float, rate: float) -> tuple:
    """Pairs due at fixed intervals, ``rate`` a second, through the
    window, each handed to the spinner's queue at its due time; then every
    frame due in the window is waited for, ``LATE_WAIT_S`` past the close
    at most. Returns (start, end) of the window."""
    t0 = now() + 0.01
    t_end = t0 + seconds
    due, i = t0, 0
    while due < t_end:
        left = due - now()
        if left > 0:
            time.sleep(left)
        f = drv.new_frame(window=True)
        f.due = due
        drv.submit(f)
        i += 1
        due = t0 + i / rate
    limit = t_end + LATE_WAIT_S
    for f in drv.frames:
        if f.window:
            f.done.wait(max(limit - now(), 0.0))
    return t0, t_end


def mean_ms(frames, start: str, end: str):
    """Mean of ``end - start`` (two of a frame's times) in ms over the
    delivered frames that have both, or None."""
    ms = [(getattr(f, end) - getattr(f, start)) * 1e3 for f in frames
          if getattr(f, start) is not None and getattr(f, end) is not None
          and not f.error]
    return sum(ms) / len(ms) if ms else None
