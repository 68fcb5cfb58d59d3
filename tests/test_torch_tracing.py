"""The port's tracer (``utils/metrics.py``) on the CPU at a tiny size:
spans are recorded from the first profiler on, until the buffer is
cleared, and never before; one frame through the
stereo_matcher graph gives the tree of the node, the pipeline and the
pyramid; ``device_trace`` writes the spans into its ``trace.json`` on the
trace's clock; the span buffer is bounded; histograms give exact
percentiles and the FPS meter sees a stall."""

import json
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_matcher
from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.matchers.pyramid import profile_from_config
from i3dr_stereo_tpu_torch.pipeline import stereo_pipeline
from i3dr_stereo_tpu_torch.utils import metrics
from i3dr_stereo_tpu_torch.utils.metrics import (
    GLOBAL_METRICS, SPAN_BUFFER, FPSMeter, Metrics, _Hist, device_trace)

torch.set_num_threads(2)

H, W = 64, 96
TOPICS = ("left/image_rect", "right/image_rect", "disparity", "depth",
          "points2")
CLOCK_US = 50.0     # how far a span may sit from the trace's own events
CFG = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
    disparity_range=32, max_pyramid_level=2, pyramid=True)


@pytest.fixture(scope="module")
def graph():
    """The graph on the CPU, its outputs by topic, and a frame's
    publisher."""
    lg = launch_stereo_matcher(
        StereoRig.synthetic(W, H, fx=100.0, baseline_m=0.3),
        stereo_algorithm=Algorithm.I3DRSGM, config=CFG, warmup=False,
        device="cpu")
    got = {}
    for t in TOPICS:
        lg.graph.subscribe(f"/stereo/{t}",
                           lambda s, d, t=t: got.__setitem__(t, d))
    sc = layered_scene(H, W, max_disp=12, seed=9)

    def frame(stamp):
        got.clear()
        lg.graph.publish("/stereo/left/image_raw", stamp, sc.left)
        lg.graph.publish("/stereo/right/image_raw", stamp, sc.right)
        assert set(got) == set(TOPICS)
        return dict(got)
    return frame


def _arrays(data):
    """The numpy arrays of one published payload, in publishing order."""
    if isinstance(data, np.ndarray):
        return [data]
    return [v for v in data.values() if isinstance(v, np.ndarray)]


def test_no_profiler_records_no_span(graph):
    GLOBAL_METRICS.clear()
    graph(1.0)
    assert GLOBAL_METRICS.spans() == []
    m = Metrics()
    assert m.span("a") is m.span("b", bytes=1)   # the shared no-op


def test_spans_go_on_after_the_profiler_until_cleared(graph):
    GLOBAL_METRICS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        graph(4.0)
    graph(5.0)
    spans = GLOBAL_METRICS.spans()
    after = [s for s in spans if s.frame == 5.0]
    assert {s.name for s in after} == {s.name for s in spans
                                       if s.frame == 4.0}
    assert len(after) == len(spans) - len(after)
    GLOBAL_METRICS.clear()
    graph(6.0)
    assert GLOBAL_METRICS.spans() == []


def test_a_frame_gives_the_tree_of_node_pipeline_and_pyramid(graph):
    GLOBAL_METRICS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = graph(2.0)
    spans = GLOBAL_METRICS.spans()
    by_id = {s.id: s for s in spans}
    named = lambda n: [s for s in spans if s.name == n]

    (root,) = named("node.frame")
    assert root.parent is None and root.attrs == {"stamp": 2.0}
    assert {s.frame for s in spans} == {2.0}
    assert {s.thread for s in spans} == {root.thread}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns

    (proc,) = named("pipeline.process")
    assert proc.parent == root.id
    stages = [s.name for s in spans if s.parent == proc.id]
    assert sorted(stages) == sorted(
        ["pipeline.upload", "pipeline.rectify", "pipeline.match",
         "pipeline.clamp", "pipeline.depth", "pipeline.cloud"])
    (upload,) = named("pipeline.upload")
    sc = layered_scene(H, W, max_disp=12, seed=9)
    assert upload.attrs["bytes"] == sc.left.nbytes + sc.right.nbytes
    (match,) = named("pipeline.match")
    # the pyramid's own span: eager on the CPU, its levels inside it
    (pyramid,) = named("pyramid.match")
    assert pyramid.parent == match.id
    assert pyramid.attrs == {"graph": "eager"}
    levels = named("pyramid.level")
    passes = profile_from_config(CFG).enabled_levels
    assert len(levels) == len(passes) >= 2
    assert all(s.parent == pyramid.id for s in levels)
    assert sorted(s.attrs["level"] for s in levels) == \
        sorted(p.level for p in passes)

    copies = sorted(named("node.copy"), key=lambda s: s.start_ns)
    assert all(s.parent == root.id for s in copies)
    want = [(t, a.nbytes) for t in TOPICS for a in _arrays(got[t])]
    assert len(want) == 8
    assert [(s.attrs["topic"], s.attrs["bytes"]) for s in copies] == want
    pubs = sorted(named("node.publish"), key=lambda s: s.start_ns)
    assert [s.attrs["topic"] for s in pubs] == list(TOPICS)
    assert all(s.parent == root.id for s in pubs)


def test_device_trace_writes_the_spans_on_its_clock(graph, tmp_path,
                                                    monkeypatch):
    twin = stereo_pipeline.rectify_pair

    def marked(*a, **k):
        with torch.profiler.record_function("rectify_twin"):
            return twin(*a, **k)
    monkeypatch.setattr(stereo_pipeline, "rectify_pair", marked)
    GLOBAL_METRICS.clear()
    with device_trace(str(tmp_path)):
        graph(3.0)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    rows = [e for e in events if e.get("cat") == "program"]
    assert {e["name"] for e in rows} >= {
        "node.frame", "node.copy", "node.publish", "pipeline.process",
        "pipeline.rectify", "pipeline.match", "pyramid.level"}
    assert len(rows) == len(GLOBAL_METRICS.spans())
    assert all(e["args"]["frame"] == 3.0 for e in rows)
    (rect,) = [e for e in rows if e["name"] == "pipeline.rectify"]
    (mark,) = [e for e in events if e.get("name") == "rectify_twin"
               and e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == mark["tid"]
           and mark["ts"] <= e["ts"] <= mark["ts"] + mark["dur"]]
    assert ops
    for e in [mark] + ops:
        assert rect["ts"] - CLOCK_US <= e["ts"]
        assert e["ts"] + e["dur"] <= rect["ts"] + rect["dur"] + CLOCK_US


def test_the_span_buffer_stays_within_its_bound():
    m = Metrics()
    with profile(activities=[ProfilerActivity.CPU]):
        with m.span("root", stamp=7):
            for _ in range(SPAN_BUFFER + 10):
                with m.span("leaf"):
                    pass
    spans = m.spans()
    assert len(spans) == SPAN_BUFFER
    assert spans[-1].name == "root" and spans[0].name == "leaf"
    assert all(s.frame == 7 for s in spans)
    m.clear()
    assert m.spans() == []


def test_hist_percentiles_are_exact():
    rng = random.Random(5)
    xs = [rng.lognormvariate(-4, 1) for _ in range(1001)]
    h = _Hist()
    for x in xs:
        h.add(x)
    for q in (0.5, 0.95):
        assert h.percentile(q) == pytest.approx(np.percentile(xs, 100 * q),
                                                rel=1e-12)
    s = h.summary()
    assert s["count"] == 1001
    assert s["mean_ms"] == pytest.approx(sum(xs) / 1001 * 1e3)
    for x in xs * (2 * metrics.RESERVOIR // 1001 + 1):
        h.add(x)
    assert len(h.samples) == metrics.RESERVOIR < h.n


def test_fps_meter_falls_after_a_stall():
    m = FPSMeter()
    for i in range(11):
        m.tick(i * 0.1)
    assert m.fps == pytest.approx(10.0)
    before = m.fps
    m.tick(1.0 + 2.0)                     # a 2 s stall
    assert m.fps == pytest.approx(11 / 3.0) and m.fps < before
    assert m.frames == 12
