"""The readers of the program's spans, on one tiny traced run of the
flagship replay cell on the CPU: each returns a number; ``d2h_mb`` is the
bytes of the outputs the graph published; ``idle_match_ms`` is the
matcher's time in the traced frames when the device (a stand-in, busy
everywhere else on the trace's clock) idles through every
``pipeline.match``; the host readers read the window's frames after the
traced ones; the program's ``pipeline.process`` sits inside the
harness's ``portbench.dispatch`` on the trace's clock. A program without
the tracer gives the readers nothing, and they raise nothing."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import check, manifest, run, spans
from portbench import trace as tr

CELL = "i3drsgm_2448.replay"
CLOCK_US = 50.0     # how far the program's span may sit from the harness's
READERS = ("copy_ms", "d2h_mb", "match_ms", "pipeline_self_ms",
           "idle_match_ms")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def busy_but_in_the_matcher(monkeypatch, kept: dict):
    """Give the trace a device busy through its window but for the
    program's ``pipeline.match`` spans, placed by the program's clock;
    keep the trace, and the spans the readers took, in ``kept``."""
    from i3dr_stereo_tpu_torch.utils.metrics import (GLOBAL_METRICS,
                                                     trace_clock)

    read = tr.read

    def with_device(prof, frames):
        t = read(prof, frames)
        to_us = trace_clock((n, s, e, th) for s, e, n, th in t.cpu)
        ws, we = t.window
        holes = sorted((to_us(s.start_ns), to_us(s.end_ns))
                       for s in GLOBAL_METRICS.spans()
                       if s.name == "pipeline.match")
        holes = [(a, b) for a, b in holes if ws <= a and b <= we]
        edges = [ws] + [x for h in holes for x in h] + [we]
        t.device = [(a, b, "stand-in") for a, b in zip(edges[::2],
                                                        edges[1::2])]
        kept["trace"] = t
        return t
    monkeypatch.setattr(tr, "read", with_device)
    took = spans.frames

    def frames(r, traced):
        got = kept[traced] = took(r, traced)
        return got
    monkeypatch.setattr(spans, "frames", frames)


def traced_run(tiny, monkeypatch, seed):
    """One traced run of the cell: its result, the outputs compared, the
    notes on standard error, and what ``busy_but_in_the_matcher`` kept."""
    published, notes, kept = [], [], {}
    compare = check.compare

    def keep(outputs, ref):
        published.append(outputs)
        return compare(outputs, ref)
    monkeypatch.setattr(check, "compare", keep)
    busy_but_in_the_matcher(monkeypatch, kept)
    res = run.run_cell(tiny, manifest.cell(tiny, CELL), seed, 6.0, True,
                       device="cpu",
                       log=lambda line, **k: notes.append(line))
    return res, published, notes, kept


def test_the_span_readers_read_a_traced_run(tiny, monkeypatch):
    res, published, notes, kept = traced_run(tiny, monkeypatch,
                                             2 ** 31 + 29)
    got = {k.split(".")[0]: v["value"] for k, v in res["metrics"].items()}
    for q in READERS:
        assert got[q] > 0, q
    arrays = [a for d in published[0].values()
              for a in (d.values() if isinstance(d, dict) else [d])
              if isinstance(a, np.ndarray)]
    assert len(arrays) == 8
    assert got["d2h_mb"] == pytest.approx(
        sum(a.nbytes for a in arrays) * 1e-6, rel=1e-12)
    traced, rest = kept[True], kept[False]
    assert traced.frames == 2 and rest.frames >= 1
    assert {s.frame for s in traced.spans}.isdisjoint(
        {s.frame for s in rest.spans})
    assert got["match_ms"] == pytest.approx(rest.ms("pipeline.match"))
    assert got["idle_match_ms"] == pytest.approx(
        traced.ms("pipeline.match"), rel=1e-6)
    for head in ("match_ms by pass", "pipeline_self_ms by stage",
                 "idle a frame by program span"):
        assert any(n.startswith(head) for n in notes), head


def test_the_spans_sit_inside_the_harness_spans_on_the_trace_clock(
        tiny, monkeypatch):
    res, _, _, kept = traced_run(tiny, monkeypatch, 2 ** 31 + 37)
    t, traced = kept["trace"], kept[True]
    outer = t.spans("dispatch")
    mapped = [(a, b) for a, b, s in spans.on_trace(SimpleNamespace(trace=t),
                                                   traced)
              if s.name == "pipeline.process"]
    assert len(mapped) == traced.frames == 2
    # an error e of the clock moves both ends by e: the start sits
    # 0..CLOCK_US after the harness's, the end before the harness's end
    # (which waits for the profiler's exit of its range), so |e| is within
    # CLOCK_US
    for a, b in mapped:
        (ds, de), = [(ds, de) for ds, de in outer if ds <= 0.5 * (a + b) <= de]
        assert 0 <= a - ds <= CLOCK_US
        assert b <= de


def test_a_program_without_the_tracer_gives_nothing(tiny, monkeypatch):
    from i3dr_stereo_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "trace_clock")
    res = run.run_cell(tiny, manifest.cell(tiny, CELL), 2 ** 31 + 31, 0.5,
                       True, device="cpu", log=lambda *a, **k: None)
    assert not {k.split(".")[0] for k in res["metrics"]} & set(READERS)
