"""The readers of the BP cell (``bp_messages_roofline``, ``bp_glue_ms``,
``bp_held_gb``) against counts by hand, a synthetic trace and synthetic
spans, each reading nothing where the program has no such kernel or
span; the cell's control failing its limits, and one traced tiny run of
the cell on the CPU, whose readers raise nothing."""

import json
from types import SimpleNamespace

import pytest
import torch

from portbench import check, control, manifest, peaks, run, spans
from portbench.reference.matchers import BP_GPU
from portbench.tests.conftest import REPO

CELL = "bp_1920.replay"
STAGED = "void i3dr::{anon}::bp_messages_staged_kernel(const float*, ...)"
STRIP = "void i3dr::{anon}::bp_messages_strip_kernel(const float*, ...)"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _config():
    return json.loads((REPO / "portbench/configs/bp_1920.json").read_text())


def test_the_roofline_counts_the_cells_five_levels():
    r = manifest.reader(REPO, "bp_messages_roofline")
    cfg = _config()
    shapes = [(1080, 1920), (540, 960), (270, 480), (135, 240), (67, 120)]
    assert r.level_shapes(cfg) == shapes       # 135 -> 67: the odd crop
    n = 480 * 5 * (1080 * 1920 + 540 * 960 + 270 * 480 + 135 * 240
                   + 67 * 120)
    assert r.work(cfg) == (36 * n, 30 * n)
    least, by = peaks.least_seconds(*r.work(cfg))
    assert by == "bytes" and abs(least - 0.0712359) < 1e-6


@pytest.mark.parametrize("H,W,levels", [(75, 100, 5), (47, 80, 3),
                                        (20, 9, 5), (1080, 1920, 2)])
def test_the_roofline_levels_are_the_pyramids(H, W, levels):
    r = manifest.reader(REPO, "bp_messages_roofline")
    cfg = {"rig": {"height": H, "width": W},
           "matcher": {"bp_levels": levels, "bp_iters": 5,
                       "disparity_range": 16}}
    pyr = BP_GPU.pyramid(torch.zeros(1, 1, H, W), levels)
    assert r.level_shapes(cfg) == [tuple(x.shape[-2:]) for x in pyr]


def _trace(frames=2):
    """Two frames of a BP trace: per frame the staged kernel 5 x 20 ms at
    level 0 and the strip kernel at the coarser levels, plain torch and a
    memset, and the node's copies."""
    dev, t = [], 0.0
    for _ in range(frames):
        for name, us in ([(STAGED, 20000.0)] * 5 + [(STRIP, 1000.0)] * 20
                         + [("void at::native::elementwise_kernel<...>",
                             3000.0), ("Memset (Device)", 500.0),
                            ("Memcpy DtoH (Device -> Pageable)", 7000.0),
                            ("Memcpy HtoD (Pageable -> Device)", 1000.0)]):
            dev.append((t, t + us, name))
            t += us + 10.0
    return SimpleNamespace(frames=frames, device=dev, cpu=[])


def test_the_roofline_and_the_glue_from_a_synthetic_trace():
    cfg = _config()
    t = _trace()
    roof = manifest.reader(REPO, "bp_messages_roofline").read(
        SimpleNamespace(trace=t, config=cfg))
    least = peaks.least_seconds(*manifest.reader(
        REPO, "bp_messages_roofline").work(cfg))[0]
    assert roof == pytest.approx(100.0 * least / 0.120, rel=1e-12)
    glue = manifest.reader(REPO, "bp_glue_ms.bp_1920.replay").read(
        SimpleNamespace(trace=t, config=cfg))
    assert glue == pytest.approx(3.5, rel=1e-12)


def test_the_device_readers_read_nothing_without_the_kernel():
    cfg = _config()
    other = SimpleNamespace(frames=1, device=[(0.0, 5.0, "sgm_volume_kernel"),
                                              (6.0, 9.0, "Memcpy DtoH")],
                            cpu=[])
    for name in ("bp_messages_roofline", "bp_glue_ms.bp_1920.replay"):
        r = manifest.reader(REPO, name)
        assert r.read(SimpleNamespace(trace=other, config=cfg)) is None
        assert r.read(SimpleNamespace(trace=None, config=cfg)) is None


def _span(name, frame, **attrs):
    return SimpleNamespace(name=name, frame=frame, attrs=attrs, start_ns=0,
                           end_ns=1)


def test_held_gb_from_synthetic_spans(monkeypatch):
    r = manifest.reader(REPO, "bp_held_gb.bp_1920.replay")
    got = spans.Frames([
        _span("node.frame", 1.0), _span("node.frame", 2.0),
        _span("bp.data_cost", 1.0, D=480, held_bytes=5_300_000_000),
        _span("bp.level", 1.0, level=0, held_bytes=21_250_000_000),
        _span("bp.belief", 1.0, held_bytes=9_000_000_000),
        _span("bp.level", 2.0, level=0, held_bytes=21_240_000_000),
        _span("node.copy", 2.0, bytes=99_000_000_000)], 2)
    monkeypatch.setattr(spans, "frames", lambda run, traced: got)
    assert r.read(SimpleNamespace()) == pytest.approx(21.25, rel=1e-12)
    # spans without the count (the card's allocator off the card), or no
    # bp spans at all (a program before them), or no tracer: nothing
    got = spans.Frames([_span("node.frame", 1.0), _span("bp.level", 1.0)],
                       1)
    assert r.read(SimpleNamespace()) is None
    got = spans.Frames([_span("node.frame", 1.0)], 1)
    assert r.read(SimpleNamespace()) is None
    monkeypatch.setattr(spans, "frames", lambda run, traced: None)
    assert r.read(SimpleNamespace()) is None


def test_the_control_fails_the_limits(tiny):
    rows = []
    control.readings(tiny, CELL, [3, 4], False, device="cpu",
                     log=lambda line, **k: rows.append(line))
    limits = manifest.cell(tiny, CELL).config["check_limits"]
    assert len(rows) == 2
    for line in rows:
        got = json.loads(line)["control"]
        assert any(got[k] > limits[k] for k in check.NUMBERS), got


def test_a_traced_tiny_run_reads_no_device_number_on_the_cpu(tiny):
    c = manifest.cell(tiny, CELL)
    assert c.config["matcher"]["algorithm"] == "BP_GPU"
    res = run.run_cell(tiny, c, 2 ** 31 + 41, 1.0, True, device="cpu",
                       log=lambda *a, **k: None)
    assert res["correct"], res["numbers"]
    got = set(res["metrics"])
    assert {"dispatch_ms.bp_1920.replay", "publish_ms.bp_1920.replay"} <= got
    # no card: no kernel in the trace, no allocator count on the spans
    assert not got & {"bp_messages_roofline", "bp_glue_ms.bp_1920.replay",
                      "bp_held_gb.bp_1920.replay"}
