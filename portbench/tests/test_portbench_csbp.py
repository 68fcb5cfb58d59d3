"""The readers of the CSBP cell (``bp_planes_roofline``,
``csbp_glue_ms``, ``csbp_held_mb``) against counts by hand, a synthetic
trace and synthetic spans, each reading nothing where the program has no
such kernel or span; the cell's control failing its limits, and one
traced tiny run of the cell on the CPU, whose readers raise nothing."""

import json
from types import SimpleNamespace

import pytest
import torch

from portbench import check, control, manifest, peaks, run, spans
from portbench.reference.matchers import CSBP_GPU
from portbench.tests.conftest import REPO

CELL = "csbp_1920.replay"
PLANES = "void i3dr::{anon}::bp_planes_kernel<4>(const float*, ...)"
STRIP = "void i3dr::{anon}::bp_messages_strip_kernel(const float*, ...)"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _config():
    return json.loads((REPO / "portbench/configs/csbp_1920.json").read_text())


def test_the_roofline_counts_the_cells_three_finer_levels():
    r = manifest.reader(REPO, "bp_planes_roofline")
    cfg = _config()
    assert r.level_shapes(cfg) == [(1080, 1920), (540, 960), (270, 480),
                                   (135, 240)]
    # K = 4 planes, 8 iterations at 1080x1920, 540x960 and 270x480: the
    # coarsest level (135x240) runs dense BP, not bp_planes
    pixels = 8 * (1080 * 1920 + 540 * 960 + 270 * 480)
    assert r.work(cfg) == (10 * 4 * 4 * pixels, 12 * 4 * 4 * pixels)
    assert r.work(cfg)[0] == 3_483_648_000
    least, by = peaks.least_seconds(*r.work(cfg))
    assert by == "bytes" and abs(least - 1.0399e-3) < 1e-7


@pytest.mark.parametrize("H,W,levels", [(1080, 1920, 4), (63, 94, 4),
                                        (40, 64, 3), (64, 96, 9),
                                        (1080, 1920, 2)])
def test_the_roofline_levels_are_the_pyramids(H, W, levels):
    r = manifest.reader(REPO, "bp_planes_roofline")
    cfg = {"rig": {"height": H, "width": W},
           "matcher": {"bp_levels": levels, "bp_iters": 8,
                       "disparity_range": 480, "csbp_planes": 4}}
    img = torch.zeros(1, H, W)
    pyr = CSBP_GPU.pyramid(img, img, levels)
    assert r.level_shapes(cfg) == [tuple(x.shape[-2:]) for x, _ in pyr]


def _trace(frames=2):
    """Two frames of a CSBP trace: per frame the strip kernel 8 x 50 us at
    the coarsest level, bp_planes 24 x 100 us, plain torch and a memset,
    and the node's copies."""
    dev, t = [], 0.0
    for _ in range(frames):
        for name, us in ([(STRIP, 50.0)] * 8 + [(PLANES, 100.0)] * 24
                         + [("void at::native::elementwise_kernel<...>",
                             3000.0), ("Memset (Device)", 500.0),
                            ("Memcpy DtoH (Device -> Pinned)", 2000.0),
                            ("Memcpy HtoD (Pageable -> Device)", 400.0)]):
            dev.append((t, t + us, name))
            t += us + 10.0
    return SimpleNamespace(frames=frames, device=dev, cpu=[])


def test_the_roofline_and_the_glue_from_a_synthetic_trace():
    cfg = _config()
    t = _trace()
    r = manifest.reader(REPO, "bp_planes_roofline")
    roof = r.read(SimpleNamespace(trace=t, config=cfg))
    least = peaks.least_seconds(*r.work(cfg))[0]
    assert roof == pytest.approx(100.0 * least / 2.4e-3, rel=1e-12)
    glue = manifest.reader(REPO, "csbp_glue_ms.csbp_1920.replay").read(
        SimpleNamespace(trace=t, config=cfg))
    assert glue == pytest.approx(3.5, rel=1e-12)


def test_the_device_readers_read_nothing_without_the_kernel():
    cfg = _config()
    dense = SimpleNamespace(frames=1, device=[(0.0, 5.0, STRIP),
                                              (6.0, 9.0, "Memcpy DtoH")],
                            cpu=[])
    for name in ("bp_planes_roofline", "csbp_glue_ms.csbp_1920.replay"):
        r = manifest.reader(REPO, name)
        assert r.read(SimpleNamespace(trace=dense, config=cfg)) is None
        assert r.read(SimpleNamespace(trace=None, config=cfg)) is None


def _span(name, frame, **attrs):
    return SimpleNamespace(name=name, frame=frame, attrs=attrs, start_ns=0,
                           end_ns=1)


def test_held_mb_from_synthetic_spans(monkeypatch):
    r = manifest.reader(REPO, "csbp_held_mb.csbp_1920.replay")
    got = spans.Frames([
        _span("node.frame", 1.0), _span("node.frame", 2.0),
        _span("csbp.coarse", 1.0, D=60, held_bytes=150_000_000),
        _span("csbp.level", 1.0, level=0, held_bytes=412_500_000),
        _span("csbp.belief", 1.0, held_bytes=300_000_000),
        _span("csbp.level", 2.0, level=0, held_bytes=412_000_000),
        _span("bp.level", 2.0, level=0, held_bytes=21_000_000_000),
        _span("node.copy", 2.0, bytes=99_000_000_000)], 2)
    monkeypatch.setattr(spans, "frames", lambda run, traced: got)
    assert r.read(SimpleNamespace()) == pytest.approx(412.5, rel=1e-12)
    # spans without the count (the card's allocator off the card), or no
    # csbp spans at all (a program before them), or no tracer: nothing
    got = spans.Frames([_span("node.frame", 1.0),
                        _span("csbp.level", 1.0)], 1)
    assert r.read(SimpleNamespace()) is None
    got = spans.Frames([_span("node.frame", 1.0),
                        _span("bp.level", 1.0, held_bytes=5)], 1)
    assert r.read(SimpleNamespace()) is None
    monkeypatch.setattr(spans, "frames", lambda run, traced: None)
    assert r.read(SimpleNamespace()) is None


def test_held_mb_from_replayed_frames(monkeypatch):
    """Frames whose CSBP replayed a CUDA graph carry only the graph's
    ``csbp.match`` span: its count (tensors and the pool's free bytes)."""
    r = manifest.reader(REPO, "csbp_held_mb.csbp_1920.replay")
    got = spans.Frames([
        _span("node.frame", 1.0), _span("node.frame", 2.0),
        _span("csbp.match", 1.0, graph="replay", held_bytes=640_000_000),
        _span("csbp.match", 2.0, graph="replay", held_bytes=641_500_000),
        _span("pyramid.match", 2.0, graph="replay", held_bytes=9e9)], 2)
    monkeypatch.setattr(spans, "frames", lambda run, traced: got)
    assert r.read(SimpleNamespace()) == pytest.approx(641.5, rel=1e-12)


def test_the_control_fails_the_limits(tiny):
    rows = []
    control.readings(tiny, CELL, [3, 4, 5], False, device="cpu",
                     log=lambda line, **k: rows.append(line))
    limits = manifest.cell(tiny, CELL).config["check_limits"]
    assert len(rows) == 3
    for line in rows:
        got = json.loads(line)["control"]
        assert any(got[k] > limits[k] for k in check.NUMBERS), got


def test_a_traced_tiny_run_reads_no_device_number_on_the_cpu(tiny):
    c = manifest.cell(tiny, CELL)
    assert c.config["matcher"]["algorithm"] == "CSBP_GPU"
    # 3 s: the traced frames and frames after them on a loaded CPU too
    res = run.run_cell(tiny, c, 2 ** 31 + 43, 3.0, True, device="cpu",
                       log=lambda *a, **k: None)
    assert res["correct"], res["numbers"]
    got = set(res["metrics"])
    assert {"dispatch_ms.csbp_1920.replay", "publish_ms.csbp_1920.replay",
            "match_ms.csbp_1920.replay"} <= got
    # no card: no kernel in the trace, no allocator count on the spans
    assert not got & {"bp_planes_roofline", "csbp_glue_ms.csbp_1920.replay",
                      "csbp_held_mb.csbp_1920.replay"}
