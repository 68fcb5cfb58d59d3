"""Constant-space BP (``matchers/bp.py:_constant_space_match``) against
the benchmark's plain reference (``portbench/reference/matchers/
CSBP_GPU.py``) on the CPU at tiny sizes, with no JAX: the reference
equals the port's twin bit for bit, whole and piece by piece; the graph
launched with the ``csbp_1920`` block (scaled down) publishes what the
reference works out; the ``csbp.*`` spans are recorded, with their
attributes, only while the tracer records; and the CUDA graph's stages
(eager, capture, replay), with a stand-in for the capture."""

import dataclasses
import json
from unittest import mock
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.matchers import bp
from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
from i3dr_stereo_tpu_torch.utils.metrics import _OFF, GLOBAL_METRICS
from portbench import check, inputs, load
from portbench.reference.matchers import CSBP_GPU
from portbench.reference.pipeline import Reference

torch.set_num_threads(2)

CONFIG = Path(__file__).resolve().parents[1] / \
    "portbench/configs/csbp_1920.json"
JUMP, MAX_DISC = bp.DISC_SINGLE_JUMP, bp.MAX_DISC_TERM


def _block(cfg) -> dict:
    """A MatcherConfig as the reference reads it (a configuration file's
    matcher block)."""
    d = dataclasses.asdict(cfg)
    d.update(algorithm=cfg.algorithm.name, cost=cfg.cost.value)
    return d


def _pair(H, W, shift, seed):
    g = torch.Generator().manual_seed(seed)
    l = torch.rand((1, H, W), generator=g) * 200.0
    r = torch.roll(l, -shift, 2) + torch.rand((1, H, W), generator=g) * 5.0
    return l, r


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _cfg(**kw):
    kw = dict(dict(disparity_range=48, bp_iters=3, speckle_range=4.0), **kw)
    return ALGORITHM_DEFAULTS[Algorithm.CSBP_GPU].replace(**kw)


# ---------------------------------------------------------------------------
# the reference against the port's twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,K,speckle", [
    (64, 96, 4, 0),      # the cell's K, 4 levels, no speckle filter
    (63, 94, 4, 0),      # odd: the pyramid crops, _up2 replicates; 3 levels
    (64, 96, 3, 60),     # K 3, a speckle size that removes blobs
])
def test_reference_equals_the_twin(H, W, K, speckle):
    l, r = _pair(H, W, 16, seed=H * W + K)
    cfg = _cfg(csbp_planes=K, speckle_size=speckle)
    got = bp.belief_propagation_match(l, r, cfg, constant_space=True,
                                      plain=True)
    disp, valid = CSBP_GPU.match(l, r, _block(cfg))
    assert torch.equal(_bits(got.disparity), _bits(disp))
    assert torch.equal(got.valid, valid)
    assert 0.5 < float(valid.float().mean()) < 1.0
    if speckle:
        unfiltered = bp.belief_propagation_match(
            l, r, cfg.replace(speckle_size=0), constant_space=True,
            plain=True)
        assert torch.equal(unfiltered.disparity, got.disparity)
        assert bool((unfiltered.valid & ~got.valid).any())
        assert not bool((got.valid & ~unfiltered.valid).any())


@pytest.mark.parametrize("h,w,H,W", [(4, 5, 8, 10), (4, 5, 9, 11),
                                     (3, 3, 5, 6), (1, 1, 1, 1)])
def test_up2_equals_the_ports(h, w, H, W):
    x = torch.randn((4, 1, 3, h, w), generator=torch.Generator()
                    .manual_seed(h * w + H))
    assert torch.equal(_bits(CSBP_GPU.up2(x, H, W)),
                       _bits(bp._up2(x, H, W)))


@pytest.mark.parametrize("K,H,W", [(4, 9, 13), (3, 6, 5), (1, 4, 7)])
def test_plane_updates_equal_the_twin(K, H, W):
    g = torch.Generator().manual_seed(K * H * W)
    data = torch.rand((1, K, H, W), generator=g) * 0.7
    dvals = torch.randint(0, 300, (1, K, H, W), generator=g).float()
    msgs = 0.3 * torch.randn((4, 1, K, H, W), generator=g)
    want = bp.bp_iterate_planes_plain(data, dvals, msgs, 4, JUMP, MAX_DISC)
    assert torch.equal(_bits(CSBP_GPU.iterate_planes(data, dvals, msgs, 4)),
                       _bits(want))


@pytest.mark.parametrize("H,W,levels,want", [
    (1080, 1920, 4, [(1080, 1920), (540, 960), (270, 480), (135, 240)]),
    (63, 94, 4, [(63, 94), (31, 47), (15, 23)]),
    (64, 96, 2, [(64, 96), (32, 48)]),
    (15, 40, 4, [(15, 40)]),
])
def test_the_pyramid_is_the_ports(H, W, levels, want):
    l = torch.zeros((1, H, W))
    got = [tuple(x.shape[-2:]) for x, _ in CSBP_GPU.pyramid(l, l, levels)]
    assert got == want
    cfg = _cfg(bp_levels=levels, csbp_planes=4)
    if len(want) < 2:
        with pytest.raises(ValueError):
            bp.belief_propagation_match(l, l, cfg, constant_space=True)


# ---------------------------------------------------------------------------
# the graph with the cell's block, scaled down
# ---------------------------------------------------------------------------

def _tiny_config() -> dict:
    cfg = json.loads(CONFIG.read_text())
    W, H, f = 112, 64, 112.0
    cfg["matcher"].update(disparity_range=48)
    cfg["scene"].update(max_disp=40, background_disp=16, layers=3)
    cfg["rig"].update(
        width=W, height=H, K=[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
        P=[[0.99 * f, 0, W / 2 - 2, 0], [0, 0.99 * f, H / 2 - 1, 0],
           [0, 0, 1, 0]])
    return cfg


def test_the_graph_publishes_what_the_reference_computes(monkeypatch):
    from portbench.run import launch

    monkeypatch.setattr(inputs, "FRAMES", 2)
    monkeypatch.setattr(inputs, "SCENES", 2)
    config = _tiny_config()
    assert config["matcher"]["algorithm"] == "CSBP_GPU"
    assert config["matcher"]["min_disparity"] == 0
    pool = inputs.make_frames(config, 2 ** 31 + 5, "cpu")
    lg, pipe = launch(config, torch.device("cpu"))
    assert (pipe.config.bp_levels, pipe.config.bp_iters,
            pipe.config.csbp_planes, pipe.config.speckle_size) == (4, 8, 4, 100)
    drv = load.GraphLoad(lg.graph, pipe, pool)
    try:
        f = drv.new_frame(window=True, pool=1)
        drv.submit(f)
        assert f.done.wait(120) and f.error is None
    finally:
        drv.close()
    ref = Reference(config, "cpu").frame(pool.left[1], pool.right[1])
    got = check.compare(f.outputs, ref)
    assert got == dict.fromkeys(check.NUMBERS, 0.0), got
    assert float(ref["valid"].float().mean()) > 0.5


# ---------------------------------------------------------------------------
# the spans
# ---------------------------------------------------------------------------

def test_the_spans_record_only_under_the_tracer():
    cfg = _cfg(disparity_range=32, csbp_planes=4, bp_iters=2)
    l, r = _pair(64, 96, 8, seed=3)
    GLOBAL_METRICS.clear()
    plainly = bp.belief_propagation_match(l[0], r[0], cfg,
                                          constant_space=True)
    assert GLOBAL_METRICS.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with GLOBAL_METRICS.span("node.frame", stamp=7.0):
            traced = bp.belief_propagation_match(l[0], r[0], cfg,
                                                 constant_space=True)
    spans = [s for s in GLOBAL_METRICS.spans()
             if s.name.startswith("csbp.")]
    GLOBAL_METRICS.clear()
    assert torch.equal(_bits(plainly.disparity), _bits(traced.disparity))
    assert torch.equal(plainly.valid, traced.valid)
    spans = sorted(spans, key=lambda s: s.start_ns)
    assert [s.name for s in spans] == (["csbp.match", "csbp.coarse",
                                        "csbp.select"]
                                       + ["csbp.level"] * 3 + ["csbp.belief"])
    assert all(s.frame == 7.0 for s in spans)
    match, spans = spans[0], spans[1:]
    assert match.attrs == {"graph": "eager"}       # a CPU tensor
    assert all(s.parent == match.id for s in spans)
    assert spans[0].attrs == {"D": 4, "H": 8, "W": 12, "iters": 2}
    assert spans[1].attrs == {"K": 4}
    assert [s.attrs for s in spans[2:5]] == [
        {"level": lv, "H": h, "W": w, "K": 4, "iters": 2,
         "bytes": 4 * 4 * 4 * h * w}
        for lv, h, w in ((2, 16, 24), (1, 32, 48), (0, 64, 96))]
    assert spans[5].attrs == {}
    # each stage nests in the one before it ends: no span holds another
    for a, b in zip(spans, spans[1:]):
        assert a.end_ns <= b.start_ns


def test_held_bytes_on_every_csbp_span_on_a_card(monkeypatch):
    """``_held`` runs at the end of each of a frame's six spans, with the
    images' device (it sets ``held_bytes`` on a CUDA device alone, which
    ``test_torch_bp_reference.py`` holds)."""
    seen = []
    monkeypatch.setattr(bp, "_held",
                        lambda span, device: seen.append(device.type))
    cfg = _cfg(disparity_range=32, csbp_planes=4, bp_iters=1)
    l, r = _pair(64, 96, 8, seed=5)
    bp.belief_propagation_match(l[0], r[0], cfg, constant_space=True)
    assert seen == ["cpu"] * 6


# ---------------------------------------------------------------------------
# the CUDA graph
# ---------------------------------------------------------------------------

def test_cpu_and_plain_csbp_never_reach_the_graphs(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU or plain call reached the graphs")

    monkeypatch.setattr(pyr, "_capture", refuse)
    monkeypatch.setattr(bp.CSBP_GRAPHS, "run", refuse)
    cfg = _cfg(disparity_range=32, bp_iters=2)
    l, r = _pair(64, 96, 8, seed=11)
    first = bp.belief_propagation_match(l, r, cfg, constant_space=True)
    for plain in (False, True, False):
        again = bp.belief_propagation_match(l, r, cfg, constant_space=True,
                                            plain=plain)
        assert torch.equal(_bits(again.disparity), _bits(first.disparity))
        assert torch.equal(again.valid, first.valid)
    assert bp.CSBP_GRAPHS.keys() == []


class _Replayed:
    """Stands in for a captured graph: a replay runs the captured match
    again on the graph's inputs, with no span (a graph's replay runs no
    host code), and writes its static outputs."""

    def __init__(self, match, inputs, result):
        self.match, self.inputs, self.result = match, inputs, result

    def replay(self):
        with mock.patch.object(GLOBAL_METRICS, "span",
                               lambda *a, **kw: _OFF):
            res = self.match(*self.inputs)
        self.result.disparity.copy_(res.disparity)
        self.result.valid.copy_(res.valid)

    def reset(self):
        pass


def test_csbp_eager_capture_replay(monkeypatch):
    """Three pairs through the graphs' stages (a stand-in capture, keys
    given to CPU tensors): each result bit-equal to the eager match; the
    ``csbp.match`` span names the stage, and the stage spans record in the
    eager and the captured call alone."""
    def capture(match, left, right):
        inputs = (left.clone(), right.clone())
        result = match(*inputs)
        return pyr._Captured(_Replayed(match, inputs, result), inputs,
                             result, {})

    graphs = pyr.PyramidGraphs(span="csbp.match")
    monkeypatch.setattr(pyr, "_capture", capture)
    monkeypatch.setattr(bp, "CSBP_GRAPHS", graphs)
    monkeypatch.setattr(bp, "graph_key", lambda l, r, cfg, profile, *, lean,
                        plain: None if plain else (tuple(l.shape), cfg))
    cfg = _cfg(disparity_range=32, bp_iters=2, speckle_size=20)
    pairs = [_pair(64, 96, 8 + 2 * i, seed=20 + i) for i in range(3)]
    GLOBAL_METRICS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = []
        for i, (l, r) in enumerate(pairs):
            with GLOBAL_METRICS.span("node.frame", stamp=float(i)):
                got.append(bp.belief_propagation_match(
                    l, r, cfg, constant_space=True))
    spans = GLOBAL_METRICS.spans()
    GLOBAL_METRICS.clear()
    assert len(graphs.keys()) == 1
    for (l, r), res in zip(pairs, got):
        want = bp.belief_propagation_match(l, r, cfg, constant_space=True,
                                           plain=True)
        assert torch.equal(_bits(res.disparity), _bits(want.disparity))
        assert torch.equal(res.valid, want.valid)
    cap = graphs._held[graphs.keys()[0]]
    assert got[2].disparity.data_ptr() != cap.result.disparity.data_ptr()
    matches = sorted((s for s in spans if s.name == "csbp.match"),
                     key=lambda s: s.frame)
    assert [s.attrs for s in matches] == [{"graph": "eager"},
                                          {"graph": "capture"},
                                          {"graph": "replay"}]
    stages = {}
    for s in spans:
        if s.name.startswith("csbp.") and s.name != "csbp.match":
            stages[s.frame] = stages.get(s.frame, 0) + 1
    assert stages == {0.0: 6, 1.0: 6}
