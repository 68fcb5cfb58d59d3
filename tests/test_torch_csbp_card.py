"""CSBP's kernels on the card at the ``csbp_1920`` cell's shapes:
``bp_planes`` bit-equal to its plain twin at the three finer levels of a
1920x1080 pyramid, the strip ``bp_messages`` at the coarsest level,
1920x1080 frames through the pipeline equal to the benchmark's plain
reference (``portbench/reference/matchers/CSBP_GPU.py``) eagerly and as
a replayed CUDA graph, with their launches counted, and what a replayed
frame holds on the card.

Marked ``card``: each test skips without a CUDA device. On a machine with
one, from the repository's root (``--noconftest``: tests/conftest.py sets
up JAX, which the card's machine need not have)::

    python -m pytest --noconftest -m card tests/test_torch_csbp_card.py

No JAX here: the twins and the plain reference are the yardsticks."""

import json
from pathlib import Path

import pytest
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.matchers import bp
from i3dr_stereo_tpu_torch.matchers.pyramid import PyramidGraphs

pytestmark = pytest.mark.card

CONFIG = Path(__file__).resolve().parents[1] / \
    "portbench/configs/csbp_1920.json"
JUMP, MAX_DISC = bp.DISC_SINGLE_JUMP, bp.MAX_DISC_TERM


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def graphs(monkeypatch):
    """CSBP's graph cache, empty: the test's first frame runs eagerly."""
    fresh = PyramidGraphs(span="csbp.match")
    monkeypatch.setattr(bp, "CSBP_GRAPHS", fresh)
    return fresh


@pytest.mark.parametrize("H,W", [(270, 480), (540, 960), (1080, 1920)])
def test_bp_planes_equals_the_twin_at_the_cells_levels(card, H, W):
    """K = 4 candidates spaced as the cell's (multiples of 8 up to 472),
    costs in [0, 0.7], 8 iterations from zero messages, as a level runs
    them; then 8 more from the result (messages of every sign)."""
    g = torch.Generator(device=card).manual_seed(H)
    data = torch.rand((1, 4, H, W), device=card, generator=g) * 0.7
    dvals = 8.0 * torch.randint(0, 60, (1, 4, H, W), device=card,
                                generator=g).float()
    msgs = torch.zeros((4, 1, 4, H, W), device=card)
    for _ in range(2):
        want = bp.bp_iterate_planes(data, dvals, msgs, 8, JUMP, MAX_DISC,
                                    plain=True)
        _build.reset_launches()
        got = bp.bp_iterate_planes(data, dvals, msgs, 8, JUMP, MAX_DISC)
        assert _build.LAUNCHES["bp_planes"] == 8
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want)
        msgs = got.clone()


def test_strip_bp_messages_equals_the_twin_at_the_coarsest_level(card):
    """The coarsest level of the cell: 60 disparities at 135x240, the
    strip kernel (``messages_shared(60)`` > 0), 8 iterations."""
    assert bp.messages_shared(60) > 0
    g = torch.Generator(device=card).manual_seed(60)
    l = torch.rand((1, 135, 240), device=card, generator=g) * 200.0
    r = torch.roll(l, -17, 2) + torch.rand((1, 135, 240), device=card,
                                           generator=g) * 5.0
    data = bp.data_cost(l, r, 0, 60)
    msgs = torch.zeros((4,) + tuple(data.shape), device=card)
    want = bp.bp_iterate(data, msgs, 8, JUMP, MAX_DISC, plain=True)
    _build.reset_launches()
    got = bp.bp_iterate(data, msgs, 8, JUMP, MAX_DISC)
    assert _build.LAUNCHES["bp_messages"] == 8
    assert torch.equal(got, want)


def test_a_frame_through_the_pipeline_equals_the_reference(card, graphs):
    """1920x1080 raw pairs of the cell through ``StereoPipeline``
    (rectify, CSBP, the speckle filter, the depth clamp) against the plain
    reference's frames: rectified images, disparities and the valid mask
    bit-equal in the eager call, the captured one and two replays of
    CSBP's CUDA graph; 24 ``bp_planes`` and 8 ``bp_messages`` launches a
    frame, the replays' counted from the capture."""
    from portbench import inputs, run
    from portbench.reference.pipeline import Reference

    config = json.loads(CONFIG.read_text())
    pool = inputs.make_frames(config, 2 ** 31 + 77, card)
    lg, pipe = run.launch(config, card)
    ref = Reference(config, card)
    stages = []
    for i in (0, 1, 2, 1):
        _build.reset_launches()
        res = pipe.process(pool.left[i], pool.right[i])
        launches = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        stages.append(graphs._held[graphs.keys()[-1]])
        assert launches["bp_planes"] == 24 and launches["bp_messages"] == 8
        assert launches["remap"] == 1 and launches["speckle_ccl"] >= 1
        want = ref.frame(pool.left[i], pool.right[i])
        assert torch.equal(res.rect_left, want["rect_left"])
        assert torch.equal(res.rect_right, want["rect_right"])
        assert torch.equal(res.disparity, want["disparity"])
        assert torch.equal(res.valid, want["valid"])
        assert 0.5 < float(res.valid.float().mean()) < 1.0
        assert bool((res.disparity.remainder(8) == 0).all())
        del want
    assert stages[0] is None and stages[1] is not None
    assert stages[3] is stages[2] is stages[1]


def test_the_replayed_graph_holds_a_constant_space(card, graphs):
    """Under the tracer a replayed frame's ``csbp.match`` span counts what
    the card holds for CSBP, the graph's pool included: above the stage
    spans' largest count in the eager frame, and under 1 GB (dense BP
    holds 21 GB at this size)."""
    from torch.profiler import ProfilerActivity, profile

    from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS
    from portbench import inputs, run

    config = json.loads(CONFIG.read_text())
    pool = inputs.make_frames(config, 2 ** 31 + 78, card)
    lg, pipe = run.launch(config, card)
    GLOBAL_METRICS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            with GLOBAL_METRICS.span("node.frame", stamp=float(i)):
                pipe.process(pool.left[i], pool.right[i])
    torch.cuda.synchronize()
    spans = GLOBAL_METRICS.spans()
    GLOBAL_METRICS.clear()
    match = {s.frame: s for s in spans if s.name == "csbp.match"}
    assert [match[f].attrs["graph"] for f in (0.0, 1.0, 2.0)] \
        == ["eager", "capture", "replay"]
    eager = max(s.attrs["held_bytes"] for s in spans
                if s.frame == 0.0 and s.name.startswith("csbp.")
                and s.name != "csbp.match")
    replay = match[2.0].attrs["held_bytes"]
    assert eager <= replay < 1e9
    assert not [s for s in spans if s.frame == 2.0
                and s.name.startswith("csbp.") and s.name != "csbp.match"]
