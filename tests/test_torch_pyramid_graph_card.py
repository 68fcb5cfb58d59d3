"""The pyramid replayed as a CUDA graph, on the card at the flagship's
2448x2048: on 4 distinct frames the replayed result is bit-equal to the
eager match, for the flagship configuration, its lean branch, its WLS
fill, and the facade's quick and subpix profiles; a frame's result keeps
its values across the next replay; a replayed frame counts the kernel
launches an eager one does and names the SGM stage's kernels in a
profiler trace; a live ``update_config`` captures again and replays the
new values.

Marked ``card``: each test skips without a CUDA device. On a machine with
one, from the repository's root (``--noconftest``: tests/conftest.py sets
up JAX, which the card's machine need not have)::

    python -m pytest --noconftest -m card tests/test_torch_pyramid_graph_card.py
"""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.config.profile import (quick_profile,
                                                  subpix_profile)
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
from i3dr_stereo_tpu_torch.matchers.i3drsgm import I3DRSGM
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS

pytestmark = pytest.mark.card

H, W = 2048, 2448
FRAMES = 4
CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" \
    / "i3drsgm_2448.json"


def flagship_cfg():
    """The flagship cell's matcher configuration, as the benchmark runs
    it."""
    from portbench.run import program_config

    return program_config(json.loads(CONFIG.read_text())["matcher"])


@pytest.fixture(scope="module")
def frames():
    """``FRAMES`` rectified float32 pairs on the card: the cell's layered
    scene, rolled along x by 37 px a frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sc = layered_scene(H, W, max_disp=900, background_disp=416, layers=6,
                       seed=1)
    l = torch.tensor(sc.left, device="cuda")
    r = torch.tensor(sc.right, device="cuda")
    return [(l.roll(37 * i, -1).contiguous(), r.roll(37 * i, -1).contiguous())
            for i in range(FRAMES)]


@pytest.fixture(autouse=True)
def graphs(monkeypatch):
    """A cache of graphs of the test's own, and the spans recorded."""
    monkeypatch.setattr(pyr, "GRAPHS", pyr.PyramidGraphs())
    GLOBAL_METRICS.clear()
    GLOBAL_METRICS._on = True
    yield pyr.GRAPHS
    GLOBAL_METRICS.clear()


def _case(name):
    """(match, eager) for a case: the call as its users make it, and the
    same match run eagerly on the card."""
    if name in ("quick", "subpix"):
        facade = I3DRSGM(profile=quick_profile() if name == "quick"
                         else subpix_profile(), device="cuda")
        return facade.match, lambda l, r: pyr._match(
            l, r, cfg=facade.config, profile=facade.profile, lean=False,
            plain=False)
    cfg = flagship_cfg()
    if name == "wls":
        cfg = cfg.replace(interp=True)
    lean = name == "lean"
    return (lambda l, r: pyr.pyramid_sgm_match(l, r, cfg, lean=lean),
            lambda l, r: pyr._match(l, r, cfg=cfg,
                                    profile=pyr.profile_from_config(cfg),
                                    lean=lean, plain=False))


def _equal(a, b) -> bool:
    if (a.valid is None) != (b.valid is None):
        return False
    return torch.equal(a.disparity, b.disparity) and (
        a.valid is None or torch.equal(a.valid, b.valid))


def _stages() -> list:
    return [s.attrs["graph"] for s in GLOBAL_METRICS.spans()
            if s.name == "pyramid.match"]


def _launches(fn) -> dict:
    _build.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: n for k, n in _build.LAUNCHES.items() if n}


@pytest.mark.parametrize("name", ["flagship", "lean", "wls", "quick",
                                  "subpix"])
def test_replay_is_bit_equal_to_eager(frames, graphs, name):
    match, eager = _case(name)
    l0, r0 = frames[0]
    assert _equal(match(l0, r0), eager(l0, r0))     # eager
    assert _equal(match(l0, r0), eager(l0, r0))     # captured, replayed
    prev = None
    for l, r in frames:
        got = match(l, r)
        want = eager(l, r)
        assert _equal(got, want)
        if prev is not None:
            # the previous frame's tensors kept their values
            assert _equal(prev[0], prev[1])
        prev = (got, want)
    stages = _stages()
    assert stages == ["eager", "capture"] + ["replay"] * FRAMES
    assert len(graphs.keys()) == 1
    # pyramid.level spans come from the host's per-level work: eager and
    # captured frames only (the eager reference's own levels have no
    # pyramid.match around them)
    by_match = {s.id: s.attrs["graph"] for s in GLOBAL_METRICS.spans()
                if s.name == "pyramid.match"}
    level_parents = [by_match[s.parent] for s in GLOBAL_METRICS.spans()
                     if s.name == "pyramid.level" and s.parent in by_match]
    assert set(level_parents) == {"eager", "capture"}


@pytest.mark.parametrize("name", ["flagship", "lean"])
def test_a_replay_counts_the_launches_of_an_eager_frame(frames, name):
    match, eager = _case(name)
    l, r = frames[1]
    want = _launches(lambda: eager(l, r))
    assert _launches(lambda: match(l, r)) == want      # eager
    assert _launches(lambda: match(l, r)) == want      # captured
    assert _launches(lambda: match(l, r)) == want      # replayed
    assert want["census_transform"] > 0 and len(want) >= 4
    assert _stages() == ["eager", "capture", "replay"]


def test_a_replay_names_the_sgm_stage_kernels(frames):
    match, _ = _case("flagship")
    l, r = frames[2]
    for _ in range(3):
        match(l, r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        match(l, r)
        torch.cuda.synchronize()
    assert _stages()[-1] == "replay"
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    for kernel in ("census_cost_kernel", "sgm_sweep_kernel",
                   "census_fixed_kernel", "row_gather_kernel"):
        assert any(kernel in n for n in names), (kernel, sorted(names)[:40])


def test_update_config_captures_again(frames, graphs):
    cfg = flagship_cfg()
    pipe = StereoPipeline(StereoRig.synthetic(W, H, fx=580.0,
                                              baseline_m=0.3),
                          cfg, device="cuda", rectify_inputs=False,
                          compute_points=False)
    l, r = frames[3]
    old = [pipe.process(l, r) for _ in range(3)]
    pipe.update_config(p1=0.2, p2=1.1)
    new_cfg = pipe.config
    new = [pipe.process(l, r) for _ in range(3)]
    assert _stages() == ["eager", "capture", "replay"] * 2
    assert len(graphs.keys()) == 2
    want = pyr._match(l, r, cfg=new_cfg,
                      profile=pyr.profile_from_config(new_cfg), lean=False,
                      plain=False)
    for res in new:
        assert torch.equal(res.disparity, want.disparity)
    # the new penalties reached the kernels
    assert not torch.equal(new[2].disparity, old[2].disparity)
