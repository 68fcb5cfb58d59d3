"""Dense BP (``matchers/bp.py``) against the benchmark's plain reference
(``portbench/reference/matchers/BP_GPU.py``) on the CPU at tiny sizes,
with no JAX: the reference equals the port's twin bit for bit, its
row-slab schedule equals one whole-volume iteration, the graph launched
with the ``bp_1920`` block (scaled down) publishes what the reference
works out, the port's memory repairs leave every value as the plain forms
give it, and the ``bp.*`` spans are recorded, with their attributes, only
while the tracer records."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.matchers import bp
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS
from portbench import check, inputs, load
from portbench.reference.matchers import BP_GPU
from portbench.reference.pipeline import Reference

torch.set_num_threads(2)

CONFIG = Path(__file__).resolve().parents[1] / "portbench/configs/bp_1920.json"
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


# ---------------------------------------------------------------------------
# the reference against the port's twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,min_d,subpixel", [
    (48, 80, 0, False),     # the cell's form: from 0, whole disparities
    (47, 80, 0, False),     # an odd height: _pool2 crops level 0's last row
    (45, 78, 5, True),      # odd both ways, a minimum, the subpixel step
])
def test_reference_equals_the_twin(H, W, min_d, subpixel):
    l, r = _pair(H, W, 7, seed=H * W + min_d)
    cfg = ALGORITHM_DEFAULTS[Algorithm.BP_GPU].replace(
        min_disparity=min_d, disparity_range=32, bp_levels=3, bp_iters=2,
        subpixel=subpixel)
    got = bp.belief_propagation_match(l, r, cfg, constant_space=False,
                                      plain=True)
    disp, valid = BP_GPU.match(l, r, _block(cfg))
    assert torch.equal(_bits(got.disparity), _bits(disp))
    assert torch.equal(got.valid, valid)
    assert len(BP_GPU.pyramid(torch.zeros(1, 1, H, W), 3)) == 3


@pytest.mark.parametrize("rows", [1, 2, 5, 12, 13, 40])
def test_row_slabs_equal_one_whole_volume_iteration(rows):
    g = torch.Generator().manual_seed(rows)
    data = torch.rand((1, 16, 13, 9), generator=g)
    msgs = torch.randn((4, 1, 16, 13, 9), generator=g)
    whole = bp.bp_iterate_plain(data, msgs, 3, JUMP, MAX_DISC)
    slabs = BP_GPU.iterate(data, msgs.clone(), 3, rows)
    assert torch.equal(_bits(whole), _bits(slabs))


def test_slab_rows_fit_the_budget():
    assert BP_GPU.slab_rows(480, 1920) == 143
    assert 4 * 480 * (BP_GPU.slab_rows(480, 1920) + 2) * 1920 \
        <= BP_GPU.SLAB_BYTES
    assert BP_GPU.slab_rows(10 ** 6, 10 ** 6) == 1


# ---------------------------------------------------------------------------
# the graph with the cell's block, scaled down
# ---------------------------------------------------------------------------

def _tiny_config() -> dict:
    cfg = json.loads(CONFIG.read_text())
    W, H, f = 160, 96, 160.0
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
    assert config["matcher"]["algorithm"] == "BP_GPU"
    assert config["matcher"]["min_disparity"] == 0
    pool = inputs.make_frames(config, 2 ** 31 + 3, "cpu")
    lg, pipe = launch(config, torch.device("cpu"))
    assert pipe.config.bp_levels == 5 and pipe.config.bp_iters == 5
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
# the memory repairs keep every value
# ---------------------------------------------------------------------------

def _upsample_by_repeats(m, H, W):
    """The nearest x2 upsampling as two ``repeat_interleave``s."""
    reps = m.repeat_interleave(2, -2).repeat_interleave(2, -1)
    out = m.new_zeros(m.shape[:-2] + (H, W))
    h, w = min(H, reps.shape[-2]), min(W, reps.shape[-1])
    out[..., :h, :w] = reps[..., :h, :w]
    return out


@pytest.mark.parametrize("h,w,H,W", [(4, 5, 8, 10), (4, 5, 9, 11),
                                     (3, 3, 5, 6), (4, 6, 7, 11),
                                     (1, 1, 1, 1)])
def test_upsampling_in_place_equals_the_repeats(h, w, H, W):
    m = torch.randn((4, 1, 3, h, w), generator=torch.Generator()
                    .manual_seed(h * w))
    assert torch.equal(bp._upsample_msgs(m, H, W),
                       _upsample_by_repeats(m, H, W))
    assert torch.equal(BP_GPU.upsample(m, H, W),
                       _upsample_by_repeats(m, H, W))


def test_the_belief_in_place_equals_the_stacked_sum():
    g = torch.Generator().manual_seed(8)
    data = bp.data_cost(*_pair(11, 17, 3, seed=8), 0, 9)
    msgs = torch.randn((4,) + tuple(data.shape), generator=g)
    msgs[:, :, :, 0] = 0.0
    inc = bp._incoming(msgs)
    want = data + inc[0] + inc[1] + inc[2] + inc[3]
    assert torch.equal(_bits(bp._belief(data, msgs)), _bits(want))


def test_a_donated_buffer_is_reused_and_an_undonated_one_kept():
    g = torch.Generator().manual_seed(4)
    data = torch.rand((1, 8, 5, 6), generator=g)
    msgs = torch.randn((4, 1, 8, 5, 6), generator=g)
    want = bp.bp_iterate_plain(data, msgs, 5, JUMP, MAX_DISC)
    written = []

    def launch(src, dst):
        written.append(dst.data_ptr())
        dst.copy_(bp.bp_iterate_plain(data, src, 1, JUMP, MAX_DISC))

    # one launch leaves the caller's buffer as it was (what the timing
    # loops rely on); from the second on, it is the second buffer
    kept = msgs.clone()
    out = bp._ping_pong(msgs, 1, launch)
    assert torch.equal(out, bp.bp_iterate_plain(data, msgs, 1, JUMP,
                                                MAX_DISC))
    assert torch.equal(msgs, kept) and msgs.data_ptr() not in written
    written.clear()
    out = bp._ping_pong(msgs, 5, launch)
    assert torch.equal(out, want)
    assert len(set(written)) == 2 and written[1::2] == [msgs.data_ptr()] * 2


# ---------------------------------------------------------------------------
# the spans
# ---------------------------------------------------------------------------

def _match(cfg, H=40, W=64):
    l, r = _pair(H, W, 6, seed=1)
    return bp.belief_propagation_match(l[0], r[0], cfg,
                                       constant_space=False)


def test_the_spans_record_only_under_the_tracer():
    cfg = ALGORITHM_DEFAULTS[Algorithm.BP_GPU].replace(
        disparity_range=32, bp_levels=3, bp_iters=2)
    GLOBAL_METRICS.clear()
    _match(cfg)
    assert GLOBAL_METRICS.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with GLOBAL_METRICS.span("node.frame", stamp=7.0):
            _match(cfg)
    spans = [s for s in GLOBAL_METRICS.spans() if s.name.startswith("bp.")]
    GLOBAL_METRICS.clear()
    names = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
    assert names == ["bp.data_cost"] + ["bp.level"] * 3 + ["bp.belief"]
    assert all(s.frame == 7.0 for s in spans)
    (cost,) = [s for s in spans if s.name == "bp.data_cost"]
    assert cost.attrs == {"D": 32, "H": 40, "W": 64}
    levels = sorted((s for s in spans if s.name == "bp.level"),
                    key=lambda s: s.start_ns)
    assert [s.attrs for s in levels] == [
        {"level": lv, "H": h, "W": w, "iters": 2, "bytes": 4 * 32 * h * w * 4}
        for lv, h, w in ((2, 10, 16), (1, 20, 32), (0, 40, 64))]
    # held_bytes counts the card's allocator, so a CPU run has none
    assert not any("held_bytes" in s.attrs for s in spans)


def test_held_bytes_is_the_allocators_count_on_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 12345)
    GLOBAL_METRICS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with GLOBAL_METRICS.span("bp.level") as on_card:
            bp._held(on_card, torch.device("cuda"))
        with GLOBAL_METRICS.span("bp.level") as on_cpu:
            bp._held(on_cpu, torch.device("cpu"))
    got = [s.attrs for s in GLOBAL_METRICS.spans()]
    GLOBAL_METRICS.clear()
    assert got == [{"held_bytes": 12345}, {}]
    off = GLOBAL_METRICS.span("bp.level")
    bp._held(off, torch.device("cuda"))       # no tracer: nothing, no read
    assert GLOBAL_METRICS.spans() == []
