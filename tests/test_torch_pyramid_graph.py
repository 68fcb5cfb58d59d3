"""The pyramid's CUDA graphs, on the CPU: what keys a capture, the cache's
least-recently-used order, the route of CPU and ``plain`` calls (never a
capture), the cache's eager / capture / replay sequence with a stand-in
for the capture, a key whose eager call raises never captured, and the
backmatch thresholds compared in float32 without a copy to the device,
mask for mask as the former ``torch.as_tensor(max_diff,
dtype=torch.float32)`` form gave them."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.config.profile import quick_profile
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS

torch.set_num_threads(2)

MAX_DIFFS = (0.7, 1.3, 2.05, 0.1, 1.5)


def _cfg(**kw):
    base = dict(disparity_range=32, max_pyramid_level=2, speckle_size=0,
                backmatch_distance=1.5)
    return ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(**{**base, **kw})


def _on_card(shape=(64, 96), dtype=torch.float32, index=0):
    """What :func:`pyr.graph_key` reads of a CUDA tensor."""
    return SimpleNamespace(device=torch.device("cuda", index), shape=shape,
                           dtype=dtype)


def _key(cfg=None, profile=None, lean=False, plain=False, left=None,
         right=None):
    cfg = cfg or _cfg()
    return pyr.graph_key(left or _on_card(), right or _on_card(), cfg,
                         profile or pyr.profile_from_config(cfg), lean=lean,
                         plain=plain)


def test_equal_calls_give_equal_keys():
    a, b = _key(), _key()
    assert a is not None and a == b and hash(a) == hash(b)
    assert _key(lean=True) == _key(lean=True)
    assert _key(profile=quick_profile()) == _key(profile=quick_profile())


@pytest.mark.parametrize("change", [
    dict(cfg=_cfg(p1=0.2)),
    dict(cfg=_cfg(p2=0.9)),
    dict(cfg=_cfg(backmatch_distance=1.0)),
    dict(cfg=_cfg(speckle_size=50)),
    dict(profile=quick_profile()),
    dict(lean=True),
    dict(left=_on_card((2, 64, 96)), right=_on_card((2, 64, 96))),
    dict(left=_on_card(dtype=torch.uint8), right=_on_card(dtype=torch.uint8)),
    dict(left=_on_card(index=1), right=_on_card(index=1)),
])
def test_a_changed_input_gives_a_new_key(change):
    assert _key(**change) not in (None, _key())


def test_cpu_and_plain_have_no_key():
    cpu = torch.zeros(64, 96)
    assert pyr.graph_key(cpu, cpu, _cfg(), pyr.profile_from_config(_cfg()),
                         lean=False, plain=False) is None
    assert _key(plain=True) is None
    assert pyr.graph_key(_on_card(), cpu, _cfg(),
                         pyr.profile_from_config(_cfg()), lean=False,
                         plain=False) is None


class _Graph:
    """Stands in for a captured graph: counts replays and resets."""

    def __init__(self):
        self.replays = self.resets = 0

    def replay(self):
        self.replays += 1

    def reset(self):
        self.resets += 1


def test_the_cache_holds_four_keys_and_drops_the_least_recently_used():
    graphs = pyr.PyramidGraphs()
    assert pyr.GRAPH_KEYS == 4
    assert [graphs.stage(k) for k in "abcd"] == ["eager"] * 4
    assert graphs.stage("a") == "capture"        # a is now the newest
    assert graphs.stage("e") == "eager"          # b, the oldest use, goes
    assert graphs.keys() == ["c", "d", "a", "e"]
    assert graphs.stage("b") == "eager"          # b starts again
    assert graphs.keys() == ["d", "a", "e", "b"]
    g = _Graph()
    graphs._held["d"] = pyr._Captured(g, (), None, {})
    assert graphs.stage("d") == "replay"        # d is now the newest
    for k in "fgh":
        graphs.stage(k)
    assert graphs.keys() == ["d", "f", "g", "h"]
    assert g.resets == 0
    graphs.stage("i")
    assert g.resets == 1                         # its pool released


def test_eager_capture_replay(monkeypatch):
    """The cache's sequence with a stand-in capture: the first call eager,
    the second captured and replayed, later ones copy the images in and
    replay; every result a clone; a replay counts the captured launches."""
    graphs = pyr.PyramidGraphs()
    calls = []

    def match(l, r):
        calls.append((l, r))
        return MatchResult(disparity=l + r, valid=l > r)

    def capture(match, left, right):
        inputs = (left.clone(), right.clone())
        return pyr._Captured(_Graph(), inputs, match(*inputs),
                             {"census_cost": 4, "sgm_sweep": 12})

    monkeypatch.setattr(pyr, "_capture", capture)
    l0, r0 = torch.rand(8, 8), torch.rand(8, 8)
    first = graphs.run("k", l0, r0, match)
    assert len(calls) == 1 and calls[0][0] is l0
    second = graphs.run("k", l0, r0, match)
    cap = graphs._held["k"]
    assert len(calls) == 2 and cap.graph.replays == 1
    assert second.disparity.data_ptr() != cap.result.disparity.data_ptr()
    assert torch.equal(first.disparity, second.disparity)
    before = dict(_build.LAUNCHES)
    l1, r1 = torch.rand(8, 8), torch.rand(8, 8)
    third = graphs.run("k", l1, r1, match)
    assert len(calls) == 2 and cap.graph.replays == 2
    assert torch.equal(cap.inputs[0], l1) and torch.equal(cap.inputs[1], r1)
    assert _build.LAUNCHES["census_cost"] - before["census_cost"] == 4
    assert _build.LAUNCHES["sgm_sweep"] - before["sgm_sweep"] == 12
    cap.result.disparity.fill_(-1.0)
    cap.result.valid.fill_(False)
    assert torch.equal(third.disparity, second.disparity)
    assert third.valid.data_ptr() != cap.result.valid.data_ptr()
    assert third.valid.any()


def test_a_result_without_valid_replays_none(monkeypatch):
    graphs = pyr.PyramidGraphs()
    monkeypatch.setattr(pyr, "_capture", lambda match, l, r: pyr._Captured(
        _Graph(), (l.clone(), r.clone()), match(l, r), {}))
    match = lambda l, r: MatchResult(disparity=l.clone(), valid=None)
    x = torch.rand(4, 4)
    assert [graphs.run("k", x, x, match).valid for _ in range(3)] \
        == [None] * 3


def test_a_key_whose_eager_call_raises_is_never_captured(monkeypatch):
    """An eager call that raises leaves no key behind: the next call of
    the key runs eagerly again, under the cache's span name."""
    def refuse(*a, **kw):
        raise AssertionError("a failed key was captured")

    monkeypatch.setattr(pyr, "_capture", refuse)
    graphs = pyr.PyramidGraphs(span="csbp.match")
    assert graphs.span == "csbp.match"
    assert pyr.PyramidGraphs().span == "pyramid.match"

    def fails(l, r):
        raise ValueError("too small")

    x = torch.rand(4, 4)
    for _ in range(2):
        with pytest.raises(ValueError):
            graphs.run("k", x, x, fails)
        assert graphs.keys() == []
    GLOBAL_METRICS._on = True
    try:
        graphs.run("k", x, x, lambda l, r: MatchResult(l, None))
        spans = [s for s in GLOBAL_METRICS.spans() if s.name == "csbp.match"]
    finally:
        GLOBAL_METRICS.clear()
    assert graphs.keys() == ["k"]
    assert [s.attrs for s in spans] == [{"graph": "eager"}]


@pytest.fixture(scope="module")
def scene():
    sc = layered_scene(64, 96, max_disp=24, seed=3)
    return torch.from_numpy(sc.left), torch.from_numpy(sc.right)


def test_cpu_and_plain_never_capture(scene, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU or plain call reached the graphs")

    monkeypatch.setattr(pyr, "_capture", refuse)
    monkeypatch.setattr(pyr.GRAPHS, "run", refuse)
    held = pyr.GRAPHS.keys()
    l, r = scene
    cfg = _cfg()
    results = [pyr.pyramid_sgm_match(l, r, cfg) for _ in range(3)]
    results += [pyr.pyramid_sgm_match(l, r, cfg, plain=True),
                pyr.pyramid_sgm_match(l, r, cfg, lean=True)]
    assert pyr.GRAPHS.keys() == held
    for res in results[1:4]:
        assert torch.equal(res.disparity, results[0].disparity)
        assert torch.equal(res.valid, results[0].valid)


def test_the_match_span_says_eager_on_the_cpu(scene):
    l, r = scene
    GLOBAL_METRICS._on = True
    try:
        pyr.pyramid_sgm_match(l, r, _cfg())
        spans = GLOBAL_METRICS.spans()
    finally:
        GLOBAL_METRICS.clear()
    match = [s for s in spans if s.name == "pyramid.match"]
    assert [s.attrs for s in match] == [{"graph": "eager"}]
    levels = [s for s in spans if s.name == "pyramid.level"]
    assert levels and all(s.parent == match[0].id for s in levels)


def _near(md: float, n: int = 4) -> np.ndarray:
    """float32 values around float32(md): ``n`` ulps each side."""
    v = np.float32(md)
    out = [v]
    lo = hi = v
    for _ in range(n):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return np.array(out, dtype=np.float32)


def _old_backmatch(valid, bm, max_diff, K):
    """``_backmatch_check_true`` with the threshold as a float32 tensor,
    as it was."""
    r_res, valid_p, d_r, v_r, bpm = bm
    B, Hh, Wh = valid.shape
    _, Hp, Wp = r_res.shape
    K8 = pyr._ceil_to(max(K, 8), 8)
    rr_int = torch.round(r_res).to(torch.int32)
    q = torch.full((B, Hp // 8, (Wp + 127) // 128), int(bpm) + K8 // 2,
                   dtype=torch.int32)
    d_r_m = torch.where(v_r, d_r, 1.0e9)
    d_at = pyr.block_shift_gather_plain(d_r_m, rr_int, q,
                                        K8 // 2 + 1)[:, :Hh, :Wh]
    xs = torch.arange(Wh, dtype=torch.int32)
    xw = xs - rr_int[:, :Hh, :Wh]
    in_w = (xw >= 0) & (xw < Wh)
    max_diff = torch.as_tensor(max_diff, dtype=torch.float32)
    consistent = (d_at - r_res[:, :Hh, :Wh]).abs() <= max_diff
    return valid & in_w & consistent


def _old_roundtrip(disp, valid, max_diff):
    W = disp.shape[-1]
    d_int = torch.round(disp).to(torch.int64)
    xr = torch.arange(W, dtype=torch.int64) - d_int
    in_img = (xr >= 0) & (xr < W)
    xr_c = xr.clamp(0, W - 1)
    src = torch.where(valid & in_img, disp, -1.0e9)
    d_right = torch.full_like(disp, -1.0e9).scatter_reduce_(
        2, xr_c, src, "amax", include_self=True)
    max_diff = torch.as_tensor(max_diff, dtype=torch.float32)
    consistent = (d_right.gather(2, xr_c) - disp).abs() <= max_diff
    return valid & in_img & consistent


@pytest.mark.parametrize("max_diff", MAX_DIFFS)
def test_backmatch_threshold_as_before(max_diff):
    """Residuals whose distance from the right disparity lies within a few
    float32 ulps of the threshold, on both sides: the same mask."""
    K, bpm, Hp, Wp = 31, -16, 8, 128
    g = torch.Generator().manual_seed(int(max_diff * 100))
    d_r = (bpm + torch.randint(0, 32, (1, Hp, Wp), generator=g)).float()
    # a constant right disparity along each row: the lookup lands on it
    d_r = d_r[:, :, :1].expand(1, Hp, Wp).contiguous()
    steps = torch.from_numpy(_near(max_diff))
    pick = torch.randint(0, len(steps), (1, Hp, Wp), generator=g)
    sign = torch.where(torch.rand(1, Hp, Wp, generator=g) < 0.5, -1.0, 1.0)
    r_res = d_r + sign * steps[pick]
    v_r = torch.rand(1, Hp, Wp, generator=g) < 0.9
    valid = torch.ones(1, Hp, Wp - 8, dtype=torch.bool)
    bm = (r_res, r_res > -1e8, d_r, v_r, bpm)
    new = pyr._backmatch_check_true(valid, bm, max_diff, K, plain=True)
    old = _old_backmatch(valid, bm, max_diff, K)
    assert torch.equal(new, old)
    assert 0 < int(new.sum()) < new.numel()


@pytest.mark.parametrize("max_diff", MAX_DIFFS)
def test_roundtrip_threshold_as_before(max_diff):
    """Pairs of pixels whose disparities differ by a few ulps around the
    threshold, each pair the only one landing on its right column: the
    same mask."""
    g = torch.Generator().manual_seed(int(max_diff * 1000))
    B, H, W = 1, 8, 96
    steps = torch.from_numpy(_near(max_diff))
    base = torch.randint(8, 40, (B, H, 1), generator=g).float()
    disp = base.expand(B, H, W).clone()
    # every other column nudged by a threshold-sized step
    pick = torch.randint(0, len(steps), (B, H, W), generator=g)
    disp[..., 1::2] += steps[pick[..., 1::2]]
    valid = torch.rand(B, H, W, generator=g) < 0.95
    new = pyr._roundtrip_check(disp, valid, max_diff)
    old = _old_roundtrip(disp, valid, max_diff)
    assert torch.equal(new, old)
    assert 0 < int(new.sum()) < new.numel()


class _SummingGraph:
    """Stands in for a captured graph whose replay recomputes its result
    from its static inputs, as a real replay does."""

    def __init__(self, inputs, result):
        self.inputs, self.result = inputs, result

    def replay(self):
        torch.add(*self.inputs, out=self.result.disparity)

    def reset(self):
        pass


def test_threads_sharing_the_cache_get_their_own_results(monkeypatch):
    """More threads than cores call the cache on a few keys with a short
    switch interval: every result is the sum of that call's own images,
    which a replay interleaved with another call's input copies would
    break; the cache never holds more than its ``GRAPH_KEYS`` keys."""
    import sys
    import threading

    def capture(match, left, right):
        inputs = (left.clone(), right.clone())
        result = match(*inputs)
        return pyr._Captured(_SummingGraph(inputs, result), inputs, result,
                             {})

    monkeypatch.setattr(pyr, "_capture", capture)
    graphs = pyr.PyramidGraphs()
    match = lambda l, r: MatchResult(disparity=l + r, valid=None)
    wrong, sizes = [], []

    def worker(seed):
        g = torch.Generator().manual_seed(seed)
        for _ in range(150):
            key = int(torch.randint(0, 6, (1,), generator=g))
            l, r = torch.rand(16, 16, generator=g), torch.rand(16, 16,
                                                              generator=g)
            got = graphs.run(key, l, r, match)
            if not torch.equal(got.disparity, l + r):
                wrong.append(key)
            sizes.append(len(graphs.keys()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong and len(sizes) == 16 * 150
    assert max(sizes) == pyr.GRAPH_KEYS
