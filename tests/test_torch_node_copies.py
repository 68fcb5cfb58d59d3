"""The graph node's pool of page-locked buffers (``bridge/pinned.py``) on
the CPU, its allocator given ordinary host memory: an array a subscriber
keeps is never written while it is alive, whatever view of it is kept;
buffers come back once their arrays are gone, the pool grows while arrays
are held and keeps at most ``FREE_PER_KEY`` idle a key; arrays dropped on
other threads give their buffers back safely. The node's CPU route still
publishes ``to_numpy``'s arrays under eight ``node.copy`` spans."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from i3dr_stereo_tpu_torch.bridge import pinned
from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_matcher
from i3dr_stereo_tpu_torch.bridge.pinned import FREE_PER_KEY, PinnedPool
from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS

H, W = 24, 32
# a frame's outputs in the node's order: the rectified pair, disparity,
# valid, depth, the cloud's xyz, valid and rgb
SHAPES = [((H, W), torch.float32)] * 3 + [((H, W), torch.bool),
                                          ((H, W), torch.float32),
                                          ((H * W, 3), torch.float32),
                                          ((H * W,), torch.bool),
                                          ((H * W, 3), torch.float32)]


class Host:
    """Ordinary host memory in the pool's place, counting allocations."""

    def __init__(self):
        self.calls = 0

    def __call__(self, shape, dtype):
        self.calls += 1
        return torch.empty(shape, dtype=dtype)


def outputs(i: int) -> list:
    """Frame ``i``'s eight outputs, each filled from ``i``."""
    g = torch.Generator().manual_seed(i)
    return [torch.rand(s, generator=g) > 0.5 if d == torch.bool
            else torch.rand(s, generator=g) * 255 for s, d in SHAPES]


def copy_frame(pool, i):
    """Frame ``i`` through the pool: its arrays and fresh bytes."""
    got = [pool.copy(x) for x in outputs(i)]
    return [a for a, _ in got], sum(f for _, f in got)


def nbytes() -> int:
    return sum(x.numel() * x.element_size() for x in outputs(0))


def assert_disjoint(arrays):
    for i, a in enumerate(arrays):
        for b in arrays[i + 1:]:
            assert not np.shares_memory(a, b)


@pytest.mark.parametrize("hold", [
    lambda a: a,
    lambda a: a.reshape(-1)[1:],
    lambda a: a[..., ::2].T,
    torch.from_numpy,
    memoryview,
], ids=["array", "flat_view", "strided_view", "torch_from_numpy",
        "memoryview"])
def test_a_kept_array_is_never_written(hold):
    pool = PinnedPool(Host())
    first, _ = copy_frame(pool, 0)
    kept = [hold(a) for a in first]
    want = [np.array(np.asarray(k)) for k in kept]
    del first
    live = []
    for i in range(1, 6):
        live, _ = copy_frame(pool, i)
        for a, x in zip(live, outputs(i)):
            np.testing.assert_array_equal(a, x.numpy())
        held = [np.asarray(k) for k in kept]
        assert_disjoint(held + live)
        del held
    for k, w in zip(kept, want):
        np.testing.assert_array_equal(np.asarray(k), w)


def drop(held, i, arrays):
    pass


def latch(held, i, arrays):
    """The graph's topics, which keep their last message."""
    held["latch"] = arrays


def latch_and_reservoir(held, i, arrays):
    """The latch, and a subscriber keeping one frame that it replaces now
    and then (the benchmark's reservoir): a kept frame and the latched one
    can come back together."""
    if i % 3 == 0:
        held["kept"] = arrays
    held["latch"] = arrays


@pytest.mark.parametrize("consume", [drop, latch, latch_and_reservoir])
def test_buffers_are_reused_once_dropped(consume):
    alloc = Host()
    pool = PinnedPool(alloc)
    held = {}
    for i in range(6):
        consume(held, i, copy_frame(pool, i)[0])
    warm = alloc.calls
    assert warm == len(SHAPES) * (1 + len(set(map(id, held.values()))))
    copied = reused = 0
    for i in range(6, 18):
        arrays, fresh = copy_frame(pool, i)
        copied += sum(a.nbytes for a in arrays)
        reused += sum(a.nbytes for a in arrays) - fresh
        assert fresh == 0
        consume(held, i, arrays)
        del arrays
    assert alloc.calls == warm
    assert 100.0 * reused / copied == 100.0


def test_the_pool_grows_while_held_and_keeps_its_cap_idle():
    alloc = Host()
    pool = PinnedPool(alloc)
    held = []
    for i in range(3):
        arrays, fresh = copy_frame(pool, i)
        assert fresh == nbytes()
        held.append(arrays)
    assert alloc.calls == 3 * len(SHAPES) and pool.idle == 0
    assert_disjoint([a for f in held for a in f])
    per_key = collections.Counter(SHAPES)
    del arrays
    held.clear()
    assert pool.idle == sum(min(FREE_PER_KEY, 3 * n)
                            for n in per_key.values())
    assert max(per_key.values()) <= FREE_PER_KEY
    _, fresh = copy_frame(pool, 3)
    assert fresh == 0


def test_arrays_dropped_on_other_threads_give_buffers_back_safely():
    """Frames taken on this thread while worker threads drop the arrays of
    earlier ones, the interpreter switching threads often: every live
    array keeps its own buffer and its values, and each buffer is back
    once."""
    pool = PinnedPool(Host())
    hand = [[] for _ in range(6)]
    lock = threading.Lock()
    stop = threading.Event()

    def dropper(j):
        while not stop.is_set() or hand[j]:
            with lock:
                batch, hand[j][:] = list(hand[j]), []
            del batch

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    workers = [threading.Thread(target=dropper, args=(j,))
               for j in range(len(hand))]
    try:
        for t in workers:
            t.start()
        for i in range(60):
            arrays, _ = copy_frame(pool, i)
            for a, x in zip(arrays, outputs(i)):
                np.testing.assert_array_equal(a, x.numpy())
            with lock:
                live = arrays + [a for h in hand for a in h]
                assert_disjoint(live)
                hand[i % len(hand)].extend(arrays)
            del arrays, live
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in workers)
    bufs = [b for free in pool._free.values() for b in free]
    assert len({b.data_ptr() for b in bufs}) == len(bufs)
    assert all(len(v) <= FREE_PER_KEY for v in pool._free.values())


def test_page_locked_asks_torch_for_pinned_memory(monkeypatch):
    seen = {}

    def empty(shape, dtype, pin_memory):
        seen.update(shape=shape, dtype=dtype, pin_memory=pin_memory)
        return torch.zeros(shape, dtype=dtype)
    monkeypatch.setattr(pinned.torch, "empty", empty)
    assert pinned.page_locked((2, 3), torch.bool).shape == (2, 3)
    assert seen == dict(shape=(2, 3), dtype=torch.bool, pin_memory=True)


def test_the_cpu_route_publishes_to_numpys_arrays():
    """On the CPU the node copies nothing into the pool: each published
    array is ``to_numpy`` of the frame's tensor (its memory), under eight
    ``node.copy`` spans that carry no ``pinned``."""
    cfg = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=32, max_pyramid_level=2, pyramid=True)
    lg = launch_stereo_matcher(
        StereoRig.synthetic(96, 64, fx=100.0, baseline_m=0.3),
        stereo_algorithm=Algorithm.I3DRSGM, config=cfg, warmup=False,
        device="cpu")
    node = lg.node("generate_disparity")
    got = {}
    for t in ("left/image_rect", "right/image_rect", "disparity", "depth",
              "points2"):
        lg.graph.subscribe(f"/stereo/{t}",
                           lambda s, d, t=t: got.__setitem__(t, d))
    sc = layered_scene(64, 96, max_disp=12, seed=9)
    GLOBAL_METRICS.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            lg.graph.publish("/stereo/left/image_raw", 1.0, sc.left)
            lg.graph.publish("/stereo/right/image_raw", 1.0, sc.right)
        copies = [s for s in GLOBAL_METRICS.spans() if s.name == "node.copy"]
    finally:
        GLOBAL_METRICS.clear()
    res = node._last[3]
    pairs = [(got["left/image_rect"], res.rect_left),
             (got["right/image_rect"], res.rect_right),
             (got["disparity"]["disparity"], res.disparity),
             (got["disparity"]["valid"], res.valid),
             (got["depth"], res.depth)] + [
        (got["points2"][k], v) for k, v in res.points.items()]
    assert len(pairs) == len(copies) == 8
    for a, x in pairs:
        assert isinstance(a, np.ndarray) and np.shares_memory(a, x.numpy())
    assert all("pinned" not in s.attrs and "fresh" not in s.attrs
               for s in copies)
    assert node._pinned.idle == 0
