"""The graph node's copies of its outputs through page-locked buffers, on
the card at the flagship's 2448x2048: a frame's eight published arrays
bit-equal to ``.cpu()`` of the same tensors; a frame's arrays held across
four more frames unchanged; after warm-up every copied byte lands in a
buffer the pool already held.

Marked ``card``: each test skips without a CUDA device. On a machine with
one, from the repository's root (``--noconftest``: tests/conftest.py sets
up JAX, which the card's machine need not have)::

    python -m pytest --noconftest -m card tests/test_torch_node_copies_card.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_matcher
from i3dr_stereo_tpu_torch.config.params import Algorithm
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.utils.metrics import GLOBAL_METRICS

pytestmark = pytest.mark.card

H, W = 2048, 2448
TOPICS = ("left/image_rect", "right/image_rect", "disparity", "depth",
          "points2")


def _arrays(got: dict) -> list:
    """A frame's published arrays in the node's order."""
    d, p = got["disparity"], got["points2"]
    return [got["left/image_rect"], got["right/image_rect"], d["disparity"],
            d["valid"], got["depth"], *p.values()]


@pytest.fixture(scope="module")
def graph():
    """The flagship graph on the card and a frame's publisher: the pair
    ``i`` (the scene rolled along x by ``i``) through it, its published
    arrays and the node's own result tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lg = launch_stereo_matcher(
        StereoRig.synthetic(W, H, fx=580.0, baseline_m=0.3),
        stereo_algorithm=Algorithm.I3DRSGM, device="cuda")
    node = lg.node("generate_disparity")
    got = {}
    for t in TOPICS:
        lg.graph.subscribe(f"/stereo/{t}",
                           lambda s, d, t=t: got.__setitem__(t, d))
    sc = layered_scene(H, W, max_disp=200, background_disp=16, layers=6,
                       seed=1)
    raw = [np.clip(x, 0, 255).astype(np.uint8) for x in (sc.left, sc.right)]

    def frame(i):
        got.clear()
        for side, img in zip(("left", "right"), raw):
            lg.graph.publish(f"/stereo/{side}/image_raw", float(i),
                             np.roll(img, 37 * i, axis=1))
        assert set(got) == set(TOPICS)
        res = node._last[3]
        return _arrays(got), [res.rect_left, res.rect_right, res.disparity,
                              res.valid, res.depth, *res.points.values()]
    yield frame
    GLOBAL_METRICS.clear()


def test_a_frame_is_bit_equal_to_cpu(graph):
    arrays, tensors = graph(0)
    assert len(arrays) == 8
    for a, x in zip(arrays, tensors):
        want = x.cpu().numpy()
        assert a.dtype == want.dtype and a.shape == want.shape
        assert np.array_equal(a, want)


def test_held_arrays_survive_four_more_frames(graph):
    held, tensors = graph(1)
    want = [x.cpu().numpy() for x in tensors]
    del tensors
    for i in range(2, 6):
        arrays, _ = graph(i)
        for a in arrays:
            assert not any(np.shares_memory(a, h) for h in held)
    for h, w in zip(held, want):
        assert np.array_equal(h, w)


def test_every_byte_reuses_a_held_buffer_after_warm_up(graph):
    for i in range(3):
        graph(i)
    GLOBAL_METRICS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        graph(3)                 # spans are recorded from here on
    for i in range(4, 8):
        graph(i)
    copies = [s.attrs for s in GLOBAL_METRICS.spans()
              if s.name == "node.copy"]
    GLOBAL_METRICS.clear()
    assert len(copies) == 5 * 8 and all(c["pinned"] == 1 for c in copies)
    copied = sum(c["bytes"] for c in copies)
    assert copied == 5 * 210567168
    assert 100.0 * (1 - sum(c["fresh"] for c in copies) / copied) == 100.0
