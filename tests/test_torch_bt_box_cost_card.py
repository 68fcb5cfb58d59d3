"""The ``bt_box_cost`` kernel on the card: bit-equal to its plain twin
(``box_aggregate(*bt_cost_volume(...))``, which tests/test_torch_cost.py
holds to the JAX package), and SGBM's one launch of it a match.

Marked ``card``: each test skips without a CUDA device. On a machine with
one, from the repository's root (``--noconftest``: tests/conftest.py sets
up JAX, which the card's machine need not have)::

    python -m pytest --noconftest -m card tests/test_torch_bt_box_cost_card.py

No JAX here: the twin is the yardstick."""

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.config import params
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.matchers import registry
from i3dr_stereo_tpu_torch.ops import cost

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _twin(left, right, min_d, D, window):
    return cost.box_aggregate(*cost.bt_cost_volume(left, right, min_d, D),
                              window)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("min_d", [0, 5, 40])
@pytest.mark.parametrize("window", [1, 3, 5, 9, 11, 13, 15, 17, 19, 21])
@pytest.mark.parametrize("kind", ["int", "frac"])
def test_kernel_equals_twin(card, kind, window, min_d, B):
    """The shapes of the CPU test: 21x75, D = 40, min_d = 40 leaving whole
    tiles of the kernel with no valid pairing. Windows of 19 and wider take
    the kernel's two passes."""
    rng = np.random.default_rng(100 * window + min_d + B)
    a = rng.uniform(0, 62, (2, B, 21, 75))
    if kind == "int":
        a = np.round(a)
    left, right = (torch.tensor(x, dtype=torch.float32, device=card)
                   for x in a)
    _build.reset_launches()
    got = cost.bt_box_cost_volume(left, right, min_d, 40, window)
    assert _build.LAUNCHES["bt_box_cost"] == 1
    assert torch.equal(got, _twin(left, right, min_d, 40, window))


@pytest.mark.parametrize("window", [9, 15, 21])
def test_full_frame_equals_twin(card, window):
    """One 1920x1080 frame of the sgbm_1920 cell's matcher: 480 disparities
    from 147, the cell's window 9, 15 (one pass, r = 7) and 21 (two
    passes), the x-Sobel prefilter (cap 31) of a scene resampled a fraction
    of a pixel, so the costs are fractional."""
    sc = layered_scene(1080, 1920, max_disp=600, background_disp=160,
                       layers=6, seed=5)
    lf, rf = (cost.xsobel_prefilter(
        0.37 * t + 0.63 * torch.roll(t, 1, -1), 31).contiguous()
        for t in (torch.tensor(img, dtype=torch.float32, device=card)[None]
                  for img in (sc.left, sc.right)))
    got = cost.bt_box_cost_volume(lf, rf, 147, 480, window)
    assert got.shape == (1, 1080, 1920, 480)
    ref = _twin(lf, rf, 147, 480, window)
    assert torch.equal(got, ref)
    assert bool((got[:, :, :147] == cost.BIG_COST).all())


def test_sgbm_match_launches_once(card):
    """``sgbm_match`` with the BT cost on a CUDA pair: one ``bt_box_cost``
    launch, and the disparity and valid mask of the CPU route."""
    sc = layered_scene(64, 96, max_disp=24, seed=4)
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.SGBM].replace(
        disparity_range=32, window_size=5)
    _build.reset_launches()
    gpu = registry.sgbm_match(torch.tensor(sc.left, device=card),
                              torch.tensor(sc.right, device=card), cfg)
    assert _build.LAUNCHES["bt_box_cost"] == 1
    cpu = registry.sgbm_match(torch.tensor(sc.left), torch.tensor(sc.right),
                              cfg)
    assert torch.equal(gpu.valid.cpu(), cpu.valid)
    assert torch.equal(gpu.disparity.cpu(), cpu.disparity)


@pytest.mark.parametrize("window", [13, 15, 17, 19, 21, 41, 255])
def test_wide_windows_launch_the_kernel(card, window):
    """Windows up to the node's reconfigure limit (255) launch the kernel
    once and equal the twin: 37 rows (strips of 16 and a partial one), 70
    columns (whole and partial tiles of 32) and windows wider than both."""
    rng = np.random.default_rng(window)
    left, right = (torch.tensor(x, dtype=torch.float32, device=card)
                   for x in rng.uniform(0, 62, (2, 2, 37, 70)))
    _build.reset_launches()
    got = cost.bt_box_cost_volume(left, right, 3, 40, window)
    assert _build.LAUNCHES["bt_box_cost"] == 1
    assert torch.equal(got, _twin(left, right, 3, 40, window))
