"""Torch port: the census transform (``census_transform``,
``census_transform_pair`` and their twin ``census_transform_plain``)
against the JAX reference's ``census_transform`` on the same numpy
inputs, bit for bit; the CPU path never reaches the kernel library, and
a tensor that is neither on the CPU nor on the card raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.ops.census import census_transform as ref_census
from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.ops.census import (census_transform,
                                              census_transform_pair,
                                              census_transform_plain)

torch.set_num_threads(2)


def _img(shape, seed, levels=None):
    rng = np.random.default_rng(seed)
    if levels:  # few distinct values: many ties for the strict '>'
        return rng.integers(0, levels, shape).astype(np.float32)
    return rng.uniform(0, 255, shape).astype(np.float32)


# (window, shape, grey levels): every window the port runs (3x3, the
# flagship 9x9, 17x17, a non-square 5x7), B = 2, images smaller than the
# window (5x6 and 3x4: the border clamps on both sides), 3-4 grey levels
# (ties), and unbatched (H, W) images
CASES = [
    ((3, 3), (2, 11, 14), None),
    ((9, 9), (2, 19, 33), None),
    ((9, 9), (5, 6), None),
    ((9, 9), (2, 17, 40), 4),
    ((17, 17), (1, 21, 26), None),
    ((17, 17), (3, 4), 3),
    ((5, 7), (2, 12, 21), 3),
    ((5, 7), (13, 9), None),
]


@pytest.mark.parametrize("entry", ["single", "pair", "plain"])
@pytest.mark.parametrize("hw,shape,levels", CASES)
def test_census_bits_equal_reference(hw, shape, levels, entry):
    left, right = _img(shape, 3, levels), _img(shape, 4, levels)
    want = [np.asarray(ref_census(jnp.asarray(x), *hw)) for x in (left, right)]
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    if entry == "pair":
        got = census_transform_pair(tl, tr, *hw)
    elif entry == "plain":
        got = census_transform_pair(tl, tr, *hw, plain=True)
    else:
        got = (census_transform(tl, *hw), census_transform(tr, *hw))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        assert w.shape[-1] == (hw[0] * hw[1] - 1 + 31) // 32
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)
    # bit 31 of the first word (neighbour 31) is set somewhere: the int32
    # view of the raw pattern is negative there
    if hw[0] * hw[1] > 32 and not levels:
        assert bool((got[0][..., 0] < 0).any())


def test_census_cpu_never_reaches_the_kernels(monkeypatch):
    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    before = dict(_build.LAUNCHES)
    img = torch.from_numpy(_img((2, 9, 12), 5))
    a, b = census_transform_pair(img, img.flip(-1), 9, 9)
    assert torch.equal(census_transform(img, 9, 9), a)
    assert torch.equal(census_transform_plain(img.flip(-1), 9, 9), b)
    assert _build.LAUNCHES == before


def test_census_kernel_path_raises_off_the_card():
    img = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        census_transform(img, 9, 9)
    with pytest.raises(ValueError, match="CUDA"):
        census_transform_pair(img, img, 9, 9)
    # a CPU image beside one that is not: the kernel path, which raises
    with pytest.raises(ValueError, match="CUDA"):
        census_transform_pair(torch.zeros((1, 8, 16)), img, 9, 9)
    with pytest.raises(ValueError, match="odd"):
        census_transform(torch.zeros((8, 16)), 8, 9)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_census_pair_rejects_different_shapes(device):
    a = torch.zeros((1, 8, 16), device=device)
    with pytest.raises(ValueError, match="differ"):
        census_transform_pair(a, torch.zeros((1, 8, 17), device=device), 9, 9)
