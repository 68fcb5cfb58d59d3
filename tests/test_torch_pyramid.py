"""Torch port: the flagship coarse-to-fine matcher against the JAX branch
the TPU runs (``I3DR_SGM_BACKEND=pallas_t_interpret``: the pallas_t
kernels in interpret mode), on a seeded layered scene."""

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.convert import config_from_reference
from i3dr_stereo_tpu_torch.matchers import pyramid as pyr

torch.set_num_threads(2)

MIN_VALID_AGREE = 0.999
TOL_DISP = 1e-3


def _cfg():
    # 3 pyramid levels over 64 disparities, speckle off, true backmatch 1.5
    return ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=64, max_pyramid_level=3, speckle_size=0,
        backmatch_distance=1.5)


@pytest.fixture(scope="module")
def scene():
    return layered_scene(128, 160)


@pytest.fixture(scope="module")
def reference(scene):
    from i3dr_stereo_tpu.matchers.pyramid import pyramid_sgm_match

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        res = pyramid_sgm_match(scene.left, scene.right, _cfg())
        return np.asarray(res.disparity), np.asarray(res.valid)


@pytest.fixture(scope="module")
def port(scene):
    res = pyr.pyramid_sgm_match(torch.from_numpy(scene.left),
                                torch.from_numpy(scene.right),
                                config_from_reference(_cfg()))
    return res.disparity.numpy(), res.valid.numpy()


def test_pyramid_matches_reference(reference, port):
    (d_ref, v_ref), (d, v) = reference, port
    assert d.shape == d_ref.shape == (128, 160)
    assert (v == v_ref).mean() >= MIN_VALID_AGREE
    both = v & v_ref
    assert both.mean() > 0.6
    assert np.abs(d - d_ref)[both].max() <= TOL_DISP
    # the port does the reference's float32 operations in its order, so
    # beyond the gate above the two agree bit for bit
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d, d_ref)


def test_pyramid_accuracy(scene, port):
    d, v = port
    ok = v & scene.valid
    assert v.mean() > 0.75
    assert np.median(np.abs(d - scene.disparity)[ok]) < 0.25


def test_pyramid_batch_equals_frames(scene, port):
    cfg = config_from_reference(_cfg())
    l = torch.from_numpy(np.stack([scene.left, scene.right[:, ::-1].copy()]))
    r = torch.from_numpy(np.stack([scene.right, scene.left[:, ::-1].copy()]))
    res = pyr.pyramid_sgm_match(l, r, cfg)
    assert tuple(res.disparity.shape) == (2, 128, 160)
    np.testing.assert_array_equal(res.disparity[0].numpy(), port[0])
    np.testing.assert_array_equal(res.valid[0].numpy(), port[1])


def test_plain_flag_is_the_cpu_path(scene, port):
    """On CPU tensors the kernel wrappers take the plain twins, so the
    explicit plain run must be identical."""
    res = pyr.pyramid_sgm_match(torch.from_numpy(scene.left),
                                torch.from_numpy(scene.right),
                                config_from_reference(_cfg()), plain=True)
    np.testing.assert_array_equal(res.disparity.numpy(), port[0])
    np.testing.assert_array_equal(res.valid.numpy(), port[1])


def test_profile_from_config_matches_reference():
    from i3dr_stereo_tpu.matchers.pyramid import profile_from_config as ref_pfc

    cfg = _cfg().replace(uniqueness_ratio=7.0, p1=0.2)
    ref = ref_pfc(cfg)
    port = pyr.profile_from_config(config_from_reference(cfg))
    assert len(port.levels) == len(ref.levels)
    for a, b in zip(port.levels, ref.levels):
        for name in b.__dataclass_fields__:
            assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("shape,filled", [((48, 56), True),
                                          ((64, 80), False)])
def test_gap_filling_is_rejected_on_the_clamped_levels(shape, filled):
    """Which level is the finest, and so fills its gaps, is decided after
    the levels are clamped to the image size, as in the reference (its
    ``finest = p.level == 0`` reads the clamped level). A profile whose
    only level is 1 with gap filling on: a 48x56 image clamps it to level
    0, where both packages fill the holes with the Gauss interpolator; at
    64x80 the level stays 1 and neither fills. Valid masks equal,
    disparities within 1e-5 px (an ulp of exp in the Gauss weights)."""
    from i3dr_stereo_tpu.config.profile import (
        PyramidLevelConfig as RefLevel, SGMProfile as RefProfile)
    from i3dr_stereo_tpu.matchers.pyramid import pyramid_sgm_match as ref
    from i3dr_stereo_tpu_torch.convert import profile_from_reference

    def make(fill):
        return RefProfile(name="level_1_only", levels=(
            RefLevel(level=1, interpolate_gaps=fill, speckle=False,
                     prediction_shift=0.0),))

    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    right = np.roll(img, -3, axis=1)     # disparity 3: a band of holes
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        want = ref(img, right, _cfg(), make(True))
    cfg = config_from_reference(_cfg())
    res = pyr.pyramid_sgm_match(torch.from_numpy(img),
                                torch.from_numpy(right), cfg,
                                profile_from_reference(make(True)))
    assert tuple(res.disparity.shape) == shape
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(res.disparity.numpy(),
                               np.asarray(want.disparity), rtol=0, atol=1e-5)
    unfilled = pyr.pyramid_sgm_match(torch.from_numpy(img),
                                     torch.from_numpy(right), cfg,
                                     profile_from_reference(make(False)))
    if filled:
        assert res.valid.sum() > unfilled.valid.sum()
    else:
        assert torch.equal(res.valid, unfilled.valid)
        assert torch.equal(res.disparity, unfilled.disparity)
