"""Torch port: the speckle filter (the plain twin of the ``speckle_ccl``
kernel and the downsample front-end) against the JAX package on the same
numpy inputs: the Pallas kernel the TPU runs (``speckle_filter_pallas``
in interpret mode), the XLA formulation, and the cv2.filterSpeckles
oracle. Every comparison is exact: the keep-mask is a set of pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.ops.speckle import speckle_filter as ref_speckle
from i3dr_stereo_tpu.ops.speckle_pallas import speckle_filter_pallas
from i3dr_stereo_tpu_torch.ops import speckle

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)


def _xla(d, v, S, md, downsample=1):
    return np.asarray(ref_speckle(jnp.asarray(d), jnp.asarray(v), max_size=S,
                                  max_diff=md, downsample=downsample,
                                  backend="xla"))


def _pallas(d, v, S, md, downsample=1):
    if downsample == 1:
        d3, v3 = (d, v) if d.ndim == 3 else (d[None], v[None])
        out = np.asarray(speckle_filter_pallas(
            jnp.asarray(d3), jnp.asarray(v3), max_size=S, max_diff=md,
            interpret=True))
        return out if d.ndim == 3 else out[0]
    return np.asarray(ref_speckle(jnp.asarray(d), jnp.asarray(v), max_size=S,
                                  max_diff=md, downsample=downsample,
                                  backend="pallas_interpret"))


def _port(d, v, S, md, downsample=1, **kw):
    return speckle.speckle_filter(torch.from_numpy(d), torch.from_numpy(v),
                                  max_size=S, max_diff=md,
                                  downsample=downsample, **kw).numpy()


def _cv2_keep(d, v, S, md):
    """cv2.filterSpeckles on x16 fixed point (exact for these integer
    disparities), -16 marking invalid."""
    cvd = np.where(v, d * 16, -16).astype(np.int16)
    cv2.filterSpeckles(cvd, -16, S, int(md * 16))
    return (cvd != -16) & v


def _blobs(shape, seed, levels=4, step=3.0, p_valid=0.85):
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, levels, shape) * step).astype(np.float32)
    v = rng.random(shape) < p_valid
    return d, v


def test_single_window_matches_pallas_xla_and_cv2():
    d, v = _blobs((1, 48, 136), seed=0)
    got = _port(d, v, 12, 1.0)
    np.testing.assert_array_equal(got, _pallas(d, v, 12, 1.0))
    np.testing.assert_array_equal(got, _xla(d, v, 12, 1.0))
    np.testing.assert_array_equal(got[0], _cv2_keep(d[0], v[0], 12, 1.0))
    assert 0 < got.sum() < v.sum()                  # removed some, kept some


@pytest.mark.parametrize("S", [12, 60])
def test_tiled_size_matches_xla(S):
    """320x560: the frame the TPU tiles (> 320*512 px). Interpret mode is
    slow at this size, so the reference is the XLA formulation, which
    tests/test_speckle_pallas.py holds equal to the Pallas kernel."""
    rng = np.random.default_rng(1)
    H, W = 320, 560
    d = (rng.integers(0, 3, (1, H // 8, W // 8)) * 5.0)
    d = d.repeat(8, 1).repeat(8, 2).astype(np.float32)
    d += (rng.random((1, H, W)) < 0.02) * 7.0
    v = rng.random((1, H, W)) > 0.1
    got = _port(d, v, S, 1.0)
    np.testing.assert_array_equal(got, _xla(d, v, S, 1.0))
    np.testing.assert_array_equal(got[0], _cv2_keep(d[0], v[0], S, 1.0))


def test_region_across_tile_edge():
    """The TPU's 256-px tile edge: a removable blob on it and a long kept
    region across it, plus a blob touching the image border."""
    H, W = 320, 560
    d = np.zeros((1, H, W), np.float32)
    v = np.zeros((1, H, W), bool)
    v[0, 100:105, 254:259] = True               # 25 px on the edge: removed
    d[0, 100:105, 254:259] = 7.0
    v[0, 200:202, 100:250] = True               # 300 px across it: kept
    d[0, 200:202, 100:250] = 3.0
    v[0, 0:6, 0:4] = True                       # 24 px in the corner: removed
    d[0, 0:6, 0:4] = 2.0
    v[0, 310:320, 550:560] = True               # 100 px in the corner: kept
    d[0, 310:320, 550:560] = 9.0
    keep = _port(d, v, 25, 1.0)
    assert not keep[0, 100:105, 254:259].any()
    assert keep[0, 200:202, 100:250].all()
    assert not keep[0, 0:6, 0:4].any()
    assert keep[0, 310:320, 550:560].all()
    np.testing.assert_array_equal(keep, _xla(d, v, 25, 1.0))
    np.testing.assert_array_equal(keep[0], _cv2_keep(d[0], v[0], 25, 1.0))


def test_batched():
    d, v = _blobs((2, 40, 130), seed=3, levels=3, step=4.0, p_valid=0.8)
    got = _port(d, v, 9, 1.0)
    np.testing.assert_array_equal(got, _pallas(d, v, 9, 1.0))
    np.testing.assert_array_equal(got, _xla(d, v, 9, 1.0))
    for b in range(2):
        np.testing.assert_array_equal(got[b], _cv2_keep(d[b], v[b], 9, 1.0))
        np.testing.assert_array_equal(
            got[b], speckle.speckle_filter(torch.from_numpy(d[b]),
                                           torch.from_numpy(v[b]),
                                           max_size=9, max_diff=1.0).numpy())


def test_smooth_frame_is_one_component():
    """A slanted smooth frame is one big component: everything is kept,
    and a removable island inside it still goes."""
    H, W = 64, 150
    yy, xx = np.mgrid[0:H, 0:W]
    d = (0.3 * xx + 0.2 * yy).astype(np.float32)[None]
    v = np.ones((1, H, W), bool)
    d[0, 30:33, 40:44] += 50.0                  # 12 px island
    keep = _port(d, v, 20, 0.5)
    assert keep.sum() == H * W - 12
    np.testing.assert_array_equal(keep, _pallas(d, v, 20, 0.5))
    np.testing.assert_array_equal(keep, _xla(d, v, 20, 0.5))


def test_invalid_pixels_carry_arbitrary_values():
    """Invalid pixels may hold anything (NaN, inf, huge): the mask must
    not depend on them."""
    d, v = _blobs((1, 40, 96), seed=5)
    junk = d.copy()
    rng = np.random.default_rng(6)
    choices = np.array([np.nan, np.inf, -np.inf, 1e30, -1e12], np.float32)
    junk[~v] = choices[rng.integers(0, 5, int((~v).sum()))]
    got = _port(junk, v, 10, 1.0)
    np.testing.assert_array_equal(got, _port(d, v, 10, 1.0))
    np.testing.assert_array_equal(got, _xla(d, v, 10, 1.0))
    np.testing.assert_array_equal(got, _pallas(d, v, 10, 1.0))
    np.testing.assert_array_equal(got[0], _cv2_keep(d[0], v[0], 10, 1.0))


def test_large_threshold_at_full_resolution():
    """max_size above 127 (the TPU kernel's single-window limit)."""
    d, v = _blobs((1, 120, 200), seed=7, levels=2, step=2.0, p_valid=0.9)
    got = _port(d, v, 200, 1.0)
    np.testing.assert_array_equal(got, _xla(d, v, 200, 1.0))
    np.testing.assert_array_equal(got, _pallas(d, v, 200, 1.0))
    np.testing.assert_array_equal(got[0], _cv2_keep(d[0], v[0], 200, 1.0))


@pytest.mark.parametrize("shape", [(45, 131), (2, 37, 70)])
def test_downsample2_ragged(shape):
    """downsample=2 on odd sizes: block minima on the padded frame, the
    threshold max(S // 4, 1) and max_diff * 2, the verdict broadcast back."""
    d, v = _blobs(shape, seed=8, levels=5, step=1.5, p_valid=0.75)
    got = _port(d, v, 40, 0.5, downsample=2)
    np.testing.assert_array_equal(got, _pallas(d, v, 40, 0.5, downsample=2))
    np.testing.assert_array_equal(got, _xla(d, v, 40, 0.5, downsample=2))
    assert 0 < got.sum() < v.sum()


def test_max_diff_is_a_runtime_scalar():
    """Changing max_diff between two calls changes the mask: the port
    reads it per call."""
    d, v = _blobs((1, 40, 96), seed=9, levels=3, step=1.0, p_valid=0.9)
    tight = _port(d, v, 15, 0.5)
    loose = _port(d, v, 15, 1.0)
    assert tight.sum() < loose.sum()
    for got, md in ((tight, 0.5), (loose, 1.0)):
        np.testing.assert_array_equal(got, _xla(d, v, 15, md))
        np.testing.assert_array_equal(got, _pallas(d, v, 15, md))
        np.testing.assert_array_equal(got[0], _cv2_keep(d[0], v[0], 15, md))


def test_iters_and_off_switch_follow_the_reference():
    d, v = _blobs((1, 40, 96), seed=10)
    np.testing.assert_array_equal(_port(d, v, 0, 1.0), v)
    # a propagation budget below S+2 makes the plain formulation inexact
    # in the reference's way
    got = _port(d, v, 30, 1.0, iters=3)
    want = np.asarray(ref_speckle(jnp.asarray(d), jnp.asarray(v), max_size=30,
                                  max_diff=1.0, iters=3, backend="xla"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _port(d, v, 30, 1.0, plain=True), _port(d, v, 30, 1.0))
