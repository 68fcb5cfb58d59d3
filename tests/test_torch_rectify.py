"""Torch port: the rectification map (host numpy float64, bit-identical to
the JAX map) and the remap kernel's plain twin against the reference's
``_remap_gather_impl`` on the same numpy inputs."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.core.camera import CameraModel as RefCamera
from i3dr_stereo_tpu.ops import rectify as ref_rectify
from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.core.camera import CameraModel
from i3dr_stereo_tpu_torch.ops import rectify

torch.set_num_threads(2)


def _distorted(cls):
    """``tests/test_rectify.py``'s distorted 320x240 camera."""
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1]])
    D = np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    R = cv2.Rodrigues(np.array([0.002, -0.003, 0.001]))[0]
    P = np.array([[295.0, 0, 158.0, 0], [0, 295.0, 121.0, 0], [0, 0, 1, 0]])
    return cls(320, 240, K, D, R, P)


def _ideal(cls):
    return cls.ideal(96, 72, 80.0, cx=47.3, cy=35.8)


def _image(shape, seed, dtype):
    img = np.random.default_rng(seed).uniform(0, 255, shape)
    return img.astype(np.uint8) if dtype == "uint8" else img.astype(np.float32)


@pytest.mark.parametrize("interp", ["cubic", "linear"])
@pytest.mark.parametrize("make", [_distorted, _ideal])
def test_map_bit_identical_to_reference(make, interp):
    ref = ref_rectify.make_rectify_map(make(RefCamera), interpolation=interp,
                                       banded=False)
    port = rectify.make_rectify_map(make(CameraModel), interpolation=interp,
                                    device="cpu")
    assert (port.src_h, port.src_w, port.pad, port.taps) == (
        ref.src_h, ref.src_w, ref.pad, ref.taps)
    assert port.flat_idx.dtype == torch.int32
    np.testing.assert_array_equal(port.flat_idx.numpy(),
                                  np.asarray(ref.flat_idx))
    np.testing.assert_array_equal(port.wx.numpy(), np.asarray(ref.wx))
    np.testing.assert_array_equal(port.wy.numpy(), np.asarray(ref.wy))
    # one copy of the weights: a pixel's wx then wy, which wx / wy view
    assert port.weights.is_contiguous() and tuple(port.weights.shape) == (
        ref.src_h, ref.src_w, 2 * ref.taps)
    assert port.wx.data_ptr() == port.weights.data_ptr()
    assert port.wy.untyped_storage().data_ptr() == \
        port.weights.untyped_storage().data_ptr()


def test_inverse_map_bit_identical_to_reference():
    mx, my = rectify.inverse_rectify_map_xy(_distorted(CameraModel))
    rx, ry = ref_rectify.inverse_rectify_map_xy(_distorted(RefCamera))
    np.testing.assert_array_equal(mx, rx)
    np.testing.assert_array_equal(my, ry)


def _gather_numpy(img, m):
    """The reference's gather formulation in numpy float32, every
    multiply and add rounded on its own (the order the remap kernel and
    its twin keep)."""
    batched = img.ndim == 3
    x = (img if batched else img[None]).astype(np.float32)
    p = m.pad
    flat = np.pad(x, ((0, 0), (p, p), (p, p)), mode="edge").reshape(
        x.shape[0], -1)
    fi, wx, wy = m.flat_idx.numpy(), m.wx.numpy(), m.wy.numpy()
    out = np.zeros((x.shape[0],) + fi.shape, np.float32)
    for j in range(m.taps):
        row = np.zeros_like(out)
        for i in range(m.taps):
            row = row + flat[:, fi + j * m.padded_w + i] * wx[..., i]
        out = out + row * wy[..., j]
    return out if batched else out[0]


# Tolerance: the twin equals the unfused float32 order bit for bit. XLA's
# CPU backend fuses each `acc + a * b` of `_remap_gather_impl` into one FMA
# (a numpy emulation of that contraction reproduces it exactly), so against
# JAX on the CPU the port holds 1e-4 absolute on the 0-255 scale; measured
# differences are 1-2 float32 ulps (<= 6.2e-5).
REF_ATOL = 1e-4


@pytest.mark.parametrize("interp", ["cubic", "linear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("batch", [None, 2])
def test_remap_equals_reference_gather(interp, dtype, batch):
    shape = (240, 320) if batch is None else (batch, 240, 320)
    img = _image(shape, seed=3, dtype=dtype)
    ref_map = ref_rectify.make_rectify_map(_distorted(RefCamera),
                                           interpolation=interp, banded=False)
    port_map = rectify.make_rectify_map(_distorted(CameraModel),
                                        interpolation=interp, device="cpu")
    want = np.asarray(ref_rectify._remap_gather_impl(jnp.asarray(img),
                                                     ref_map))
    got = rectify.remap(torch.from_numpy(img), port_map)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), _gather_numpy(img, port_map))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_ATOL)


def test_remap_u8_equals_f32_and_custom_map():
    """uint8 and float32 sources of the same values give the same output;
    a map_xy override (a shift with fully outside pixels) reads the
    replicated border."""
    cam = _ideal(CameraModel)
    img = _image((72, 96), seed=5, dtype="uint8")
    mx, my = np.meshgrid(np.arange(96, dtype=np.float64),
                         np.arange(72, dtype=np.float64))
    m = rectify.make_rectify_map(cam, map_xy=(mx - 7.25, my + 0.5),
                                 device="cpu")
    a = rectify.remap(torch.from_numpy(img), m)
    b = rectify.remap(torch.from_numpy(img.astype(np.float32)), m)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref_m = ref_rectify.make_rectify_map(_ideal(RefCamera),
                                         map_xy=(mx - 7.25, my + 0.5),
                                         banded=False)
    np.testing.assert_array_equal(a.numpy(), _gather_numpy(img, m))
    np.testing.assert_allclose(
        a.numpy(), np.asarray(ref_rectify._remap_gather_impl(
            jnp.asarray(img), ref_m)), rtol=0, atol=REF_ATOL)
    # columns whose stencil is clamped to the left border read the same
    # border taps with the same weights
    np.testing.assert_array_equal(a.numpy()[:-2, 0], a.numpy()[:-2, 1])


def test_rectify_pair_and_shape_check():
    cam = _distorted(CameraModel)
    lm = rectify.make_rectify_map(cam, device="cpu")
    rm = rectify.make_rectify_map(cam, interpolation="linear", device="cpu")
    img = torch.from_numpy(_image((240, 320), seed=7, dtype="float32"))
    l, r = rectify.rectify_pair(img, img, lm, rm)
    np.testing.assert_array_equal(l.numpy(), rectify.remap(img, lm).numpy())
    np.testing.assert_array_equal(r.numpy(), rectify.remap(img, rm).numpy())
    with pytest.raises(ValueError, match="320"):
        rectify.remap(img[:, :300], lm)
    with pytest.raises(ValueError, match="uint8 or float32"):
        rectify.remap(img.double(), lm)


def _outside_xy():
    """A 320x240 map whose coordinates leave the image on every side."""
    mx, my = np.meshgrid(np.arange(320, dtype=np.float64),
                         np.arange(240, dtype=np.float64))
    return mx * 1.25 - 37.6, my * 1.2 - 21.3


@pytest.mark.parametrize("interp", ["cubic", "linear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("batch", [None, 2])
def test_rectify_pair_equals_reference_gather(interp, dtype, batch):
    """Both cameras through rectify_pair over the interleaved map: the
    distorted camera, and a map whose coordinates fall outside the image
    (the stencil clamped to the replicated border)."""
    shape = (240, 320) if batch is None else (batch, 240, 320)
    left, right = _image(shape, 8, dtype), _image(shape, 9, dtype)
    maps, ref_maps = [], []
    for xy in (None, _outside_xy()):
        maps.append(rectify.make_rectify_map(
            _distorted(CameraModel), interpolation=interp, map_xy=xy,
            device="cpu"))
        ref_maps.append(ref_rectify.make_rectify_map(
            _distorted(RefCamera), interpolation=interp, map_xy=xy,
            banded=False))
    got = rectify.rectify_pair(torch.from_numpy(left), torch.from_numpy(right),
                               *maps)
    for g, img, m, rm in zip(got, (left, right), maps, ref_maps):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), _gather_numpy(img, m))
        np.testing.assert_array_equal(
            g.numpy(), rectify.remap(torch.from_numpy(img), m).numpy())
        np.testing.assert_allclose(
            g.numpy(), np.asarray(ref_rectify._remap_gather_impl(
                jnp.asarray(img), rm)), rtol=0, atol=REF_ATOL)


def test_remap_cpu_never_reaches_the_kernels(monkeypatch):
    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    before = dict(_build.LAUNCHES)
    m = rectify.make_rectify_map(_ideal(CameraModel), device="cpu")
    img = torch.from_numpy(_image((72, 96), seed=4, dtype="uint8"))
    a, b = rectify.rectify_pair(img, img, m, m)
    assert torch.equal(a, rectify.remap(img, m)) and torch.equal(a, b)
    assert _build.LAUNCHES == before


def test_rectify_pair_kernel_path_raises_off_the_card():
    m = rectify.make_rectify_map(_ideal(CameraModel), device="meta")
    img = torch.zeros((72, 96), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rectify.rectify_pair(img, img, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        rectify.rectify_pair(torch.zeros((72, 96)), img, m, m)
