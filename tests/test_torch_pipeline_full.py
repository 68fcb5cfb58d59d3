"""Torch port: the product's whole frame — raw uint8 images through
bicubic rectification on a distorted rig, the pyramid with the speckle
filter at downsample 2, depth and cloud — against the JAX pipeline on the
branches the TPU runs (pallas_t SGM and Pallas speckle in interpret mode,
gather remap)."""

import cv2
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.config.params import (
    ALGORITHM_DEFAULTS,
    Algorithm,
    PointCloudConfig,
)
from i3dr_stereo_tpu.core.camera import CameraModel, StereoRig
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.config import params
from i3dr_stereo_tpu_torch.convert import config_from_reference, rig_from_reference
from i3dr_stereo_tpu_torch.ops.rectify import make_rectify_map, remap
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

torch.set_num_threads(2)

H, W = 128, 160
CLOUD = dict(depth_max=100.0, depth_min=0.5)
# the JAX reference runs its remap through XLA's CPU backend, which fuses
# each multiply-add into an FMA; the port keeps them apart (as the remap
# kernel does), so rectified images differ by 1-2 float32 ulps
RECT_ATOL = 1e-4


def _cfg(**kw):
    """bench.py:_flagship_cfg's speckle (100 / 0.5 at downsample 2) on a
    3-level pyramid over 64 disparities."""
    base = dict(disparity_range=64, max_pyramid_level=3, speckle_size=100,
                speckle_range=0.5, speckle_downsample=2,
                backmatch_distance=1.5)
    return ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(**{**base, **kw})


def _rig(scale=1.0):
    """tests/test_rectify.py's distorted camera scaled to 160x128, its
    distortion scaled by 0.2, and the right view's principal point 2 px
    off, so the two maps differ. (The synthetic scene is already
    rectified white-noise texture: stronger distortion or a rotation
    between the views leaves too little to match, not a harder parity.)"""
    K = np.array([[150.0 * scale, 0, 80.0], [0, 150.0 * scale, 64.0],
                  [0, 0, 1]])
    D = 0.2 * np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    R = cv2.Rodrigues(np.array([0.002, -0.003, 0.001]))[0]
    Pl = np.array([[147.5, 0, 79.0, 0], [0, 147.5, 64.5, 0], [0, 0, 1, 0]])
    Pr = Pl.copy()
    Pr[0, 2] = 81.0
    Pr[0, 3] = -147.5 * 0.3
    return StereoRig(CameraModel(W, H, K, D, R, Pl),
                     CameraModel(W, H, K, D, R, Pr))


@pytest.fixture(scope="module")
def raw():
    sc = layered_scene(H, W)
    return (np.clip(sc.left, 0, 255).astype(np.uint8),
            np.clip(sc.right, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def reference(raw):
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline as Ref

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        mp.setenv("I3DR_REMAP_BACKEND", "gather")
        pipe = Ref(_rig(), _cfg(), PointCloudConfig(**CLOUD),
                   rectify_inputs=True)
        res = pipe.process(*raw)
        return {k: np.asarray(getattr(res, k)) for k in
                ("rect_left", "rect_right", "disparity", "valid", "depth",
                 "depth_valid")}


def _port_pipeline(**kw):
    return StereoPipeline(rig_from_reference(_rig()),
                          config_from_reference(_cfg(**kw)),
                          params.PointCloudConfig(**CLOUD), device="cpu")


@pytest.fixture(scope="module")
def port(raw):
    return _port_pipeline().process(*raw)


def test_full_frame_matches_reference(reference, port):
    for k in ("rect_left", "rect_right"):
        np.testing.assert_allclose(getattr(port, k).numpy(), reference[k],
                                   rtol=0, atol=RECT_ATOL)
    # the ulps of the rectified images move no census bit here: the
    # matcher's outputs agree bit for bit
    v = port.valid.numpy()
    assert v.mean() > 0.5
    np.testing.assert_array_equal(v, reference["valid"])
    np.testing.assert_array_equal(port.disparity.numpy(),
                                  reference["disparity"])
    np.testing.assert_array_equal(port.depth_valid.numpy(),
                                  reference["depth_valid"])
    dv = reference["depth_valid"]
    np.testing.assert_allclose(port.depth.numpy()[dv],
                               reference["depth"][dv], rtol=1e-6)


def test_speckle_removes_pixels(raw, port):
    res = _port_pipeline(speckle_size=0).process(*raw)
    assert res.valid.sum() > port.valid.sum()
    # speckle only removes: every pixel it keeps was valid without it
    assert not (port.valid & ~res.valid).any()


def test_speckle_range_is_a_runtime_scalar(raw, port):
    pipe = _port_pipeline()
    maps = (pipe._lmap, pipe._rmap)
    pipe.update_config(speckle_range=0.05)
    res = pipe.process(*raw)
    assert (pipe._lmap, pipe._rmap) == maps          # nothing rebuilt
    assert res.valid.sum() < port.valid.sum()        # tighter: more removed


def test_set_rig_rebuilds_the_maps(raw):
    pipe = _port_pipeline()
    rig2 = rig_from_reference(_rig(scale=1.05))
    pipe.set_rig(rig2)
    want = make_rectify_map(rig2.left, device="cpu")
    assert torch.equal(pipe._lmap.flat_idx, want.flat_idx)
    assert torch.equal(pipe._lmap.wx, want.wx)
    assert pipe.rig is rig2


def test_colour_and_float_inputs_take_the_luma_first(raw):
    pipe = _port_pipeline(speckle_size=0)

    def rectified(image):  # what process() hands rectify_pair, remapped
        return remap(pipe._remap_input(image), pipe._lmap)

    bgr = np.repeat(raw[0][..., None], 3, axis=-1)
    a = rectified(bgr)
    b = rectified(raw[0].astype(np.float32))
    c = rectified(raw[0])
    lum = (bgr[..., 0].astype(np.float32) * np.float32(0.114)
           + bgr[..., 1].astype(np.float32) * np.float32(0.587)
           + bgr[..., 2].astype(np.float32) * np.float32(0.299))
    np.testing.assert_array_equal(a.numpy(), rectified(lum).numpy())
    np.testing.assert_array_equal(b.numpy(), c.numpy())
