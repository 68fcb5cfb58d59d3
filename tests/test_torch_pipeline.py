"""Torch port: the whole StereoPipeline (match -> depth-range clamp ->
depth, cloud, crop) against the JAX pipeline on rectified inputs, with
the JAX matcher on the branch the TPU runs (pallas_t in interpret
mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.config.params import (
    ALGORITHM_DEFAULTS,
    Algorithm,
    PointCloudConfig,
)
from i3dr_stereo_tpu.core.camera import StereoRig
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.config import params
from i3dr_stereo_tpu_torch.convert import config_from_reference, rig_from_reference
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

torch.set_num_threads(2)

MIN_VALID_AGREE = 0.999
TOL_DISP = 1e-3

H, W = 128, 160
# fx * T = 174: the depth window [9, 25] m keeps disparities 6.96..19.33
# px, so the clamp cuts the nearest layers of the scene's 8..24 px
CLOUD = dict(depth_max=25.0, depth_min=9.0)


def _cfg():
    return ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=64, max_pyramid_level=3, speckle_size=0,
        backmatch_distance=1.5)


def _rig():
    return StereoRig.synthetic(W, H, fx=580.0, baseline_m=0.3)


@pytest.fixture(scope="module")
def scene():
    return layered_scene(H, W)


@pytest.fixture(scope="module")
def reference(scene):
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline as Ref

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        pipe = Ref(_rig(), _cfg(), PointCloudConfig(**CLOUD),
                   compute_crop=True, rectify_inputs=False)
        res = pipe.process(scene.left, scene.right)
        return {f.name: (np.asarray(getattr(res, f.name))
                         if f.name != "points" else
                         {k: np.asarray(v) for k, v in res.points.items()})
                for f in dataclasses.fields(res)}


def _port_pipeline():
    return StereoPipeline(rig_from_reference(_rig()),
                          config_from_reference(_cfg()),
                          params.PointCloudConfig(**CLOUD), device="cpu",
                          compute_crop=True, rectify_inputs=False)


@pytest.fixture(scope="module")
def port(scene):
    return _port_pipeline().process(scene.left, scene.right)


def test_pipeline_matches_reference(reference, port):
    v, v_ref = port.valid.numpy(), reference["valid"]
    assert (v == v_ref).mean() >= MIN_VALID_AGREE
    both = v & v_ref
    assert both.mean() > 0.5
    d, d_ref = port.disparity.numpy(), reference["disparity"]
    assert np.abs(d - d_ref)[both].max() <= TOL_DISP
    # beyond the gate above the port agrees bit for bit
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d, d_ref)
    np.testing.assert_array_equal(port.rect_left.numpy(), reference["rect_left"])
    np.testing.assert_array_equal(port.rect_right.numpy(),
                                  reference["rect_right"])


def test_depth_cloud_crop_match_reference(reference, port):
    dv, dv_ref = port.depth_valid.numpy(), reference["depth_valid"]
    assert (dv == dv_ref).mean() >= MIN_VALID_AGREE
    both = dv & dv_ref
    np.testing.assert_allclose(port.depth.numpy()[both],
                               reference["depth"][both], rtol=1e-6)
    pv, pv_ref = port.points["valid"].numpy(), reference["points"]["valid"]
    assert (pv == pv_ref).mean() >= MIN_VALID_AGREE
    pb = pv & pv_ref
    np.testing.assert_allclose(port.points["xyz"].numpy()[pb],
                               reference["points"]["xyz"][pb], rtol=1e-6)
    np.testing.assert_array_equal(port.points["rgb"].numpy(),
                                  reference["points"]["rgb"])
    agree = port.cropped_left.numpy() == reference["cropped_left"]
    assert agree.mean() >= MIN_VALID_AGREE


def test_depth_clamp_bounds(port):
    d, v = port.disparity.numpy(), port.valid.numpy()
    fxT = 580.0 * 0.3
    assert (d[v] >= fxT / CLOUD["depth_max"] - 1e-4).all()
    assert (d[v] <= fxT / CLOUD["depth_min"] + 1e-4).all()
    assert (d > fxT / CLOUD["depth_min"] + 0.5).any()   # the clamp cut some
    z = port.depth.numpy()[port.depth_valid.numpy()]
    assert (z >= CLOUD["depth_min"]).all() and (z <= CLOUD["depth_max"]).all()
    np.testing.assert_array_equal(port.disparity_missing_z().numpy()[~v],
                                  10000.0)


def test_live_reconfigure_uses_new_scalars(scene, port):
    pipe = _port_pipeline()
    pipe.update_config(p2=8.0, uniqueness_ratio=20.0)
    assert pipe.config.p2 == 8.0
    res = pipe.process(scene.left, scene.right)
    assert res.valid.sum() < port.valid.sum()      # margin filter now on
    pipe.update_cloud(depth_max=0.0, depth_min=0.0)  # both bounds disabled
    pipe.update_config(p2=0.8, uniqueness_ratio=0.0)
    res = pipe.process(scene.left, scene.right)
    assert res.valid.sum() > port.valid.sum()


def test_depth_bounds_are_made_once_a_value():
    """The clamp's scalars are made on the device once a value and held,
    16 values at most; a new rig starts afresh."""
    pipe = _port_pipeline()
    a = pipe._scalar(9.0)
    assert a.dtype == torch.float32 and float(a) == 9.0
    assert pipe._scalar(9.0) is a and pipe._scalar(25.0) is not a
    for v in range(40):
        assert float(pipe._scalar(v + 0.5)) == v + 0.5
        assert len(pipe._scalars) <= 16
    pipe.set_rig(pipe.rig)
    assert pipe._scalars == {}


def test_batched_process_equals_frames(scene, port):
    pipe = _port_pipeline()
    l = np.stack([scene.left, scene.left])
    r = np.stack([scene.right, scene.right])
    res = pipe.process(l, r)
    np.testing.assert_array_equal(res.disparity[1].numpy(),
                                  port.disparity.numpy())
    assert tuple(res.points["xyz"].shape) == (2, H * W, 3)
    np.testing.assert_array_equal(res.points["valid"][0].numpy(),
                                  port.points["valid"].numpy())
