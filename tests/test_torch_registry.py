"""Torch port: the SGBM, BM and dense-I3DRSGM matchers, the matcher facade
and the SGBM pipeline against the JAX package on the branches the TPU
runs (``pallas_t`` SGM, i.e. ``sgm_aggregate_pallas`` in interpret mode,
and the Pallas speckle filter in interpret mode), on the same inputs.
Disparity and valid must agree exactly; rectified images within 1e-4
(XLA's CPU backend fuses the reference remap's multiply-adds, see
tests/test_torch_pipeline_full.py)."""

import dataclasses

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
from i3dr_stereo_tpu_torch.matchers import base, registry
from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

torch.set_num_threads(2)

H, W = 48, 64
CLOUD = dict(depth_max=100.0, depth_min=0.5)
RECT_ATOL = 1e-4


def _sgbm_accuracy_cfg(**kw):
    """accuracy_bench.py:sgbm_1280's config with D = 32 for a 48x64 frame."""
    return ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
        **{**dict(disparity_range=32, window_size=5, p1=200.0, p2=400.0,
                  uniqueness_ratio=10.0, disp12_max_diff=1.0, speckle_size=0,
                  num_directions=8, subpixel=True), **kw})


CASES = {
    "sgbm_accuracy": (_sgbm_accuracy_cfg(), (H, W)),
    # the defaults: window 9, D = 64, uniqueness 15, LR check at 1.0,
    # speckle 100 / 4.0 at full resolution
    "sgbm_defaults": (ALGORITHM_DEFAULTS[Algorithm.SGBM], (H, 96)),
    "sgbm_5path_min_disparity": (
        _sgbm_accuracy_cfg(num_directions=5, min_disparity=4, window_size=3,
                           median_filter=True, speckle_size=20), (H, W)),
    "bm_xsobel": (ALGORITHM_DEFAULTS[Algorithm.BM], (H, 96)),
    "bm_normalized_response": (
        ALGORITHM_DEFAULTS[Algorithm.BM_GPU].replace(
            prefilter_type="normalized_response", disparity_range=32,
            min_disparity=2), (H, W)),
    "i3drsgm_dense": (ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        pyramid=False, disparity_range=32), (H, W)),
    "i3drsgm_dense_8path_64": (ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        pyramid=False, disparity_range=64, num_directions=8,
        uniqueness_ratio=5.0, census_width=7, census_height=5), (H, 96)),
}


def _scene(shape, seed=5):
    sc = layered_scene(*shape, max_disp=min(28, shape[1] // 3), seed=seed)
    return sc.left.astype(np.float32), sc.right.astype(np.float32)


@pytest.fixture(scope="module")
def tpu_branch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        mp.setenv("I3DR_REMAP_BACKEND", "gather")
        yield


@pytest.fixture(scope="module")
def reference(tpu_branch):
    from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY

    out = {}
    for name, (cfg, shape) in CASES.items():
        l, r = _scene(shape)
        res = MATCHER_REGISTRY[cfg.algorithm](l, r, cfg)
        out[name] = (np.asarray(res.disparity), np.asarray(res.valid))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_matcher_matches_reference(name, reference):
    cfg, shape = CASES[name]
    l, r = _scene(shape)
    res = registry.compute_disparity(torch.from_numpy(l), torch.from_numpy(r),
                                     config_from_reference(cfg))
    d_ref, v_ref = reference[name]
    v = res.valid.numpy()
    assert 0.3 < v.mean() < 1.0
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(res.disparity.numpy(), d_ref)


def test_sgbm_batched_equals_per_image():
    cfg = config_from_reference(_sgbm_accuracy_cfg(speckle_size=30))
    pairs = [_scene((H, W), seed=s) for s in (5, 6)]
    l = torch.from_numpy(np.stack([p[0] for p in pairs]))
    r = torch.from_numpy(np.stack([p[1] for p in pairs]))
    both = registry.sgbm_match(l, r, cfg)
    for i, (li, ri) in enumerate(pairs):
        one = registry.sgbm_match(torch.from_numpy(li), torch.from_numpy(ri),
                                  cfg)
        assert torch.equal(both.disparity[i], one.disparity)
        assert torch.equal(both.valid[i], one.valid)


def test_dense_i3drsgm_wide_range_warns_and_takes_the_pyramid():
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM].replace(
        pyramid=False, disparity_range=96, speckle_size=0)
    l, r = (torch.from_numpy(x) for x in _scene((64, 96)))
    with pytest.warns(UserWarning, match="pyramid schedule \\(3 levels"):
        res = registry.MATCHER_REGISTRY[cfg.algorithm](l, r, cfg)
    ref = pyramid_sgm_match(l, r, cfg.replace(pyramid=True,
                                              max_pyramid_level=3))
    assert torch.equal(res.disparity, ref.disparity)
    assert torch.equal(res.valid, ref.valid)


@pytest.fixture(scope="module")
def facade_reference(tpu_branch):
    from i3dr_stereo_tpu.matchers.base import create_matcher

    m = create_matcher(CASES["sgbm_accuracy"][0])
    l, r = _scene((H, W), seed=9)
    fwd, bwd = m.match(l, r), m.backward_match(l, r)
    return {"fwd": fwd, "bwd": bwd,
            "fixed": np.asarray(fwd.fixed_point(16, 0)),
            "missing_z": np.asarray(fwd.with_missing_z()),
            "nodata": np.asarray(fwd.with_nodata())}


def test_create_matcher_forward_backward_and_encodings(facade_reference):
    m = base.create_matcher(config_from_reference(CASES["sgbm_accuracy"][0]),
                            device="cpu")
    l, r = _scene((H, W), seed=9)
    ref = facade_reference
    fwd = m.match(l, r)
    for got, want in ((fwd, ref["fwd"]), (m.backward_match(l, r), ref["bwd"])):
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.disparity.numpy(),
                                      np.asarray(want.disparity))
    assert torch.equal(m.forward_match(l, r).disparity, fwd.disparity)
    np.testing.assert_array_equal(fwd.fixed_point(16, 0).numpy(),
                                  ref["fixed"])
    np.testing.assert_array_equal(fwd.with_missing_z().numpy(),
                                  ref["missing_z"])
    np.testing.assert_array_equal(fwd.with_nodata().numpy(), ref["nodata"])


def test_matcher_update_and_unported_options(tpu_branch):
    """Live updates; ``interp`` (the backward-match-driven WLS fill of BM
    and SGBM, the plain WLS fill of dense I3DRSGM) runs and matches the
    reference (valid everywhere on both sides; disparities within 1e-3
    px, XLA's FMAs in the WLS solver, where the reference is finite: its
    WLS can divide by a zero pivot, see tests/test_torch_postmatch.py;
    everywhere within 2e-3 px of a float64 witness of the fill);
    ``downsample_scale`` (the cubic resize and back) and BP / CSBP, which
    once raised, run and give the reference's results (BP and CSBP at
    16x32, D = 16, bit-equal there; tests/test_torch_bp.py and
    tests/test_torch_resize.py hold them in full)."""
    from i3dr_stereo_tpu.matchers.base import create_matcher as ref_matcher
    from i3dr_stereo_tpu.matchers.registry import compute_disparity as ref
    from test_torch_postmatch import check_wls_witness, record_wls

    m = base.create_matcher(params.Algorithm.SGBM, device="cpu")
    assert m.config == params.ALGORITHM_DEFAULTS[params.Algorithm.SGBM]
    m.update(p1=10.0, disparity_range=40)
    assert m.config.p1 == 10.0 and m.config.disparity_range == 48
    m.set_config(m.config.replace(downsample_scale=0.5))
    l, r = _scene((H, W), seed=4)
    ref_cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
        p1=10.0, disparity_range=40, downsample_scale=0.5)
    assert config_from_reference(ref_cfg) == m.config
    got, want = m.match(l, r), ref_matcher(ref_cfg).match(l, r)
    assert got.disparity.shape == (H, W)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.disparity.numpy(),
                                  np.asarray(want.disparity))
    for alg in (Algorithm.SGBM, Algorithm.BM, Algorithm.I3DRSGM):
        cfg = ALGORITHM_DEFAULTS[alg].replace(pyramid=False,
                                              disparity_range=32,
                                              interp=True)
        want = ref(l, r, cfg)
        with pytest.MonkeyPatch.context() as mp:
            calls = record_wls(mp, registry)
            got = registry.compute_disparity(l, r, config_from_reference(cfg))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        assert got.valid.all()
        d, d_ref = got.disparity.numpy(), np.asarray(want.disparity)
        ok = np.isfinite(d_ref)
        assert np.isfinite(d).all() and ok.mean() > 0.5, alg
        np.testing.assert_allclose(d[ok], d_ref[ok], rtol=0, atol=1e-3)
        # every pixel, the ones the reference leaves NaN included, against
        # the float64 witness of the fill the matcher ran
        assert [c[0] for c in calls] == [
            "wls_fill" if alg == Algorithm.I3DRSGM else "wls_fill_lr"]
        check_wls_witness(d, calls, d_ref)
    sc = layered_scene(16, 32, max_disp=12, seed=4)
    for alg in (Algorithm.BP_GPU, Algorithm.CSBP_GPU):
        cfg = ALGORITHM_DEFAULTS[alg].replace(disparity_range=16)
        want = ref(sc.left, sc.right, cfg)
        got = registry.compute_disparity(sc.left, sc.right,
                                         config_from_reference(cfg))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.disparity.numpy(),
                                      np.asarray(want.disparity))


# ---------------------------------------------------------------------------
# the SGBM pipeline
# ---------------------------------------------------------------------------

PH, PW = 64, 96


def _rig():
    """A distorted rig at 96x64 (tests/test_torch_pipeline_full.py's
    camera, rescaled), the right principal point 1 px off."""
    K = np.array([[90.0, 0, 48.0], [0, 90.0, 32.0], [0, 0, 1]])
    D = 0.2 * np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    R = cv2.Rodrigues(np.array([0.002, -0.003, 0.001]))[0]
    Pl = np.array([[88.5, 0, 47.5, 0], [0, 88.5, 32.5, 0], [0, 0, 1, 0]])
    Pr = Pl.copy()
    Pr[0, 2] = 48.5
    Pr[0, 3] = -88.5 * 0.3
    return StereoRig(CameraModel(PW, PH, K, D, R, Pl),
                     CameraModel(PW, PH, K, D, R, Pr))


def _pipe_cfg():
    return _sgbm_accuracy_cfg(speckle_size=40, speckle_range=2.0)


UPDATE = dict(p1=120.0, p2=900.0, uniqueness_ratio=15.0, speckle_range=1.0)


@pytest.fixture(scope="module")
def raw():
    sc = layered_scene(PH, PW, max_disp=28, seed=3)
    return (np.clip(sc.left, 0, 255).astype(np.uint8),
            np.clip(sc.right, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def pipeline_reference(tpu_branch, raw):
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline as Ref

    out = {}
    for rect in (False, True):
        rig = _rig() if rect else StereoRig.synthetic(PW, PH)
        pipe = Ref(rig, _pipe_cfg(), PointCloudConfig(**CLOUD),
                   rectify_inputs=rect)
        keys = ("rect_left", "disparity", "valid", "depth_valid")
        out[rect] = {k: np.asarray(getattr(pipe.process(*raw), k))
                     for k in keys}
        if not rect:
            pipe.update_config(**UPDATE)
            out["updated"] = {k: np.asarray(getattr(pipe.process(*raw), k))
                              for k in keys}
    bm = Ref(StereoRig.synthetic(PW, PH), ALGORITHM_DEFAULTS[Algorithm.BM],
             PointCloudConfig(**CLOUD), rectify_inputs=False)
    out["bm"] = {k: np.asarray(getattr(bm.process(*raw), k))
                 for k in ("disparity", "valid")}
    return out


def _port_pipe(rect, cfg=None):
    rig = _rig() if rect else StereoRig.synthetic(PW, PH)
    return StereoPipeline(rig_from_reference(rig),
                          config_from_reference(cfg or _pipe_cfg()),
                          params.PointCloudConfig(**CLOUD), device="cpu",
                          rectify_inputs=rect)


def test_sgbm_pipeline_exact_without_rectification(pipeline_reference, raw):
    ref = pipeline_reference[False]
    pipe = _port_pipe(False)
    res = pipe.process(*raw)
    assert 0.5 < res.valid.float().mean() < 1.0
    np.testing.assert_array_equal(res.valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(res.disparity.numpy(), ref["disparity"])
    np.testing.assert_array_equal(res.depth_valid.numpy(), ref["depth_valid"])

    # live reconfigure of P1/P2, uniqueness and speckle range: the same
    # pipeline object, no rebuild, the reference's updated result
    pipe.update_config(**UPDATE)
    upd = pipe.process(*raw)
    want = pipeline_reference["updated"]
    assert not np.array_equal(want["disparity"], ref["disparity"])
    np.testing.assert_array_equal(upd.valid.numpy(), want["valid"])
    np.testing.assert_array_equal(upd.disparity.numpy(), want["disparity"])


def test_sgbm_pipeline_with_rectification(pipeline_reference, raw):
    ref = pipeline_reference[True]
    res = _port_pipe(True).process(*raw)
    np.testing.assert_allclose(res.rect_left.numpy(), ref["rect_left"],
                               rtol=0, atol=RECT_ATOL)
    v, vr = res.valid.numpy(), ref["valid"]
    assert v.mean() > 0.5
    assert (v == vr).mean() >= 0.999
    both = v & vr
    assert np.abs(res.disparity.numpy()[both]
                  - ref["disparity"][both]).max() <= 1e-3


def test_bm_pipeline_matches_reference(pipeline_reference, raw):
    ref = pipeline_reference["bm"]
    res = _port_pipe(False, ALGORITHM_DEFAULTS[Algorithm.BM]).process(*raw)
    np.testing.assert_array_equal(res.valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(res.disparity.numpy(), ref["disparity"])


def test_sgbm_accuracy_on_ground_truth():
    """The port's SGBM at the accuracy config on a 96x128 scene with exact
    ground truth: the repo's gate (< 0.25 px median error)."""
    sc = layered_scene(96, 128, max_disp=40, seed=21)
    cfg = dataclasses.replace(config_from_reference(_sgbm_accuracy_cfg()),
                              disparity_range=48)
    res = registry.sgbm_match(torch.from_numpy(sc.left.astype(np.float32)),
                              torch.from_numpy(sc.right.astype(np.float32)),
                              cfg)
    v = res.valid.numpy() & sc.valid
    assert v.mean() > 0.5
    assert np.median(np.abs(res.disparity.numpy() - sc.disparity)[v]) < 0.25
