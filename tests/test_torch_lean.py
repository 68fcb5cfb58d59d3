"""Torch port: the lean routes (``lean=True``: the lean pyramid and SGBM
at window 1, through the matchers, the facade and ``StereoPipeline``)
against the JAX package under ``I3DR_SGM_BACKEND=pallas_interpret``, the
reference's second SGM backend run in Pallas interpret mode, on the same
inputs. Disparity and valid must agree exactly; through rectification
the rectified images agree within 1e-4 (XLA's CPU backend fuses the
reference remap's multiply-adds, see tests/test_torch_pipeline_full.py)."""

import cv2
import jax.numpy as jnp
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
from i3dr_stereo_tpu_torch.convert import (
    config_from_reference,
    lean_from_backend,
    rig_from_reference,
)
from i3dr_stereo_tpu_torch.matchers import base, pyramid, registry
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

torch.set_num_threads(2)

BACKEND = "pallas_interpret"
CLOUD = dict(depth_max=100.0, depth_min=0.5)
RECT_ATOL = 1e-4
PH, PW = 64, 96

# tests/test_fused_sgm.py:test_lean_pyramid_uses_fused_path's config
PYRAMID_CFG = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
    disparity_range=32, speckle_size=50)
# tests/test_fused_sgm.py:test_lean_sgbm_bt_path's config, with the LR
# check, a minimum disparity and the median on
SGBM1_CFG = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
    disparity_range=32, window_size=1, p1=8.0, p2=32.0, speckle_size=30,
    uniqueness_ratio=5.0, disp12_max_diff=1.0, min_disparity=2,
    median_filter=True)
SGBM5_CFG = SGBM1_CFG.replace(window_size=5, p1=200.0, p2=400.0)
# 8 paths and a 17x17 census: distances above the uint8 clamp
PYRAMID8_CFG = PYRAMID_CFG.replace(num_directions=8, census_width=17,
                                   census_height=17, max_pyramid_level=2,
                                   speckle_size=0, uniqueness_ratio=5.0)

MATCH_CASES = {
    "pyramid": (PYRAMID_CFG, (96, 128), 5),
    "pyramid_8path_17x17": (PYRAMID8_CFG, (72, 100), 8),
    "sgbm_window1": (SGBM1_CFG, (48, 64), 7),
    "sgbm_window1_5path_ragged": (
        SGBM1_CFG.replace(num_directions=5, min_disparity=0), (45, 61), 7),
    "sgbm_window5": (SGBM5_CFG, (48, 64), 7),
}


def _scene(shape, seed):
    sc = layered_scene(*shape, max_disp=min(20, shape[1] // 3), seed=seed)
    return sc.left.astype(np.float32), sc.right.astype(np.float32)


@pytest.fixture(scope="module")
def lean_backend():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", BACKEND)
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        mp.setenv("I3DR_REMAP_BACKEND", "gather")
        yield


@pytest.fixture(scope="module")
def reference(lean_backend):
    from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY

    out = {}
    for name, (cfg, shape, seed) in MATCH_CASES.items():
        l, r = _scene(shape, seed)
        res = MATCHER_REGISTRY[cfg.algorithm](l, r, cfg)
        out[name] = (np.asarray(res.disparity), np.asarray(res.valid))
    return out


def _port(name, lean):
    cfg, shape, seed = MATCH_CASES[name]
    l, r = _scene(shape, seed)
    return registry.compute_disparity(
        torch.from_numpy(l), torch.from_numpy(r), config_from_reference(cfg),
        lean=lean)


@pytest.mark.parametrize("name", list(MATCH_CASES))
def test_lean_matcher_matches_reference(name, reference):
    res = _port(name, lean_from_backend(BACKEND))
    d_ref, v_ref = reference[name]
    v = res.valid.numpy()
    assert 0.3 < v.mean() < 1.0
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(res.disparity.numpy(), d_ref)


def test_lean_is_a_different_route_only_where_the_reference_has_one():
    """Window 5 falls through to the default branch; window 1 and the
    pyramid do not compute what lean=False computes."""
    same = _port("sgbm_window5", False)
    lean = _port("sgbm_window5", True)
    assert torch.equal(same.disparity, lean.disparity)
    assert torch.equal(same.valid, lean.valid)
    for name in ("sgbm_window1", "pyramid"):
        a, b = _port(name, False), _port(name, True)
        assert not torch.equal(a.disparity, b.disparity)


def test_lean_false_is_the_default_branch():
    """lean=False is what the port computed before the lean routes
    existed: the TPU's default backend (``pallas_t_interpret``)."""
    cfg, shape, seed = MATCH_CASES["sgbm_window1"]
    l, r = _scene(shape, seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        from i3dr_stereo_tpu.matchers.registry import sgbm_match

        ref = sgbm_match(l, r, cfg)
    for res in (_port("sgbm_window1", False),
                registry.sgbm_match(torch.from_numpy(l), torch.from_numpy(r),
                                    config_from_reference(cfg))):
        np.testing.assert_array_equal(res.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(res.disparity.numpy(),
                                      np.asarray(ref.disparity))


def test_lean_pyramid_accuracy_and_twins_switch(reference):
    """The repo's own gate on the lean pyramid (tests/test_fused_sgm.py),
    and plain=True equals the default route on the CPU."""
    cfg, shape, seed = MATCH_CASES["pyramid"]
    sc = layered_scene(*shape, max_disp=20, seed=seed)
    l, r = torch.from_numpy(sc.left), torch.from_numpy(sc.right)
    res = pyramid.pyramid_sgm_match(l, r, config_from_reference(cfg),
                                    lean=True, plain=True)
    np.testing.assert_array_equal(res.disparity.numpy(),
                                  reference["pyramid"][0])
    v = res.valid.numpy() & sc.valid
    err = np.abs(res.disparity.numpy() - sc.disparity)[v]
    assert v.mean() > 0.5 and np.median(err) < 0.25
    assert (err < 1).mean() > 0.95


@pytest.mark.parametrize("seed,max_diff", [(0, 1.5), (1, 0.0), (2, 3.0)])
def test_roundtrip_check_matches_reference(seed, max_diff):
    from i3dr_stereo_tpu.matchers.pyramid import _roundtrip_check

    rng = np.random.default_rng(seed)
    B, H, W = 2, 9, 50
    disp = (rng.uniform(-3, 30, (B, H, W))
            + 10 * (rng.random((B, H, W)) < 0.2)).astype(np.float32)
    disp[0, :, 10:20] = np.round(disp[0, :, 10:20])      # ties on one column
    valid = rng.random((B, H, W)) < 0.8
    _, v_ref = _roundtrip_check(jnp.asarray(disp), jnp.asarray(valid),
                                max_diff)
    got = pyramid._roundtrip_check(torch.from_numpy(disp),
                                   torch.from_numpy(valid), max_diff)
    np.testing.assert_array_equal(got.numpy(), np.asarray(v_ref))
    assert 0.05 < got.float().mean() < 0.8


def test_create_matcher_lean(reference, lean_backend):
    from i3dr_stereo_tpu.matchers.base import create_matcher as ref_create

    cfg, shape, seed = MATCH_CASES["sgbm_window1"]
    l, r = _scene(shape, seed)
    m = base.create_matcher(config_from_reference(cfg), lean=True,
                            device="cpu")
    assert m.lean and not base.create_matcher(params.Algorithm.SGBM,
                                              device="cpu").lean
    fwd = m.match(l, r)
    np.testing.assert_array_equal(fwd.disparity.numpy(),
                                  reference["sgbm_window1"][0])
    np.testing.assert_array_equal(fwd.valid.numpy(),
                                  reference["sgbm_window1"][1])
    bwd_ref = ref_create(cfg).backward_match(l, r)
    bwd = m.backward_match(l, r)
    np.testing.assert_array_equal(bwd.valid.numpy(), np.asarray(bwd_ref.valid))
    np.testing.assert_array_equal(bwd.disparity.numpy(),
                                  np.asarray(bwd_ref.disparity))
    # BM has no SGM: lean changes nothing
    bm = params.ALGORITHM_DEFAULTS[params.Algorithm.BM]
    a = registry.bm_match(torch.from_numpy(l), torch.from_numpy(r), bm)
    b = registry.bm_match(torch.from_numpy(l), torch.from_numpy(r), bm,
                          lean=True)
    assert torch.equal(a.disparity, b.disparity)
    assert torch.equal(a.valid, b.valid)


def test_lean_from_backend_and_config_has_no_lean_field():
    assert lean_from_backend("pallas") and lean_from_backend(
        "pallas_interpret")
    assert not lean_from_backend("pallas_t")
    assert not lean_from_backend("pallas_t_interpret")
    with pytest.raises(ValueError, match="no counterpart"):
        lean_from_backend("xla")
    assert "lean" not in {f.name for f in
                          params.MatcherConfig.__dataclass_fields__.values()}


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _rig():
    """The distorted 96x64 rig of tests/test_torch_registry.py."""
    K = np.array([[90.0, 0, 48.0], [0, 90.0, 32.0], [0, 0, 1]])
    D = 0.2 * np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    R = cv2.Rodrigues(np.array([0.002, -0.003, 0.001]))[0]
    Pl = np.array([[88.5, 0, 47.5, 0], [0, 88.5, 32.5, 0], [0, 0, 1, 0]])
    Pr = Pl.copy()
    Pr[0, 2] = 48.5
    Pr[0, 3] = -88.5 * 0.3
    return StereoRig(CameraModel(PW, PH, K, D, R, Pl),
                     CameraModel(PW, PH, K, D, R, Pr))


PIPE_CFGS = {"pyramid": PYRAMID_CFG.replace(max_pyramid_level=2),
             "sgbm_window1": SGBM1_CFG}
KEYS = ("rect_left", "disparity", "valid", "depth_valid")


@pytest.fixture(scope="module")
def raw():
    sc = layered_scene(PH, PW, max_disp=20, seed=3)
    return (np.clip(sc.left, 0, 255).astype(np.uint8),
            np.clip(sc.right, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def pipeline_reference(lean_backend, raw):
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline as Ref

    out = {}
    for name, cfg in PIPE_CFGS.items():
        for rect in (False, True):
            rig = _rig() if rect else StereoRig.synthetic(PW, PH)
            pipe = Ref(rig, cfg, PointCloudConfig(**CLOUD),
                       rectify_inputs=rect)
            res = pipe.process(*raw)
            out[name, rect] = {k: np.asarray(getattr(res, k)) for k in KEYS}
    return out


def _port_pipe(name, rect):
    rig = _rig() if rect else StereoRig.synthetic(PW, PH)
    return StereoPipeline(rig_from_reference(rig),
                          config_from_reference(PIPE_CFGS[name]),
                          params.PointCloudConfig(**CLOUD), device="cpu",
                          rectify_inputs=rect, lean=True)


@pytest.mark.parametrize("name", list(PIPE_CFGS))
def test_lean_pipeline_exact_without_rectification(name, pipeline_reference,
                                                   raw):
    ref = pipeline_reference[name, False]
    res = _port_pipe(name, False).process(*raw)
    assert 0.3 < res.valid.float().mean() < 1.0
    np.testing.assert_array_equal(res.valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(res.disparity.numpy(), ref["disparity"])
    np.testing.assert_array_equal(res.depth_valid.numpy(), ref["depth_valid"])


@pytest.mark.parametrize("name", list(PIPE_CFGS))
def test_lean_pipeline_with_rectification(name, pipeline_reference, raw):
    ref = pipeline_reference[name, True]
    res = _port_pipe(name, True).process(*raw)
    np.testing.assert_allclose(res.rect_left.numpy(), ref["rect_left"],
                               rtol=0, atol=RECT_ATOL)
    v, vr = res.valid.numpy(), ref["valid"]
    assert v.mean() > 0.3
    assert (v == vr).mean() >= 0.999
    both = v & vr
    assert np.abs(res.disparity.numpy()[both]
                  - ref["disparity"][both]).max() <= 1e-3
