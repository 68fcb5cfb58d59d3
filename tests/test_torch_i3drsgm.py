"""Torch port: the ``I3DRSGM`` engine facade against the JAX package's at
128x160, with the shipped profiles (``quick_profile``: six levels, top
shift -5, speckle and the Gauss fill; ``subpix_profile``: top shift +8
and the half-pel pass), forward and backward, the reference encoding,
every setter and ``.param`` construction. The reference runs the branch
the TPU runs (``I3DR_SGM_BACKEND=pallas_t_interpret``, the speckle
filter in Pallas interpret mode). Images are mono: the reference mirrors
the last axis in ``backward_match``, the channels of a BGR image
(ROADMAP.md Queue 3)."""

import dataclasses

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.config import profile as ref_profile
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.config import profile
from i3dr_stereo_tpu_torch.convert import profile_from_reference
from i3dr_stereo_tpu_torch.matchers.base import MatchResult
from i3dr_stereo_tpu_torch.matchers.i3drsgm import I3DRSGM

torch.set_num_threads(2)

H, W = 128, 160
# valid masks are equal; disparities within 1e-3 px: the Gauss fill's
# weights (an ulp of exp, [5.7e-6 px] with quick_profile) and XLA's FMA in
# the half-pel sample ([1.02e-4 px] with subpix_profile), measured here
# on the CPU
TOL = 1e-3
PROFILES = ("quick_profile", "subpix_profile")


def _scene():
    sc = layered_scene(H, W)
    return sc, sc.left, sc.right


@pytest.fixture(scope="module")
def reference():
    from i3dr_stereo_tpu.matchers.i3drsgm import I3DRSGM as Ref

    _, l, r = _scene()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        for name in PROFILES:
            eng = Ref(profile=getattr(ref_profile, name)())
            fwd = eng.forward_match(l, r)
            bwd = eng.backward_match(l, r)
            out[name] = {
                "fwd": (np.asarray(fwd.disparity), np.asarray(fwd.valid)),
                "bwd": (np.asarray(bwd.disparity), np.asarray(bwd.valid)),
                "enc": np.asarray(eng.reference_encoded(fwd)),
            }
    return out


@pytest.fixture(scope="module")
def port():
    _, l, r = _scene()
    out = {}
    for name in PROFILES:
        eng = I3DRSGM(profile=getattr(profile, name)(), device="cpu")
        fwd, bwd = eng.forward_match(l, r), eng.backward_match(l, r)
        out[name] = {"fwd": fwd, "bwd": bwd,
                     "enc": eng.reference_encoded(fwd).numpy()}
    return out


def _same(got, want):
    d, v = got.disparity.numpy(), got.valid.numpy()
    d_ref, v_ref = want
    assert d.shape == d_ref.shape == (H, W)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", PROFILES)
def test_forward_match_matches_reference(name, reference, port):
    _same(port[name]["fwd"], reference[name]["fwd"])
    if name == "quick_profile":
        # the Gauss fill at level 0 leaves (almost) no hole
        assert port[name]["fwd"].valid.float().mean() > 0.95
    sc, _, _ = _scene()
    d, v = port[name]["fwd"].disparity.numpy(), port[name]["fwd"].valid
    ok = v.numpy() & sc.valid
    assert np.median(np.abs(d - sc.disparity)[ok]) < 0.25


@pytest.mark.parametrize("name", PROFILES)
def test_backward_match_matches_reference(name, reference, port):
    _same(port[name]["bwd"], reference[name]["bwd"])


def test_backward_match_mirrors_the_width_axis(monkeypatch):
    """The matcher sees the swapped images mirrored along the last axis,
    and its result comes back mirrored along it, whatever the width: a
    batch of mono images 3 px wide is not taken for a colour image."""
    eng = I3DRSGM(device="cpu")
    seen = []

    def match(left, right):
        seen.append((left, right))
        return MatchResult(disparity=left + 0.5 * right, valid=left > 2)

    monkeypatch.setattr(eng, "_match", match)
    rng = np.random.default_rng(5)
    for shape in ((2, 4, 3), (4, 3), (3, 5)):
        l = rng.integers(0, 6, shape).astype(np.float32)
        r = rng.integers(0, 6, shape).astype(np.float32)
        res = eng.backward_match(l, r)
        sl, sr = seen.pop()
        np.testing.assert_array_equal(sl.numpy(), r[..., ::-1])
        np.testing.assert_array_equal(sr.numpy(), l[..., ::-1])
        np.testing.assert_array_equal(res.disparity.numpy(), r + 0.5 * l)
        np.testing.assert_array_equal(res.valid.numpy(), r > 2)


@pytest.mark.parametrize("name", PROFILES)
def test_reference_encoded_matches_reference(name, reference, port):
    enc, enc_ref = port[name]["enc"], reference[name]["enc"]
    res = port[name]["fwd"]
    v = res.valid.numpy()
    assert (enc[~v] == -10000.0).all()
    np.testing.assert_array_equal(enc[v], res.disparity.numpy()[v] * -16.0)
    np.testing.assert_allclose(enc, enc_ref, rtol=0, atol=16 * TOL)


def test_enable_cpu_runs_the_twins_and_is_the_cpu_path(port):
    """``enableCPU`` selects the plain twins on the facade's device; on
    the CPU that is what runs anyway, so the results are identical."""
    _, l, r = _scene()
    eng = I3DRSGM(device="cpu")
    assert eng.plain is False and eng.profile == profile.quick_profile()
    eng.enableCPU(True)
    assert eng.plain is True
    res = eng.match(torch.from_numpy(l), torch.from_numpy(r))
    assert torch.equal(res.disparity, port["quick_profile"]["fwd"].disparity)
    assert torch.equal(res.valid, port["quick_profile"]["fwd"].valid)
    eng.enableCPU(False)
    assert eng.plain is False


SETTERS = {
    "setP1": [("setP1", 150.0)],
    "setP2": [("setP2", 1200.0)],
    "setDisparityRange_even": [("setDisparityRange", 520)],
    "setDisparityRange_odd": [("setDisparityRange", 410)],
    "setSpeckleDifference": [("setSpeckleDifference", 7.0)],
    "setSpeckleSize": [("setSpeckleSize", 995)],
    "setMinDisparity": [("setMinDisparity", 400.0)],
    "setMinDisparity_after_maxPyramid": [("maxPyramid", 2),
                                         ("setMinDisparity", -90.0)],
    "setWindowSize_clamped": [("setWindowSize", 20)],
    "setWindowSize_even": [("setWindowSize", 6)],
    "setBackmatchingDistance": [("setBackmatchingDistance", 2.5)],
    "enableBackmatching": [("enableBackmatching", False)],
    "enableSubpixel": [("enableSubpixel", False)],
    "enableInterpolation": [("enableInterpolation", False)],
    "enableOcclusionDetection": [("enableOcclusionDetection", True)],
    "enableOcclusionInterpolation": [("enableOcclusionInterpolation",
                                      False)],
    "enablePyramid": [("enablePyramid", 1, 3)],
    "maxPyramid": [("maxPyramid", 2)],
}


@pytest.mark.parametrize("case", list(SETTERS))
@pytest.mark.parametrize("name", PROFILES)
def test_setters_match_reference(case, name):
    """Every setter, with its ROS-unit quirk, leaves the port's profile
    equal field for field to the JAX facade's."""
    from i3dr_stereo_tpu.matchers.i3drsgm import I3DRSGM as Ref

    ref = Ref(profile=getattr(ref_profile, name)())
    eng = I3DRSGM(profile=getattr(profile, name)(), device="cpu")
    for setter, *args in SETTERS[case]:
        getattr(ref, setter)(*args)
        getattr(eng, setter)(*args)
    assert eng.profile == profile_from_reference(ref.profile)
    assert eng.profile != getattr(profile, name)()


def test_set_nodata_value():
    from i3dr_stereo_tpu.matchers.i3drsgm import I3DRSGM as Ref

    ref, eng = Ref(), I3DRSGM(device="cpu")
    assert eng.nodata == ref.nodata == -10000.0
    ref.setNoDataValue(-1)
    eng.setNoDataValue(-1)
    assert eng.nodata == ref.nodata == -1.0
    res = eng.match(np.zeros((40, 64), np.float32),
                    np.zeros((40, 64), np.float32))
    enc = eng.reference_encoded(res)
    assert bool((enc[~res.valid] == -1.0).all())


def test_construction_from_param_file(tmp_path):
    from i3dr_stereo_tpu.matchers.i3drsgm import I3DRSGM as Ref

    path = tmp_path / "engine.param"
    path.write_text("[Parameter]\nPyramid Levels = 2\n"
                    "Top Prediction Shift = 1\n\n[Pyramid 1]\n"
                    "Number Of Disparities = 21\n\n[Pyramid 0]\n"
                    "Interpolator Mode = WLS\nOcclusion Detection = true\n\n"
                    "[Pyramid 0 Subpix]\nDisparity Step Size = 0.5\n")
    eng = I3DRSGM(param_file=str(path), device="cpu")
    ref = Ref(param_file=str(path))
    assert eng.profile == profile_from_reference(ref.profile)
    assert [(lv.level, lv.subpix_pass) for lv in eng.profile.levels] == \
        [(1, False), (0, False), (0, True)]
    # a profile given beside a file wins, as in the reference
    quick = profile.quick_profile()
    assert I3DRSGM(str(path), quick, device="cpu").profile is quick
    sc = layered_scene(64, 80, max_disp=16, seed=3)
    res = eng.match(sc.left, sc.right)
    assert tuple(res.disparity.shape) == (64, 80)
    assert bool(torch.isfinite(res.disparity).all())


def test_facade_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        I3DRSGM()
    assert I3DRSGM(device="cpu").device == torch.device("cpu")


def test_batch_and_numpy_inputs(port):
    """(B, H, W) batches match frame by frame; numpy, tensors and uint8
    are taken alike."""
    sc, l, r = _scene()
    eng = I3DRSGM(device="cpu")
    lb = np.stack([l, l])
    rb = np.stack([r, r])
    res = eng.match(lb, rb)
    assert tuple(res.disparity.shape) == (2, H, W)
    for i in range(2):
        assert torch.equal(res.disparity[i],
                           port["quick_profile"]["fwd"].disparity)
    u8 = eng.match(np.clip(l, 0, 255).astype(np.uint8),
                   np.clip(r, 0, 255).astype(np.uint8))
    assert u8.disparity.dtype == torch.float32
    assert dataclasses.is_dataclass(u8)
