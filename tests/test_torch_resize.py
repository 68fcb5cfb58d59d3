"""Torch port: the resizes behind ``downsample_scale`` (``ops/resize.py``)
and ``StereoMatcher`` with ``downsample_scale != 1`` against the JAX
package on the same inputs.

Measured on the CPU (and asserted below):

- the cubic weights are the reference's formula, but XLA computes the
  reference's at run time with its own algebra (the kernel's constants
  folded into products) and contracts them with its own dot: the
  weights agree within 6e-7, and at a scale of 0.5 the resized images
  are bit-equal, at 0.6, 0.75 and when enlarging within 2.0e-4 grey
  levels of 255 (``CUBIC_ATOL``);
- the nearest resize is bit-equal at every size tried; its index is
  XLA's folded ``(i + 0.5) * (n_in * (1 / n_out))``, which at 18 -> 127 px
  picks another source than a true division (which the pyramid's
  upsampling used before it took this one);
- SGBM at 96x128 with scale 0.5 (the reference's own test case) is
  bit-equal forwards and backwards; BM at 97x131 with scale 0.75 has
  equal masks and disparities within 1.2e-5 px (``DISP_ATOL``: its
  subpixel parabola on images ulps apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.config import params
from i3dr_stereo_tpu_torch.convert import config_from_reference
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.matchers import base
from i3dr_stereo_tpu_torch.ops import resize
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

torch.set_num_threads(2)

CUBIC_ATOL = 1e-3   # grey levels (measured 2.0e-4)
DISP_ATOL = 1e-4    # px, BM at scale 0.75 (measured 1.2e-5)


@pytest.mark.parametrize("src,dst", [
    ((96, 128), (48, 64)),    # 0.5: bit-equal
    ((37, 53), (22, 32)),     # 0.6
    ((97, 131), (73, 98)),    # 0.75, odd
    ((23, 29), (41, 60)),     # enlarging
])
def test_cubic_resize_matches_reference(src, dst):
    rng = np.random.default_rng(src[0])
    x = rng.uniform(0, 255, (2,) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst, "cubic"))
    got = resize.resize_cubic(torch.from_numpy(x), *dst).numpy()
    assert got.shape == want.shape
    if src[0] == 2 * dst[0] and src[1] == 2 * dst[1]:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=CUBIC_ATOL)


def test_cubic_resize_keeps_an_unchanged_axis():
    x = torch.arange(35, dtype=torch.float32).reshape(5, 7)
    out = resize.resize_cubic(x, 5, 4)
    want = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), (5, 4),
                                       "cubic"))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=CUBIC_ATOL)
    assert torch.equal(resize.resize_cubic(x, 5, 7), x)


@pytest.mark.parametrize("src,dst", [
    ((48, 64), (96, 128)), ((73, 98), (97, 131)), ((22, 32), (37, 53)),
    ((18, 22), (127, 73)), ((41, 60), (23, 29)), ((7, 5), (7, 5)),
])
def test_nearest_resize_bit_equal(src, dst):
    rng = np.random.default_rng(src[1])
    x = rng.uniform(0, 255, (2,) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst,
                                       "nearest"))
    got = resize.resize_nearest(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def sgm_branch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        yield


CASES = {
    # the reference's test_matchers.py::test_downsample_scale
    "sgbm_half": (Algorithm.SGBM, (96, 128), 0.5),
    "bm_three_quarters_odd": (Algorithm.BM, (97, 131), 0.75),
}


def _case(name):
    alg, shape, scale = CASES[name]
    sc = layered_scene(*shape, max_disp=16)
    cfg = ALGORITHM_DEFAULTS[alg].replace(
        disparity_range=16, downsample_scale=scale, speckle_size=0)
    return cfg, sc


@pytest.fixture(scope="module")
def reference(sgm_branch):
    from i3dr_stereo_tpu.matchers.base import create_matcher

    out = {}
    for name in CASES:
        cfg, sc = _case(name)
        m = create_matcher(cfg)
        out[name] = [(np.asarray(r.disparity), np.asarray(r.valid))
                     for r in (m.match(sc.left, sc.right),
                               m.backward_match(sc.left, sc.right))]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_downsampled_matcher_matches_reference(name, reference):
    cfg, sc = _case(name)
    m = base.create_matcher(config_from_reference(cfg), device="cpu")
    got = (m.match(sc.left, sc.right), m.backward_match(sc.left, sc.right))
    for res, (d_ref, v_ref) in zip(got, reference[name]):
        d, v = res.disparity.numpy(), res.valid.numpy()
        assert d.shape == sc.left.shape and v.shape == d.shape
        np.testing.assert_array_equal(v, v_ref)
        if cfg.downsample_scale == 0.5:
            np.testing.assert_array_equal(d, d_ref)
        np.testing.assert_allclose(d[v], d_ref[v], rtol=0, atol=DISP_ATOL)
    # the gates of the reference's own test
    fwd = got[0]
    sel = fwd.valid.numpy() & sc.valid
    assert sel.mean() > 0.5
    assert np.median(np.abs(fwd.disparity.numpy() - sc.disparity)[sel]) < 1.0


def test_pipeline_ignores_downsample_scale():
    """As in the reference, ``StereoPipeline`` calls the registry directly
    and never resizes."""
    cfg, sc = _case("sgbm_half")
    H, W = sc.left.shape
    frames = [np.clip(x, 0, 255).astype(np.uint8) for x in (sc.left,
                                                            sc.right)]
    out = []
    for scale in (1.0, 0.5):
        pipe = StereoPipeline(StereoRig.synthetic(W, H),
                              config_from_reference(cfg).replace(
                                  downsample_scale=scale),
                              params.PointCloudConfig(), device="cpu",
                              rectify_inputs=False)
        out.append(pipe.process(*frames))
    assert torch.equal(out[0].disparity, out[1].disparity)
    assert torch.equal(out[0].valid, out[1].valid)
