"""Torch port: element ops and the row-gather kernel's plain twin against
the JAX reference on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.matchers import pyramid as ref_pyr
from i3dr_stereo_tpu.ops import block_gather as ref_bg
from i3dr_stereo_tpu.ops import depth as ref_depth
from i3dr_stereo_tpu.ops.census import census_transform as ref_census
from i3dr_stereo_tpu.ops.median import median3x3 as ref_median
from i3dr_stereo_tpu.ops.median import median3x3_masked as ref_median_masked
from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
from i3dr_stereo_tpu_torch.ops import block_gather as bg
from i3dr_stereo_tpu_torch.ops import depth
from i3dr_stereo_tpu_torch.ops.census import census_transform
from i3dr_stereo_tpu_torch.ops.median import median3x3, median3x3_masked

torch.set_num_threads(2)


def _img(shape, seed=0, levels=None):
    rng = np.random.default_rng(seed)
    if levels:  # few distinct values: many ties for the strict '>'
        return rng.integers(0, levels, shape).astype(np.float32)
    return rng.uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("hw,shape,levels", [
    ((9, 9), (2, 19, 33), None),
    ((9, 9), (17, 40), 4),
    ((5, 7), (1, 12, 21), 3),
])
def test_census_words_exact(hw, shape, levels):
    img = _img(shape, seed=3, levels=levels)
    ref = np.asarray(ref_census(jnp.asarray(img), *hw))
    out = census_transform(torch.from_numpy(img), *hw)
    assert out.dtype == torch.int32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("shape", [(2, 13, 17), (9, 8)])
def test_median3x3_and_masked(shape):
    x = _img(shape, seed=5, levels=7)
    valid = np.random.default_rng(6).uniform(size=shape) > 0.3
    np.testing.assert_array_equal(median3x3(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref_median(jnp.asarray(x))))
    np.testing.assert_array_equal(
        median3x3_masked(torch.from_numpy(x), torch.from_numpy(valid)).numpy(),
        np.asarray(ref_median_masked(jnp.asarray(x), jnp.asarray(valid))))


@pytest.mark.parametrize("shape", [(1, 33, 47), (2, 64, 81), (1, 7, 5)])
def test_downsample2_exact(shape):
    x = _img(shape, seed=8)
    np.testing.assert_array_equal(
        pyr._downsample2(torch.from_numpy(x)).numpy(),
        np.asarray(ref_pyr._downsample2(jnp.asarray(x))))


@pytest.mark.parametrize("src,dst", [((16, 23), (33, 47)), ((32, 40), (64, 81)),
                                     ((153, 306), (306, 612)),
                                     ((3, 5), (7, 11))])
def test_upsample2_disp_exact(src, dst):
    d = _img((1,) + src, seed=9)
    np.testing.assert_array_equal(
        pyr._upsample2_disp(torch.from_numpy(d), *dst).numpy(),
        np.asarray(ref_pyr._upsample2_disp(jnp.asarray(d), *dst)))


def _depth_inputs(seed=11):
    rng = np.random.default_rng(seed)
    H, W = 24, 31
    disp = rng.uniform(-2, 60, (2, H, W)).astype(np.float32)
    disp[0, 0, :4] = 0.0
    disp[1, 3, :3] = 10000.0
    valid = rng.uniform(size=(2, H, W)) > 0.2
    from i3dr_stereo_tpu.core.camera import StereoRig

    Q = StereoRig.synthetic(W, H, fx=300.0, baseline_m=0.2).Q.astype(np.float32)
    Q[3, 3] = 0.05  # non-zero cx offset term
    img = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    return disp, valid, Q, img


def test_depth_points_crop_match():
    disp, valid, Q, img = _depth_inputs()
    lo, hi = 1.0, 40.0
    td = [torch.from_numpy(a) for a in (disp, valid, Q, img)]
    z, ok = depth.disparity_to_depth(td[0], td[1], td[2], lo, hi)
    rz, rok = ref_depth.disparity_to_depth(jnp.asarray(disp), jnp.asarray(valid),
                                           jnp.asarray(Q), lo, hi)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(z.numpy(), np.asarray(rz), rtol=1e-6)

    for b in range(2):
        pc = depth.disparity_to_pointcloud(td[0][b], td[1][b], td[2], td[3][b],
                                           lo, hi)
        rpc = ref_depth.disparity_to_pointcloud(
            jnp.asarray(disp[b]), jnp.asarray(valid[b]), jnp.asarray(Q),
            jnp.asarray(img[b]), lo, hi)
        np.testing.assert_array_equal(pc["valid"].numpy(),
                                      np.asarray(rpc["valid"]))
        m = pc["valid"].numpy()
        np.testing.assert_allclose(pc["xyz"].numpy()[m],
                                   np.asarray(rpc["xyz"])[m], rtol=1e-6)
        np.testing.assert_array_equal(pc["rgb"].numpy(), np.asarray(rpc["rgb"]))
    # batched cloud = per-image clouds stacked
    pcb = depth.disparity_to_pointcloud(td[0], td[1], td[2], td[3], lo, hi)
    assert tuple(pcb["xyz"].shape) == (2, 24 * 31, 3)
    np.testing.assert_array_equal(pcb["valid"][1].numpy(), pc["valid"].numpy())

    crop = depth.crop_by_disparity(td[3], td[0], td[1])
    rcrop = ref_depth.crop_by_disparity(jnp.asarray(img), jnp.asarray(disp),
                                        jnp.asarray(valid))
    np.testing.assert_array_equal(crop.numpy(), np.asarray(rcrop))


def test_block_anchors_match():
    rng = np.random.default_rng(12)
    pred = rng.integers(0, 90, (2, 24, 300)).astype(np.int32)
    np.testing.assert_array_equal(
        bg.block_anchors(torch.from_numpy(pred)).numpy(),
        np.asarray(ref_bg.block_anchors(jnp.asarray(pred))))


@pytest.mark.parametrize("B,H,W,radius,seed", [
    (1, 16, 128, 16, 0),     # the warp: anchor band of the residual window
    (2, 24, 300, 17, 1),     # the backmatch lookup radius, ragged width
    (1, 16, 70, 5, 2),
    (1, 8, 131, 63, 3),      # the reference's largest radius; W % 4, W % 128
    (2, 16, 256, 0, 4),      # radius 0
])
def test_block_shift_gather_matches_interpret(B, H, W, radius, seed):
    """Random indices and anchors reach both clamps: the anchor band and
    the image edge."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    idx = rng.integers(-40, W + 40, (B, H, W)).astype(np.int32)
    q = rng.integers(-10, W + 10, (B, H // 8, (W + 127) // 128)).astype(np.int32)
    q[0, 0, 0] = W + radius + 4     # every source left of the image
    q[-1, -1, -1] = -radius - 4     # sources right of the image
    ref = np.asarray(ref_bg.block_shift_gather(
        jnp.asarray(src), jnp.asarray(idx), jnp.asarray(q), radius,
        interpret=True))
    out = bg.block_shift_gather(torch.from_numpy(src), torch.from_numpy(idx),
                                torch.from_numpy(q), radius)
    np.testing.assert_array_equal(out.numpy(), ref)
    # both clamps were exercised
    q_up = np.repeat(np.repeat(q, 8, 1), 128, 2)[:, :H, :W]
    assert ((idx < q_up - radius) | (idx > q_up + radius)).any()
    eff = np.clip(idx, q_up - radius, q_up + radius)
    col = np.arange(W) - eff
    assert (col < 0).any() and (col >= W).any()


def test_block_shift_gather_rejects_bad_shapes():
    src = torch.zeros((1, 16, 130))
    idx = torch.zeros((1, 16, 130), dtype=torch.int32)
    with pytest.raises(ValueError, match="q must be"):
        bg.block_shift_gather(src, idx, torch.zeros((1, 2, 1), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="int32"):
        bg.block_shift_gather(src, idx.float(),
                              torch.zeros((1, 2, 2), dtype=torch.int32), 4)
