"""Torch port: census cost -> SGM -> WTA (the plain twins of the
census_cost / sgm_path / sum_wta kernels) against the JAX flagship
kernels ``census_sgm_wta_t`` run in Pallas interpret mode, on the same
numpy inputs. The reference takes transposed census words and returns C
as (B, W, D, H); the port takes (B, H, W, NW) words and returns (B, H, W,
D) — hamming distances do not depend on the bit order, so C must match
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.ops.census import census_transform as ref_census
from i3dr_stereo_tpu.ops.sgm_fused_t import census_sgm_wta_t, right_disparity_from_C_t
from i3dr_stereo_tpu_torch.ops import sgm_fused_t as sf
from i3dr_stereo_tpu_torch.ops.census import census_transform

torch.set_num_threads(2)

HP = WP = 128          # the reference pads both image dims to 128
H_REAL, W_REAL = 90, 101
D = 32


def _pair(B, seed, shift=4):
    rng = np.random.default_rng(seed)
    L = rng.uniform(0, 255, (B, H_REAL, W_REAL + shift)).astype(np.float32)
    L = 0.5 * (L + np.roll(L, 1, 2))           # band-limit a little
    R = L[:, :, :W_REAL] + rng.normal(0, 3, (B, H_REAL, W_REAL))
    L = L[:, :, shift:]
    pad = ((0, 0), (0, HP - H_REAL), (0, WP - W_REAL))
    return (np.pad(L, pad, mode="edge").astype(np.float32),
            np.pad(R, pad, mode="edge").astype(np.float32))


def _words(lp, rp):
    """(reference transposed words, port words) of the padded pair."""
    ref = [jnp.moveaxis(ref_census(jnp.transpose(jnp.asarray(x), (0, 2, 1)),
                                   9, 9), -1, 0) for x in (lp, rp)]
    port = [census_transform(torch.from_numpy(x), 9, 9) for x in (lp, rp)]
    return ref, port


@pytest.mark.parametrize("bpm,directions,ur,B", [
    (-16, 4, 0.0, 1),
    (-16, 8, 0.0, 1),
    (0, 4, 15.0, 2),
    (0, 8, 0.0, 1),
    (5, 4, 0.0, 1),
    (5, 8, 10.0, 1),
])
def test_census_sgm_wta_matches_interpret(bpm, directions, ur, B):
    lp, rp = _pair(B, seed=bpm + 100 * directions)
    (cl_t, cr_t), (cl, cr) = _words(lp, rp)
    rng = np.random.default_rng(directions)
    # fractional per-direction penalties (the engine's /1000-scaled P1/P2)
    pens = tuple((round(float(rng.uniform(0.05, 1.0)), 3),
                  round(float(rng.uniform(1.0, 9.0)), 3))
                 for _ in range(directions))
    d_ref, C_ref = census_sgm_wta_t(cl_t, cr_t, D, bpm=bpm, W_real=W_REAL,
                                    H_real=H_REAL, pens=pens,
                                    directions=directions, subpixel=True,
                                    uniqueness_ratio=ur, interpret=True)
    d, C = sf.census_sgm_wta(cl, cr, D, bpm=bpm, W_real=W_REAL, H_real=H_REAL,
                             pens=pens, directions=directions, subpixel=True,
                             uniqueness_ratio=ur)
    np.testing.assert_array_equal(C.numpy(),
                                  np.asarray(C_ref).transpose(0, 3, 1, 2))
    d_ref = np.asarray(d_ref)
    v, v_ref = d.numpy() > -1e8, d_ref > -1e8
    np.testing.assert_array_equal(v, v_ref)
    assert v[:, :H_REAL, :W_REAL].mean() > 0.2   # a non-trivial comparison
    np.testing.assert_allclose(d.numpy()[v], d_ref[v], rtol=0, atol=1e-4)


def test_census_17x17_forward_sweep_reads_unclamped_hamming():
    """A 17x17 census has 288 bits, so a hamming distance can pass the
    uint8 clamp of 254. The TPU's forward-horizontal sweep recurs on the
    unclamped distance while every other direction, and C itself, read
    min(ham, 254); the port must do the same. A tie-free image against
    its negation drives the distances up to 288."""
    n = 128
    rng = np.random.default_rng(17)
    L = rng.permutation(n * n).reshape(1, n, n).astype(np.float32)
    R = -L
    (cl_t, cr_t) = [jnp.moveaxis(ref_census(jnp.transpose(jnp.asarray(x),
                                                          (0, 2, 1)), 17, 17),
                                 -1, 0) for x in (L, R)]
    cl, cr = [census_transform(torch.from_numpy(x), 17, 17) for x in (L, R)]
    assert cl.shape[-1] == 9
    pens = ((0.1, 0.8),) * 4
    kw = dict(bpm=0, W_real=n, H_real=n, pens=pens, directions=4,
              subpixel=True)
    d_ref, C_ref = census_sgm_wta_t(cl_t, cr_t, D, interpret=True, **kw)
    d, C = sf.census_sgm_wta(cl, cr, D, **kw)
    np.testing.assert_array_equal(C.numpy(),
                                  np.asarray(C_ref).transpose(0, 3, 1, 2))
    assert (C.numpy() == 254).mean() > 0.02      # the clamp is in play
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


def test_right_disparity_from_C_matches_reference():
    rng = np.random.default_rng(21)
    B, Hp, Wp, Dd, W_real, bpm = 2, 8, 40, 16, 35, -6
    C = rng.integers(0, 60, (B, Hp, Wp, Dd)).astype(np.uint8)
    C[rng.uniform(size=C.shape) < 0.1] = 255
    C[:, :, W_real:] = 0                  # zero-cost padding columns
    C[:, 3, :, :] = 255                   # a row with no valid pairing
    d_r, v_r = sf.right_disparity_from_C(torch.from_numpy(C), bpm, W_real)
    rd, rv = right_disparity_from_C_t(jnp.asarray(C.transpose(0, 2, 3, 1)),
                                      bpm, W_real)
    np.testing.assert_array_equal(v_r.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(d_r.numpy()[v_r.numpy()],
                                  np.asarray(rd)[np.asarray(rv)])
    assert not v_r.numpy()[:, 3].any()


def test_right_disparity_ignores_zero_cost_padding():
    """The case of tests/test_i3drsgm.py's guard, in the port's layout:
    padded left columns (x >= W_real) carry zero cost and must lose."""
    B, Wp, Dd, Hp, W_real, bpm = 1, 16, 8, 8, 12, -4
    C = np.full((B, Hp, Wp, Dd), 50, np.uint8)
    C[:, :, W_real:, :] = 0
    C[0, :, 8, 2] = 5                     # genuine best: xr = 10, k = 2
    d_r, v_r = sf.right_disparity_from_C(torch.from_numpy(C), bpm, W_real)
    d_r, v_r = d_r.numpy(), v_r.numpy()
    assert v_r[0, 0, 10] and d_r[0, 0, 10] == bpm + 2
    assert v_r[0, 0, 15] and d_r[0, 0, 15] == bpm
    rd, rv = right_disparity_from_C_t(jnp.asarray(C.transpose(0, 2, 3, 1)),
                                      bpm, W_real)
    np.testing.assert_array_equal(v_r, np.asarray(rv))
    np.testing.assert_array_equal(d_r[v_r], np.asarray(rd)[v_r])


def test_truncation_points_of_the_partial_sums():
    """sum_wta rebuilds the reference's int16 stores: S_fwd = int(fwd),
    S_h = int(rev + S_fwd), S_down = int(sum of downs), then the up
    directions are added untruncated."""
    f = lambda *v: torch.tensor(v, dtype=torch.float32).reshape(1, 1, 1, -1)
    # 4 disparities; fractional path costs chosen so that truncation
    # decides the winner: without it d=1 wins, with it d=0 ties first
    fwd, rev = f(1.9, 1.0, 5.0, 5.0), f(0.9, 0.95, 5.0, 5.0)
    down, up = f(0.6, 0.5, 5.0, 5.0), f(0.0, 0.0, 0.0, 0.0)
    C = torch.zeros((1, 1, 1, 4), dtype=torch.uint8)
    d = sf.sum_wta(C, [fwd, rev, down, up], 1, 1, subpixel=False)
    # S_fwd = (1, 1, 5, 5); S_h = int(1.9, 1.95, ...) = (1, 1, 10, 10);
    # S_down = (0, 0, 5, 5): S = (1, 1, 15, 15) -> first minimum d = 0
    assert d.item() == 0.0
    untruncated = (fwd + rev + down + up)[0, 0, 0]
    assert int(untruncated.argmin()) == 1


def test_uniqueness_and_validity_rules():
    C = torch.zeros((1, 1, 3, 32), dtype=torch.uint8)
    C[0, 0, 1] = 255                      # pixel 1: every pairing invalid
    S = torch.full((1, 1, 3, 32), 50.0)
    S[0, 0, 0, 10] = 10.0                 # pixel 0: clear winner
    S[0, 0, 2, 10], S[0, 0, 2, 20] = 10.0, 10.5   # pixel 2: ambiguous
    zero = torch.zeros_like(S)
    parts = [zero, zero, zero, S]
    d = sf.sum_wta(C, parts, 1, 1, subpixel=True, uniqueness_ratio=10.0)[0, 0]
    assert d[0].item() == 10.0
    assert d[1].item() == sf.NODATA       # cmin == 255
    assert d[2].item() == sf.NODATA       # 10.5 * 0.9 < 10
    d0 = sf.sum_wta(C, parts, 1, 1, subpixel=True, uniqueness_ratio=0.0)[0, 0]
    assert d0[2].item() == 10.0
    with pytest.raises(ValueError, match="path outputs"):
        sf.sum_wta(C, parts[:3], 1, 1, subpixel=True)
