"""Torch port: the dense matchers' cost ops (prefilters, BT / SAD / census
cost volumes, box aggregation, texture), WTA and the LR check against
the JAX package on the same numpy inputs, exactly, on integer-valued and
fractional images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.ops import cost as rc
from i3dr_stereo_tpu.ops import lr_check as rl
from i3dr_stereo_tpu.ops import wta as rw
from i3dr_stereo_tpu.ops.census import census_cost_volume as ref_census_cost
from i3dr_stereo_tpu.ops.census import census_transform as ref_census
from i3dr_stereo_tpu_torch.ops import cost, lr_check, wta
from i3dr_stereo_tpu_torch.ops.census import census_cost_volume, census_transform

torch.set_num_threads(2)

B, H, W = 2, 21, 37


def _images(kind, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, (B, H, W + 3))
    if kind == "int":
        a = np.round(a)
    left = a[:, :, 3:].astype(np.float32)
    right = (a[:, :, :W] + (0 if kind == "int" else
                            rng.normal(0, 2, (B, H, W)))).astype(np.float32)
    return left, right


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["int", "frac"])
def test_prefilters(kind):
    left, _ = _images(kind)
    _eq(cost.xsobel_prefilter(torch.from_numpy(left), 31),
        rc.xsobel_prefilter(jnp.asarray(left), 31))
    _eq(cost.xsobel_prefilter(torch.from_numpy(left[0]), 15),
        rc.xsobel_prefilter(jnp.asarray(left[0]), 15))
    for win in (5, 9):
        _eq(cost.normalized_response_prefilter(torch.from_numpy(left), win,
                                               31),
            rc.normalized_response_prefilter(jnp.asarray(left), win, 31))


def test_normalized_response_long_scan():
    """Window sums over more than 256 rows: the cumulative sums recurse
    into a second level of 16-blocks."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (1, 300, 20)).astype(np.float32)
    _eq(cost.normalized_response_prefilter(torch.from_numpy(img), 9, 31),
        rc.normalized_response_prefilter(jnp.asarray(img), 9, 31))


@pytest.mark.parametrize("kind,min_d,D", [("int", 0, 16), ("frac", 0, 16),
                                          ("frac", 5, 12)])
def test_cost_volumes_and_box_aggregate(kind, min_d, D):
    left, right = _images(kind, seed=D + min_d)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    lj, rj = jnp.asarray(left), jnp.asarray(right)
    for port_fn, ref_fn in ((cost.bt_cost_volume, rc.bt_cost_volume),
                            (cost.sad_cost_volume, rc.sad_cost_volume)):
        C, v = port_fn(lt, rt, min_d, D)
        Cr, vr = ref_fn(lj, rj, min_d, D)
        _eq(C, Cr)
        _eq(v, vr)
        for win in (1, 3, 5, 9):
            _eq(cost.box_aggregate(C, v, win), rc.box_aggregate(Cr, vr, win))


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("min_d", [0, 5, 40])
@pytest.mark.parametrize("window", [1, 3, 5, 9, 11, 15, 21])
@pytest.mark.parametrize("kind", ["int", "frac"])
def test_bt_box_cost_volume_twin(kind, window, min_d, B):
    """``bt_box_cost_volume``'s plain twin (the route of a CPU tensor and
    what the ``bt_box_cost`` kernel is held to) against the reference's
    box_aggregate(*bt_cost_volume(...)). 21x75 (not multiples of 8), D =
    40 (a full and a partial tile of 32 disparities); min_d = 40 leaves
    the first 40 columns with no valid disparity."""
    rng = np.random.default_rng(100 * window + min_d + B)
    a = rng.uniform(0, 62, (2, B, 21, 75))
    if kind == "int":
        a = np.round(a)
    left, right = a.astype(np.float32)
    D = 40
    got = cost.bt_box_cost_volume(torch.from_numpy(left),
                                  torch.from_numpy(right), min_d, D, window)
    ref = rc.box_aggregate(*rc.bt_cost_volume(jnp.asarray(left),
                                              jnp.asarray(right), min_d, D),
                           window)
    _eq(got, ref)
    assert bool((got[:, :, :min_d] == cost.BIG_COST).all())
    assert bool((got < cost.BIG_COST).any())


@pytest.mark.parametrize("kind", ["int", "frac"])
def test_box_sum_and_texture(kind):
    left, _ = _images(kind, seed=7)
    for win in (3, 5, 9):
        _eq(cost.box_sum(torch.from_numpy(left), win),
            rc.box_sum(jnp.asarray(left), win, (1, 2)))
        pref = cost.xsobel_prefilter(torch.from_numpy(left), 31)
        _eq(cost.texture_response(pref, win, 31),
            rc.texture_response(jnp.asarray(pref.numpy()), win, 31))


@pytest.mark.parametrize("min_d", [0, 3])
def test_census_cost_volume(min_d):
    left, right = _images("frac", seed=11)
    cl = census_transform(torch.from_numpy(left), 7, 7)
    cr = census_transform(torch.from_numpy(right), 7, 7)
    C, v = census_cost_volume(cl, cr, min_d, 16)
    Cr, vr = ref_census_cost(ref_census(jnp.asarray(left), 7, 7),
                             ref_census(jnp.asarray(right), 7, 7), min_d, 16)
    _eq(C, Cr)
    _eq(v, vr)


def _volume(seed, D=24, integer=False):
    """An aggregated-cost-like volume: smooth costs with a clear minimum
    per pixel, ties, and 1e9-level entries (invalid columns)."""
    rng = np.random.default_rng(seed)
    d = np.arange(D, dtype=np.float32)
    best = rng.uniform(0, D - 1, (B, H, W, 1))
    S = 40.0 * (d - best) ** 2 + rng.uniform(0, 30, (B, H, W, D))
    if integer:
        S = np.round(S)
    S[:, :, :5, :4] = 1.0e9             # x < d: invalid pairings
    S[0, 0, 0, :] = 1.0e9               # a pixel with no candidate
    S[1, 2, 3, :] = 7.0                 # a pixel of ties
    return S.astype(np.float32)


@pytest.mark.parametrize("ur,subpixel,integer,min_d", [
    (0.0, True, False, 0), (10.0, True, False, 2), (15.0, False, True, 0),
    (15.0, True, True, 4), (10.0, False, False, 0)])
def test_wta_disparity(ur, subpixel, integer, min_d):
    S = _volume(int(ur) + integer, integer=integer)
    d, v = wta.wta_disparity(torch.from_numpy(S), min_d, uniqueness_ratio=ur,
                             subpixel=subpixel)
    dr, vr = rw.wta_disparity(jnp.asarray(S), min_d, uniqueness_ratio=ur,
                              subpixel=subpixel)
    _eq(d, dr)
    _eq(v, vr)
    assert 0.05 < v.float().mean() < 1.0


def test_wta_integer_volume():
    """An int32 S (the int16 mode's sum): invalid at >= 9999."""
    S = np.minimum(_volume(5, integer=True), 12000).astype(np.int32)
    d, v = wta.wta_disparity(torch.from_numpy(S), 0, uniqueness_ratio=10.0)
    dr, vr = rw.wta_disparity(jnp.asarray(S), 0, uniqueness_ratio=10.0)
    _eq(d, dr)
    _eq(v, vr)


@pytest.mark.parametrize("min_d,max_diff", [(0, 1.0), (3, 1.5), (0, 0.0)])
def test_lr_consistency(min_d, max_diff):
    S = _volume(9)
    St = torch.from_numpy(S)
    _eq(lr_check.right_cost_volume(St, min_d),
        rl.right_cost_volume(jnp.asarray(S), min_d))
    d, v = wta.wta_disparity(St, min_d, uniqueness_ratio=0.0)
    d2, ok = lr_check.lr_consistency(d, v, St, min_d, max_diff)
    dr2, okr = rl.lr_consistency(jnp.asarray(d.numpy()),
                                 jnp.asarray(v.numpy()), jnp.asarray(S),
                                 min_d, max_diff)
    _eq(d2, dr2)
    _eq(ok, okr)
    assert 0 < ok.sum() < v.sum()
