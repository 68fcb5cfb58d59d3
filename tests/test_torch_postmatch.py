"""Torch port: the post-match stages (occlusion detection and fill, the
half-pel pass, the Gauss and WLS hole fillers) against the JAX package on
the same inputs, alone and inside the matchers: the pyramid on both
branches (``I3DR_SGM_BACKEND=pallas_t_interpret`` for the default branch,
``pallas_interpret`` for ``lean=True``) and the dense matchers' WLS fill.

Where the two packages round differently the test says so and by how
much (measured on the CPU, the maximum over these inputs in brackets):

- XLA's CPU backend contracts multiply-adds into FMAs: the half-pel
  sample ``r0 * (1 - frac) + r1 * frac`` [3.4e-5 px] and the Thomas
  solver's three multiply-subtracts, whose error the system at lam ~5000
  amplifies [1.2e-3 on one solve, 2.2e-4 px through ``wls_filter``]. The
  port, like its kernel on the card, keeps products and sums apart.
- ``exp`` is XLA's own on one side and torch's on the other: an ulp of
  the Gauss weights [2.9e-6 px on the filled values] and of the WLS edge
  weights [6e-8].
- XLA rewrites a division by a constant inside ``jit`` into a product
  with the float32 reciprocal; the port does the same everywhere
  (``wls.div_const``), so that is exact, but it then contracts the LR
  confidence's ``2 - err * (1 / t)`` into an FMA [6e-8].
Masks, occlusion maps and everything without those ops are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu.config.profile import PyramidLevelConfig, SGMProfile
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu.ops import gauss_interp as ref_gauss
from i3dr_stereo_tpu.ops import occlusion as ref_occ
from i3dr_stereo_tpu.ops import subpix as ref_subpix
from i3dr_stereo_tpu.ops import wls as ref_wls
from i3dr_stereo_tpu_torch.convert import (config_from_reference,
                                           profile_from_reference)
from i3dr_stereo_tpu_torch.matchers import pyramid, registry
from i3dr_stereo_tpu_torch.ops import gauss_interp, occlusion, subpix, wls

torch.set_num_threads(2)

TOL_HALFPEL = 1e-4    # XLA's FMA in the linear sample [3.4e-5]
TOL_GAUSS = 1e-5      # an ulp of exp in the weights [2.9e-6]
TOL_THOMAS = 5e-3     # XLA's FMAs in the solver at lam = 5000 [1.2e-3]
TOL_WLS = 1e-3        # the same through wls_filter [2.2e-4]
TOL_EDGE = 1e-6       # an ulp of exp [6e-8]
TOL_CONF = 1e-6       # XLA's FMA in the LR confidence ramp [6e-8]
TOL_PYRAMID = 1e-3    # the half-pel and Gauss differences above, and the
                      # WLS fill's where the pyramid fills with it


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _scene_disp(seed, H=48, W=64, holes=0.3, noise=0.4):
    """A layered scene, its disparities with noise, and a valid mask with
    random holes and a block of holes."""
    sc = layered_scene(H, W, max_disp=16, seed=seed, fractional=True)
    rng = np.random.default_rng(seed)
    d = (sc.disparity + rng.normal(0, noise, sc.disparity.shape))[None]
    v = rng.random(d.shape) > holes
    v[:, H // 3:H // 2, W // 4:W // 2] = False
    return sc, d.astype(np.float32), v


# ---------------------------------------------------------------------------
# occlusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_and_fill_occlusions_exact(seed):
    sc, d, v = _scene_disp(seed, holes=0.2)
    # rows with no valid pixel on one side of an occlusion, and one with
    # none at all: the NaN sides of the fill
    v[:, 5, :20] = False
    v[:, 7, 30:] = False
    v[:, 9, :] = False
    occ = ref_occ.detect_occlusions(jnp.asarray(d), jnp.asarray(v))
    got = occlusion.detect_occlusions(_t(d), _t(v))
    np.testing.assert_array_equal(got.numpy(), _np(occ))
    assert got.any()
    for step in (0.5, 3.0):
        np.testing.assert_array_equal(
            occlusion.detect_occlusions(_t(d), _t(v), step).numpy(),
            _np(ref_occ.detect_occlusions(jnp.asarray(d), jnp.asarray(v),
                                          step)))
    # fill with the reference's occlusion map, and with maps that leave a
    # side (or both) without support
    maps = [_np(occ), _np(occ).copy()]
    maps[1][:, 5, 20:24] = v[:, 5, 20:24]
    maps[1][:, 7, 26:30] = v[:, 7, 26:30]
    maps[1][:, 11, :] = v[:, 11, :]
    for m in maps:
        want_d, want_v = ref_occ.fill_occlusions(jnp.asarray(d),
                                                 jnp.asarray(v),
                                                 jnp.asarray(m))
        got_d, got_v = occlusion.fill_occlusions(_t(d), _t(v), _t(m))
        np.testing.assert_array_equal(got_d.numpy(), _np(want_d))
        np.testing.assert_array_equal(got_v.numpy(), _np(want_v))


# ---------------------------------------------------------------------------
# half-pel refinement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(steps=7, step_size=0.25,
                                             window=5),
                                dict(window=1)])
def test_halfpel_refine_matches_reference(kw):
    sc, d, v = _scene_disp(3, noise=0.7, holes=0.1)
    l, r = sc.left[None], sc.right[None]
    want = _np(ref_subpix.halfpel_refine(*map(jnp.asarray, (l, r, d, v)),
                                         **kw))
    got = subpix.halfpel_refine(*map(_t, (l, r, d, v)), **kw).numpy()
    np.testing.assert_array_equal(got[~v], d[~v])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_HALFPEL)


def test_halfpel_box_sum_order_is_reduce_window():
    """The 3x3 box adds in ``lax.reduce_window``'s order on the CPU (rows
    top to bottom, columns left to right), bit for bit."""
    import jax

    rng = np.random.default_rng(4)
    c = rng.uniform(0, 100, (1, 20, 30, 5)).astype(np.float32)
    want = jax.lax.reduce_window(
        jnp.pad(jnp.asarray(c), ((0, 0), (1, 1), (1, 1), (0, 0)),
                mode="edge"), 0.0, jax.lax.add, (1, 3, 3, 1), (1, 1, 1, 1),
        "VALID")
    np.testing.assert_array_equal(subpix._box_sum(_t(c), 3).numpy(),
                                  _np(want))


# ---------------------------------------------------------------------------
# Gauss hole filling
# ---------------------------------------------------------------------------

GAUSS_CASES = {
    "default": dict(),
    "16_directions_radius_16_min_elements_5": dict(
        n_directions=16, max_radius=16, min_elements=5),
    # sigma 0.05: every hit is at least 1 px away, where exp(-200) is 0 in
    # float32 (far below the denormals, which XLA's CPU exp flushes and
    # torch's keeps): the guard keeps every hole invalid
    "weight_underflow": dict(n_directions=8, max_radius=8, sigma=0.05),
}


@pytest.mark.parametrize("name", list(GAUSS_CASES))
def test_gauss_interpolate_matches_reference(name):
    kw = GAUSS_CASES[name]
    _, d, v = _scene_disp(5, holes=0.5)
    wd, wv = ref_gauss.gauss_interpolate(jnp.asarray(d), jnp.asarray(v),
                                         **kw)
    gd, gv = gauss_interp.gauss_interpolate(_t(d), _t(v), **kw)
    np.testing.assert_array_equal(gv.numpy(), _np(wv))
    np.testing.assert_allclose(gd.numpy(), _np(wd), rtol=0, atol=TOL_GAUSS)
    np.testing.assert_array_equal(gd.numpy()[v], d[v])
    if name == "weight_underflow":
        np.testing.assert_array_equal(gv.numpy(), v)
    else:
        assert gv.numpy().mean() > v.mean()
    # (H, W) in, (H, W) out, the same values
    gd2, gv2 = gauss_interp.gauss_interpolate(_t(d[0]), _t(v[0]), **kw)
    assert torch.equal(gd2, gd[0]) and torch.equal(gv2, gv[0])


@pytest.mark.parametrize("max_radius", [2, 16, 32, 65, 200])
def test_gauss_kernel_takes_six_rounds_alone(max_radius):
    """The kernel is built for the radius every caller passes (64: 6
    doubling rounds, 32 < max_radius <= 64); another radius raises before
    any launch, on any device, while the twin takes it
    (test_gauss_interpolate_matches_reference)."""
    d = torch.zeros((1, 4, 4), device="meta")
    v = torch.zeros((1, 4, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="6 doubling rounds"):
        gauss_interp._gauss_kernel(d, v, 32, max_radius, 16.0, 0)


def test_gauss_ray_offsets_match_reference_rounds():
    """The doubling's offsets: Python's round (half to even) of the unit
    ray times 2^r, as the reference computes them."""
    import math

    for n, radius in ((32, 64), (16, 16), (8, 5)):
        offs = gauss_interp.ray_offsets(n, radius)
        rounds = max(1, math.ceil(math.log2(max(radius, 2))))
        assert len(offs) == n and all(len(o) == rounds for o in offs)
        for k, o in enumerate(offs):
            ang = 2.0 * math.pi * k / n
            assert o == [(int(round(math.sin(ang) * 2.0 ** r)),
                          int(round(math.cos(ang) * 2.0 ** r)))
                         for r in range(rounds)]


# ---------------------------------------------------------------------------
# WLS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vertical", [False, True])
def test_thomas_lines_matches_reference(vertical):
    rng = np.random.default_rng(6)
    B, H, W = 2, 12, 40
    a = (rng.random((B, H, W)) > 0.3).astype(np.float32)
    d = rng.uniform(0, 30, (B, H, W)).astype(np.float32)
    w = rng.random((B, H - 1, W) if vertical
                   else (B, H, W - 1)).astype(np.float32)
    for lam in (5000.0 * 16 / 63 * 1.5, 3.0):
        if vertical:
            want = np.swapaxes(_np(ref_wls._thomas_rows(
                *(jnp.swapaxes(jnp.asarray(x), -1, -2) for x in (a, w, d)),
                lam)), -1, -2)
        else:
            want = _np(ref_wls._thomas_rows(jnp.asarray(a), jnp.asarray(w),
                                            jnp.asarray(d), lam))
        got = wls.thomas_lines(_t(a), _t(w), _t(d), lam, vertical=vertical)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL_THOMAS)
        # the twin on the planes as they are equals the CPU path
        assert torch.equal(got, wls.thomas_lines(_t(a), _t(w), _t(d), lam,
                                                 vertical=vertical,
                                                 plain=True))


def test_edge_weights_and_div_const_match_reference():
    import jax

    sc = layered_scene(48, 64, seed=2)
    g = sc.left[None].astype(np.float32)
    # inside jit, as in wls_filter: a division by a constant
    want_g = _np(jax.jit(lambda x: x / 255.0)(jnp.asarray(g)))
    got_g = wls.div_const(_t(g), 255.0)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    for axis in (-1, -2):
        np.testing.assert_allclose(
            wls._edge_weights(got_g, 0.15, axis).numpy(),
            _np(ref_wls._edge_weights(jnp.asarray(want_g), 0.15, axis)),
            rtol=0, atol=TOL_EDGE)


@pytest.mark.parametrize("batched", [True, False])
def test_wls_filter_and_fill_match_reference(batched):
    sc, d, v = _scene_disp(7, holes=0.35)
    g = sc.left[None].astype(np.float32)
    if not batched:
        d, v, g = d[0], v[0], g[0]
    want = _np(ref_wls.wls_filter(jnp.asarray(d),
                                  jnp.asarray(v.astype(np.float32)),
                                  jnp.asarray(g)))
    got = wls.wls_filter(_t(d), _t(v.astype(np.float32)), _t(g))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_WLS)
    wd, wv = ref_wls.wls_fill(jnp.asarray(d), jnp.asarray(v), jnp.asarray(g))
    gd, gv = wls.wls_fill(_t(d), _t(v), _t(g))
    np.testing.assert_array_equal(gv.numpy(), _np(wv))
    assert gv.all()
    np.testing.assert_array_equal(gd.numpy()[v], d[v])
    np.testing.assert_allclose(gd.numpy(), _np(wd), rtol=0, atol=TOL_WLS)


def test_lr_confidence_and_wls_fill_lr_match_reference():
    # seed 0: no zero pivot on either side (seeds 2 and 3 have one, below)
    sc, d, v = _scene_disp(0, holes=0.2)
    rng = np.random.default_rng(0)
    dr = (d + rng.normal(0, 1.2, d.shape)).astype(np.float32)
    vr = rng.random(d.shape) > 0.2
    g = sc.left[None].astype(np.float32)
    for thresh in (1.5, 0.7):
        want = _np(ref_wls.lr_confidence(*map(jnp.asarray, (d, v, dr, vr)),
                                         lrc_thresh=thresh))
        got = wls.lr_confidence(*map(_t, (d, v, dr, vr)), lrc_thresh=thresh)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_CONF)
        np.testing.assert_array_equal(got.numpy() == 0, want == 0)
        assert 0 < (want == 1).mean() < 1 and (want == 0).any()
    np.testing.assert_allclose(
        wls.lr_confidence(*map(_t, (d[0], v[0], dr[0], vr[0]))).numpy(),
        _np(ref_wls.lr_confidence(*map(jnp.asarray,
                                       (d[0], v[0], dr[0], vr[0])))),
        rtol=0, atol=TOL_CONF)
    wd, wv = ref_wls.wls_fill_lr(*map(jnp.asarray, (d, v, dr, vr, g)))
    gd, gv = wls.wls_fill_lr(*map(_t, (d, v, dr, vr, g)))
    np.testing.assert_array_equal(gv.numpy(), _np(wv))
    np.testing.assert_allclose(gd.numpy(), _np(wd), rtol=0, atol=TOL_WLS)
    assert np.isfinite(_np(wd)).all()


# ---------------------------------------------------------------------------
# a second witness for the pixels the WLS fills, where the reference is NaN
# ---------------------------------------------------------------------------

TOL_WITNESS = 2e-3    # float32 against float64 at lam ~3000 [6.4e-4]


def _thomas_f64(a, w, d, lam):
    """The 1-D WLS system along the last axis in float64, by Thomas's
    algorithm written here, not taken from either package: in float64 the
    diagonal's 1e-8 survives next to lam * w, so no pivot is 0."""
    N = d.shape[-1]
    z = np.zeros(d.shape[:-1] + (1,))
    wl = np.concatenate([z, w], -1)
    wr = np.concatenate([w, z], -1)
    diag = a + lam * (wl + wr) + 1e-8
    cp, dp = np.zeros(d.shape), np.zeros(d.shape)
    c = p = 0.0
    for i in range(N):
        den = diag[..., i] + lam * wl[..., i] * c
        c = -lam * wr[..., i] / den
        p = (a[..., i] * d[..., i] + lam * wl[..., i] * p) / den
        cp[..., i], dp[..., i] = c, p
    u, un = np.zeros(d.shape), 0.0
    for i in range(N - 1, -1, -1):
        un = dp[..., i] - cp[..., i] * un
        u[..., i] = un
    return u


def wls_witness(disp, conf, guide, lam=8000.0, sigma_color=1.5, iters=3):
    """The WLS filter of (..., H, W) arrays in float64 NumPy: the FGS
    passes of the module docstring of ``ops/wls.py`` (guide / 255,
    sigma / 10, the lambda schedule, data weights at least 0.1 after the
    first round)."""
    g = np.asarray(guide, np.float64) / 255.0
    a = np.asarray(conf, np.float64)
    u = np.where(a > 0, np.asarray(disp, np.float64), 0.0)
    sigma = sigma_color / 10.0
    wh = np.exp(-np.abs(np.diff(g, axis=-1)) / sigma)
    wv = np.exp(-np.abs(np.diff(g, axis=-2)) / sigma).swapaxes(-1, -2)
    for t in range(1, iters + 1):
        lam_t = 1.5 * lam * 4.0 ** (iters - t) / (4.0 ** iters - 1.0)
        u = _thomas_f64(a, wh, u, lam_t)
        u = _thomas_f64(a.swapaxes(-1, -2), wv, u.swapaxes(-1, -2),
                        lam_t).swapaxes(-1, -2)
        a = np.maximum(a, 0.1)
    return u


def wls_fill_witness(name, args):
    """What ``wls_fill`` / ``wls_fill_lr`` should return on ``args``, by
    :func:`wls_witness`; the LR confidence is the JAX package's."""
    if name == "wls_fill":
        d, v, g = args
        conf = keep = v
    else:
        d, v, dr, vr, g = args
        conf = _np(ref_wls.lr_confidence(*map(jnp.asarray, (d, v, dr, vr))))
        keep = conf >= 1.0
    return np.where(keep, d, wls_witness(d, conf, g))


def record_wls(mp, *modules):
    """Wrap each module's ``wls_fill`` / ``wls_fill_lr``: every call's
    inputs (as arrays) and name are appended to the returned list."""
    calls = []
    for m in modules:
        for name in ("wls_fill", "wls_fill_lr"):
            fn = getattr(m, name, None)
            if fn is None:
                continue

            def rec(*args, _fn=fn, _name=name, **kw):
                calls.append((_name, [x.detach().cpu().numpy()
                                      for x in args]))
                return _fn(*args, **kw)
            mp.setattr(m, name, rec)
    return calls


def check_wls_witness(d, calls, d_ref):
    """The matcher's result ``d`` is its one WLS call's output: it agrees
    with the float64 witness on every pixel, and the reference's NaN
    pixels (its zero-pivot fault) are among them."""
    assert len(calls) == 1
    want = wls_fill_witness(*calls[0]).reshape(d.shape)
    np.testing.assert_allclose(d, want, rtol=0, atol=TOL_WITNESS)
    return int(np.isnan(d_ref).sum())


@pytest.mark.parametrize("seed", [2, 3])
def test_wls_zero_pivot_is_repaired(seed):
    """A reference fault the port repairs: where a line's data weights are
    zero to its end, the first pass's last pivot (lam * w and a 1e-8 that
    float32 loses next to it, less the same product) is exactly 0 and the
    reference divides by it; the NaN then spreads over every filled pixel
    in the next pass. The port gives that pivot the 1e-8 the diagonal
    was meant to hold. Everywhere else the two agree as above; here the
    port's values are finite, stay within the data's range and agree with
    the float64 witness on every pixel, the filled ones included."""
    sc, d, v = _scene_disp(seed, holes=0.2)
    rng = np.random.default_rng(seed)
    dr = (d + rng.normal(0, 1.2, d.shape)).astype(np.float32)
    vr = rng.random(d.shape) > 0.2
    g = sc.left[None].astype(np.float32)
    wd, _ = ref_wls.wls_fill_lr(*map(jnp.asarray, (d, v, dr, vr, g)))
    gd, gv = wls.wls_fill_lr(*map(_t, (d, v, dr, vr, g)))
    wd, gd = _np(wd), gd.numpy()
    conf = wls.lr_confidence(*map(_t, (d, v, dr, vr))).numpy()
    assert np.isnan(wd[conf < 1]).all()          # the reference's fault
    np.testing.assert_array_equal(gd[conf >= 1], wd[conf >= 1])
    assert np.isfinite(gd).all() and gv.all()
    assert d.min() - 1 <= gd.min() and gd.max() <= d.max() + 1
    np.testing.assert_allclose(
        gd, wls_fill_witness("wls_fill_lr", (d, v, dr, vr, g)), rtol=0,
        atol=TOL_WITNESS)


# ---------------------------------------------------------------------------
# inside the matchers
# ---------------------------------------------------------------------------

PH, PW = 96, 128


def _postmatch_profile():
    """Two levels and a half-pel pass: occlusions filled at level 1 and
    dropped at level 0, the Gauss fill (at least 2 rays) at level 0,
    speckle on both."""
    return SGMProfile(name="postmatch", levels=(
        PyramidLevelConfig(level=1, prediction_shift=0.0, speckle=True,
                           speckle_max_region=20, occlusion_detection=True,
                           interpolate_occlusions=True),
        PyramidLevelConfig(level=0, speckle=True, speckle_max_region=20,
                           occlusion_detection=True,
                           interpolate_occlusions=False,
                           interp_min_elements=2),
        PyramidLevelConfig(level=0, subpix_pass=True, step_size=0.5),
    ))


def _wls_cfg():
    """The flat config with ``interp`` (the WLS fill at level 0) and
    occlusion detection dropping the occluded pixels."""
    return ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        max_pyramid_level=2, speckle_size=20, interp=True,
        occlusion_detection=True, occlusion_interp=False)


PYRAMID_CASES = {
    "profile_subpix_occlusion_gauss": (
        ALGORITHM_DEFAULTS[Algorithm.I3DRSGM], _postmatch_profile),
    "flat_interp_wls_occlusion_drop": (_wls_cfg(), None),
}


def _pyramid_scene():
    sc = layered_scene(PH, PW, max_disp=40, background_disp=6, layers=4,
                       seed=12)
    return sc.left, sc.right


def _pyramid_reference(backend):
    from i3dr_stereo_tpu.matchers.pyramid import pyramid_sgm_match

    l, r = _pyramid_scene()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", backend)
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        for name, (cfg, make) in PYRAMID_CASES.items():
            res = pyramid_sgm_match(l, r, cfg, make() if make else None)
            out[name] = (_np(res.disparity), _np(res.valid))
    return out


def _pyramid_port(name, lean):
    """The port's (disparity, valid) and the calls of its WLS fill."""
    cfg, make = PYRAMID_CASES[name]
    l, r = _pyramid_scene()
    with pytest.MonkeyPatch.context() as mp:
        calls = record_wls(mp, pyramid)
        res = pyramid.pyramid_sgm_match(
            _t(l), _t(r), config_from_reference(cfg),
            profile_from_reference(make()) if make else None, lean=lean)
    return res.disparity.numpy(), res.valid.numpy(), calls


@pytest.fixture(scope="module")
def pyramid_reference():
    return _pyramid_reference("pallas_t_interpret")


def _check_pyramid(name, d, v, calls, d_ref, v_ref):
    np.testing.assert_array_equal(v, v_ref)
    assert v.mean() > 0.9
    assert np.isfinite(d).all()
    # no line of these WLS passes is a hole from end to end, so the
    # reference has no zero pivot (test_wls_zero_pivot_is_repaired) and
    # every pixel, the filled ones included, is held against it, and
    # against the float64 witness of the fill as well
    assert np.isfinite(d_ref).all()
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=TOL_PYRAMID)
    if PYRAMID_CASES[name][0].interp:
        assert check_wls_witness(d, calls, d_ref) == 0
    else:
        assert not calls


@pytest.mark.parametrize("name", list(PYRAMID_CASES))
def test_pyramid_postmatch_matches_reference(name, pyramid_reference):
    _check_pyramid(name, *_pyramid_port(name, lean=False),
                   *pyramid_reference[name])


# ---------------------------------------------------------------------------
# the dense matchers' fill: interpolate_missing (plain WLS)
# ---------------------------------------------------------------------------

DENSE = {
    "bm": ALGORITHM_DEFAULTS[Algorithm.BM].replace(disparity_range=32,
                                                    speckle_size=20),
    "sgbm": ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
        disparity_range=32, window_size=5, p1=200.0, p2=400.0,
        speckle_size=20),
    "i3drsgm_dense": ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        pyramid=False, disparity_range=32, speckle_size=20),
}


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_interpolate_missing_matches_reference(name):
    from i3dr_stereo_tpu.matchers.registry import compute_disparity as ref

    cfg = DENSE[name].replace(interpolate_missing=True)
    sc = layered_scene(48, 64, max_disp=20, seed=9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        want = ref(sc.left, sc.right, cfg)
    with pytest.MonkeyPatch.context() as mp:
        calls = record_wls(mp, registry)
        got = registry.compute_disparity(_t(sc.left), _t(sc.right),
                                         config_from_reference(cfg))
    np.testing.assert_array_equal(got.valid.numpy(), _np(want.valid))
    assert got.valid.all()
    d, d_ref = got.disparity.numpy(), _np(want.disparity)
    # where the reference's WLS divides by a zero pivot it is NaN (see
    # test_wls_zero_pivot_is_repaired); the port is finite everywhere and
    # agrees with the float64 witness there too
    ok = np.isfinite(d_ref)
    assert np.isfinite(d).all() and ok.mean() > 0.5
    np.testing.assert_allclose(d[ok], d_ref[ok], rtol=0, atol=TOL_WLS)
    check_wls_witness(d, calls, d_ref)
