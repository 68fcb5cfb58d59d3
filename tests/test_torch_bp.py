"""Torch port: belief propagation (``matchers/bp.py``, ``Algorithm.BP_GPU``
and ``CSBP_GPU``) against the JAX package on the same seeded inputs.

The reference's BP is XLA (no Pallas), so it runs as it is. Measured on
the CPU (and asserted below):

- the distance transform, the pools and the upsamplings are bit-equal;
- the twins' message updates are bit-equal to ``_bp_iterate`` at D = 16
  and 17 and to ``_bp_iterate_planes`` at K = 4; at D = 128 the
  reference's mean is XLA's reduction (neither a sequential sum nor a
  pairwise one), and the twin's sequential sum leaves 2.7e-6 on messages
  after 2 iterations (held at 1e-5);
- the reference's mean is XLA's reduction, whose order also depends on
  the shape: at 48x64 the whole matchers' beliefs differ from the twins'
  by up to 5.2e-6 (ulps of values ~5), so the whole matchers are held
  off the near ties: masks equal and disparities within ``DISP_ATOL``
  (measured 7.2e-7, on 10 of 3072 pixels; the rest bit-equal) wherever
  the reference's two best beliefs (for CSBP: planes) lie more than
  ``MARGIN`` apart, and, after CSBP's speckle filter, off those pixels'
  4-neighbours too. Through ``compute_disparity`` that leaves out 0
  pixels of BP, 152 of BP at ``min_disparity=3`` (its left columns,
  where every tap is invalid and every belief is BIG) and 0 of CSBP;
  the jitted facade's backward BP match has one near tie, whose
  disparity jumps 5 px. CSBP's coarsest beliefs tie within the K + 1
  best at 78-79 of 192 pixels, so the plane order is the tie rule's;
  both scenes agree exactly there.

The kernels (``bp_messages``, ``bp_planes``) are held bit-equal to these
twins on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from i3dr_stereo_tpu.config.params import (
    ALGORITHM_DEFAULTS,
    Algorithm,
    PointCloudConfig,
)
from i3dr_stereo_tpu.core.camera import StereoRig
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu.matchers import bp as jbp
from i3dr_stereo_tpu_torch.config import params
from i3dr_stereo_tpu_torch.convert import config_from_reference, rig_from_reference
from i3dr_stereo_tpu_torch.matchers import base, bp, registry
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

torch.set_num_threads(2)

MSG_ATOL = 1e-5     # messages, twin vs reference (measured <= 2.7e-6)
MARGIN = 1e-4       # beliefs this close may order otherwise (ulps of ~10)
DISP_ATOL = 1e-5    # subpixel disparities off the near ties (measured 7.2e-7)
CLOUD = dict(depth_max=100.0, depth_min=0.5)


def _dmajor(x):
    """(..., H, W, D) numpy -> (..., D, H, W) torch, contiguous."""
    return torch.from_numpy(np.moveaxis(x, -1, -3).copy())


def _dlast(t):
    return np.moveaxis(t.numpy(), -3, -1)


# ---------------------------------------------------------------------------
# the helpers and the twins of the two kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4, 16, 17])
def test_distance_transform_bit_equal(D):
    rng = np.random.default_rng(D)
    h = rng.normal(0, 3, (2, 5, 7, D)).astype(np.float32)
    h[0, 0, 0, 0] = bp.BIG
    h[1, 2, 3, :] = bp.BIG
    want = np.asarray(jbp._distance_transform_d(jnp.asarray(h), 1.0, 1.7))
    got = bp.distance_transform_d(torch.from_numpy(h), 1.0, 1.7, dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D,iters", [(16, 1), (16, 3), (17, 3), (128, 2)])
def test_bp_iterate_plain_matches_reference(D, iters):
    """Odd H and W; bit-equal at D = 16 and 17, within ``MSG_ATOL`` at
    D = 128 (the reference's mean reduces in XLA's order)."""
    rng = np.random.default_rng(D + iters)
    data = rng.uniform(0, 0.7, (1, 23, 37, D)).astype(np.float32)
    m0 = rng.normal(0, 0.3, (4, 1, 23, 37, D)).astype(np.float32)
    want = np.asarray(jbp._bp_iterate(jnp.asarray(data), jnp.asarray(m0),
                                      iters, 1.0, 1.7))
    got = _dlast(bp.bp_iterate_plain(_dmajor(data), _dmajor(m0), iters, 1.0,
                                     1.7))
    if D <= 17:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=MSG_ATOL)


@pytest.mark.parametrize("iters", [1, 3])
def test_bp_iterate_planes_plain_matches_reference(iters):
    rng = np.random.default_rng(iters)
    shape = (1, 23, 37, 4)
    data = rng.uniform(0, 0.7, shape).astype(np.float32)
    dv = rng.integers(0, 30, shape).astype(np.float32)
    m0 = rng.normal(0, 0.3, (4,) + shape).astype(np.float32)
    want = np.asarray(jbp._bp_iterate_planes(
        jnp.asarray(data), jnp.asarray(dv), jnp.asarray(m0), iters, 1.0, 1.7))
    got = _dlast(bp.bp_iterate_planes_plain(_dmajor(data), _dmajor(dv),
                                            _dmajor(m0), iters, 1.0, 1.7))
    np.testing.assert_array_equal(got, want)


def test_pools_and_upsamplings_bit_equal():
    rng = np.random.default_rng(0)
    vol = (rng.normal(0, 1, (1, 9, 11, 5)) * 1e3).astype(np.float32)
    np.testing.assert_array_equal(
        _dlast(bp._pool2(_dmajor(vol))), np.asarray(jbp._pool2(vol)))
    img = rng.uniform(0, 255, (2, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(bp._downsample2(torch.from_numpy(img)),
                                  np.asarray(jbp._pool2_img(img)))
    for n in (5, 8):
        x = rng.normal(0, 1, (1, n, n + 1, 3)).astype(np.float32)
        for H, W in ((2 * n, 2 * n + 2), (2 * n + 1, 2 * n + 3)):
            np.testing.assert_array_equal(
                _dlast(bp._up2(_dmajor(x), H, W)),
                np.asarray(jbp._up2(jnp.asarray(x), H, W)))
            np.testing.assert_array_equal(
                _dlast(bp._upsample_msgs(_dmajor(x[None]), H, W)),
                np.asarray(jbp._upsample_msgs(jnp.asarray(x[None]), H, W)))


def test_planes_kernel_takes_at_most_16_planes():
    """A CPU tensor runs the twin; the planes kernel's register budget is
    checked before any CUDA call."""
    data = torch.zeros(1, 17, 3, 4)
    msgs = torch.zeros(4, 1, 17, 3, 4)
    assert torch.equal(bp.bp_iterate(data, msgs, 2, 1.0, 1.7),
                       bp.bp_iterate_plain(data, msgs, 2, 1.0, 1.7))
    meta = torch.zeros(1, 17, 3, 4, device="meta")
    with pytest.raises(ValueError, match="at most 16 planes"):
        bp.bp_iterate_planes(meta, meta, torch.zeros(4, 1, 17, 3, 4,
                                                     device="meta"),
                             1, 1.0, 1.7)


# the largest D whose 32-pixel strip block fits a block's shared memory
STRIP_MAX_D = 446


def _strip_bytes(D):
    """A 32-pixel strip block's shared memory in ``bp_messages``: each
    pixel's four forward scans of D floats and a ring of 2 AHEAD data
    costs."""
    return 4 * (4 * D + 2 * bp.MESSAGES_AHEAD) * 32


@pytest.mark.parametrize("strip,first,last", [(32, 1, STRIP_MAX_D),
                                               (0, STRIP_MAX_D + 1, 2048)])
def test_messages_plan_picks_the_instance_from_d(strip, first, last):
    """``bp_messages``'s kernel for every D from 1 to 2048, the two cases
    together: the 32-pixel strip kernel with its block's bytes while they
    fit a block's shared memory, then (0) the scans staged in device
    memory; the cut where the wrapper's docstring puts it."""
    assert bp.MESSAGES_STRIP == 32 and bp.SHARED_MAX == 232448
    for D in range(first, last + 1):
        shared = bp.messages_shared(D)
        assert shared == (_strip_bytes(D) if strip else 0), D
        assert shared <= bp.SHARED_MAX
    assert _strip_bytes(STRIP_MAX_D) <= bp.SHARED_MAX < _strip_bytes(
        STRIP_MAX_D + 1)
    assert f"D <= {STRIP_MAX_D}" in " ".join(
        bp.messages_shared.__doc__.split())


@pytest.mark.parametrize("D", [1, 128, 446, 447, 900, 901, 2048])
def test_bp_iterate_passes_the_planned_strip(monkeypatch, D):
    """The wrapper hands the C entry the shared memory
    :func:`messages_shared` gives for D (0 past the cut: the staged
    kernel), one launch an iteration (meta tensors stand for the card's)."""
    calls = []
    monkeypatch.setattr(bp._build, "require_cuda", lambda *t: None)
    monkeypatch.setattr(bp._build, "stream_of", lambda t: 7)
    monkeypatch.setattr(bp._build, "launch",
                        lambda entry, kernel, dev, *a: calls.append(
                            (entry, kernel) + a))
    data = torch.empty((1, D, 2, 3), device="meta")
    msgs = torch.empty((4, 1, D, 2, 3), device="meta")
    out = bp.bp_iterate(data, msgs, 3, 1.0, 1.7)
    assert out.shape == msgs.shape and len(calls) == 3
    shared = _strip_bytes(D) if D <= STRIP_MAX_D else 0
    for c in calls:
        assert c[:2] == ("i3dr_bp_messages", "bp_messages")
        assert c[-2:] == (shared, 7)
        assert c[5:9] == (1, D, 2, 3)
        assert c[11] == np.float32(1) / np.float32(D)


# ---------------------------------------------------------------------------
# the whole matchers
# ---------------------------------------------------------------------------

def _scene(shape, seed=5, max_disp=14):
    """Integer grey levels, so that the pipeline's uint8 frames are the
    same images."""
    sc = layered_scene(*shape, max_disp=max_disp, seed=seed)
    return tuple(np.clip(x, 0, 255).astype(np.uint8).astype(np.float32)
                 for x in (sc.left, sc.right))


def _ties_scene():
    """A textured right part beside a flat left band: on the band every
    valid disparity costs the same, so the coarsest beliefs tie and the
    planes' order is the tie rule's."""
    l, r = _scene(SHAPE, seed=7)
    l[:, :28] = 100.0
    r[:, :28] = 100.0
    return l, r


def _cfg(alg, **kw):
    return ALGORITHM_DEFAULTS[alg].replace(**{"disparity_range": 16, **kw})


# 48x64: BP's cost pyramid stops at 4 levels of its default 5 (below 8 px)
# and CSBP's image pyramid at 3 of its default 4 (below 16 px)
SHAPE = (48, 64)
CASES = {
    "bp": (_cfg(Algorithm.BP_GPU), _scene(SHAPE)),
    "bp_min_disparity": (_cfg(Algorithm.BP_GPU, min_disparity=3),
                         _scene(SHAPE)),
    # speckle 100 / 4.0 (the defaults); min_disparity is ignored by CSBP
    "csbp_speckle": (_cfg(Algorithm.CSBP_GPU, min_disparity=2),
                     _scene(SHAPE)),
    # K = 3, speckle 20 at max(0.5, 1.0)
    "csbp_ties": (_cfg(Algorithm.CSBP_GPU, csbp_planes=3, speckle_size=20,
                       speckle_range=0.5), _ties_scene()),
}


def _belief_recorders(mp, rec):
    """Record the reference's final beliefs: BP's as it reaches the WTA,
    CSBP's from the last planes update (and its coarsest dense belief)."""
    wta, it, itp = jbp.wta_disparity, jbp._bp_iterate, jbp._bp_iterate_planes

    def belief(data, msgs):
        inc = [jbp._shift2d(msgs[i], dy, dx)
               for i, (dy, dx) in enumerate(jbp._DIRS)]
        return np.asarray(data + sum(inc))

    def rec_wta(S, *a, **kw):
        rec["belief"] = np.asarray(S)
        return wta(S, *a, **kw)

    def rec_it(data, msgs, *a):
        out = it(data, msgs, *a)
        rec["coarsest"] = belief(data, out)
        return out

    def rec_itp(data, dvals, msgs, *a):
        out = itp(data, dvals, msgs, *a)
        rec["belief"] = belief(data, out)
        return out

    mp.setattr(jbp, "wta_disparity", rec_wta)
    mp.setattr(jbp, "_bp_iterate", rec_it)
    mp.setattr(jbp, "_bp_iterate_planes", rec_itp)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's results (eager), each with its near-tie mask."""
    from i3dr_stereo_tpu.matchers.registry import compute_disparity

    out = {}
    for name, (cfg, (l, r)) in CASES.items():
        rec = {}
        with pytest.MonkeyPatch.context() as mp:
            _belief_recorders(mp, rec)
            res = compute_disparity(l, r, cfg)
        b = np.sort(rec["belief"], axis=-1)[0]
        near = (b[..., 1] - b[..., 0]) <= MARGIN
        coarse = np.sort(rec["coarsest"], axis=-1)[0]
        K = max(2, min(cfg.csbp_planes, cfg.disparity_range))
        ties = int((np.diff(coarse[..., :K + 1], axis=-1) == 0).any(-1).sum())
        out[name] = dict(d=np.asarray(res.disparity), v=np.asarray(res.valid),
                         near=near, ties=ties)
    return out


def _assert_matches(d, v, ref, speckle):
    """Equal masks and disparities within ``DISP_ATOL`` (the subpixel
    parabola over beliefs ulps apart) off the reference's near ties (and,
    where the speckle filter ran, off their 4-neighbours too)."""
    off = ref["near"].copy()
    if speckle:
        n = ref["near"]
        off[1:] |= n[:-1]
        off[:-1] |= n[1:]
        off[:, 1:] |= n[:, :-1]
        off[:, :-1] |= n[:, 1:]
    np.testing.assert_array_equal(v[~off], ref["v"][~off])
    np.testing.assert_allclose(d[~off & v], ref["d"][~off & v], rtol=0,
                               atol=DISP_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_matcher_matches_reference(name, reference):
    cfg, (l, r) = CASES[name]
    ref = reference[name]
    res = registry.compute_disparity(torch.from_numpy(l), torch.from_numpy(r),
                                     config_from_reference(cfg))
    v = res.valid.numpy()
    assert 0.5 < v.mean() <= 1.0
    _assert_matches(res.disparity.numpy(), v, ref,
                    cfg.algorithm == Algorithm.CSBP_GPU
                    and cfg.speckle_size > 0)
    if name == "csbp_ties":
        # the flat band ties the coarsest beliefs within the K + 1 best
        assert ref["ties"] > 20


def test_csbp_needs_two_levels():
    """With one pyramid level (``bp_levels=1``, or an image under 16 px)
    the reference adds the coarsest level's dense data to the K planes'
    messages and fails; the port refuses it by name."""
    from i3dr_stereo_tpu.matchers.registry import compute_disparity

    x = np.random.default_rng(0).uniform(0, 255, (16, 24)).astype(np.float32)
    cfg = _cfg(Algorithm.CSBP_GPU, bp_levels=1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        compute_disparity(x, x, cfg)
    with pytest.raises(ValueError, match="at least two pyramid levels"):
        registry.compute_disparity(x, x, config_from_reference(cfg))


def test_bp_runs_no_speckle_filter(monkeypatch):
    """The reference's speckle gate on the BP path is dead
    (``constant_space and ...``): BP's mask is the WTA's alone, whatever
    the speckle settings; CSBP's goes through the filter."""
    from i3dr_stereo_tpu_torch.ops import speckle

    calls = []
    real = speckle.speckle_filter

    def rec(*a, **kw):
        calls.append(kw["max_diff"])
        return real(*a, **kw)

    monkeypatch.setattr(bp, "speckle_filter", rec)
    cfg, (l, r) = CASES["bp"]
    a = registry.compute_disparity(
        l, r, config_from_reference(cfg.replace(speckle_size=1000)))
    b = registry.compute_disparity(
        l, r, config_from_reference(cfg.replace(speckle_size=0)))
    assert calls == []
    assert torch.equal(a.valid, b.valid)
    assert torch.equal(a.disparity, b.disparity)
    cfg = CASES["csbp_ties"][0]
    registry.compute_disparity(l, r, config_from_reference(cfg))
    assert calls == [1.0]


@pytest.fixture(scope="module")
def facade_reference():
    """The JAX facade (jitted) and pipeline on the BP and CSBP cases."""
    from i3dr_stereo_tpu.matchers.base import create_matcher
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline as Ref

    out = {}
    for name in ("bp", "csbp_speckle"):
        cfg, (l, r) = CASES[name]
        m = create_matcher(cfg)
        raw = [np.clip(x, 0, 255).astype(np.uint8) for x in (l, r)]
        pipe = Ref(StereoRig.synthetic(SHAPE[1], SHAPE[0]), cfg,
                   PointCloudConfig(**CLOUD),
                   rectify_inputs=False)
        p = pipe.process(*raw)
        out[name] = {"fwd": m.match(l, r), "bwd": m.backward_match(l, r),
                     "pipe": p,
                     "raw": raw}
    return out


def _near(belief):
    """Pixels whose two best beliefs (or planes) lie within ``MARGIN``;
    belief (1, H, W, D)."""
    b = np.sort(belief, axis=-1)[0]
    return (b[..., 1] - b[..., 0]) <= MARGIN


def _port_belief_recorder(mp, rec):
    """Record the port's final belief (the jitted reference's is out of
    reach): it is within ulps of the reference's, so its near ties are the
    reference's up to pixels within ulps of ``MARGIN``."""
    wta, itp = bp.wta_disparity, bp.bp_iterate_planes

    def rec_wta(S, *a, **kw):
        rec["belief"] = S.numpy().copy()
        return wta(S, *a, **kw)

    def rec_itp(data, dvals, msgs, *a, **kw):
        out = itp(data, dvals, msgs, *a, **kw)
        rec["belief"] = np.moveaxis(
            (data + sum(bp._incoming(out))).numpy(), 1, -1)
        return out

    mp.setattr(bp, "wta_disparity", rec_wta)
    mp.setattr(bp, "bp_iterate_planes", rec_itp)


@pytest.mark.parametrize("name", ["bp", "csbp_speckle"])
def test_facade_and_pipeline_match_reference(name, facade_reference):
    """``create_matcher().match`` / ``backward_match`` and
    ``StereoPipeline`` (uint8 frames, no rectification) against the
    jitted reference facade and pipeline. XLA fuses the jitted reference
    otherwise than the eager one, so near ties are read off the port's own
    beliefs; the backward match at 48x64 has one (a 5 px jump there)."""
    cfg, (l, r) = CASES[name]
    ref = facade_reference[name]
    speckle = name.startswith("csbp")
    m = base.create_matcher(config_from_reference(cfg), device="cpu")
    pipe = StereoPipeline(
        rig_from_reference(StereoRig.synthetic(SHAPE[1], SHAPE[0])),
        config_from_reference(cfg), params.PointCloudConfig(**CLOUD),
        device="cpu", rectify_inputs=False)
    runs = ((lambda: m.match(l, r), ref["fwd"], False),
            (lambda: m.backward_match(l, r), ref["bwd"], True),
            (lambda: pipe.process(*ref["raw"]), ref["pipe"], False))
    for run, want, mirrored in runs:
        rec = {}
        with pytest.MonkeyPatch.context() as mp:
            _port_belief_recorder(mp, rec)
            got = run()
        near = _near(rec["belief"])
        _assert_matches(got.disparity.numpy(), got.valid.numpy(),
                        dict(d=np.asarray(want.disparity),
                             v=np.asarray(want.valid),
                             near=near[:, ::-1] if mirrored else near),
                        speckle)
