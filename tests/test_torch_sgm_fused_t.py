"""Torch port: census cost -> SGM -> WTA (the plain twins of the
census_cost / sgm_sweep / sgm_sweep_wta kernels) against the JAX flagship
kernels ``census_sgm_wta_t`` run in Pallas interpret mode, on the same
numpy inputs, and each sweep twin against the sum written the long way
(``sgm_path_plain`` volumes into ``sum_wta_plain``). The reference takes
transposed census words and returns C as (B, W, D, H); the port takes
(B, H, W, NW) words and returns (B, H, W, D) — hamming distances do not
depend on the bit order, so C must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.ops.census import census_transform as ref_census
from i3dr_stereo_tpu.ops.sgm_fused_t import (census_sgm_wta_t, fused_census_fwd_t,
                                             right_disparity_from_C_t)
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
    if bpm > 0:
        # columns x < bpm + d have no source: every path through them
        # passes the 10000 clamp, and at valid pixels beside them the
        # running sum of the first directions leaves int16 with 8 paths.
        # With uniqueness on, a wrapped or unclamped sum there would flip
        # the valid mask compared above
        _, _, parts, _, _, s_hd, _, _ = _long_way(C, None, pens, directions)
        at_valid = torch.from_numpy(v)[..., None]
        assert all(((p == sf.CLAMP) & at_valid).any() for p in parts)
        top = int((s_hd * at_valid).max())
        assert top == (30000 if directions == 4 else 50000)
        edge = v[:, :H_REAL, bpm:bpm + 3]
        assert edge.mean() > (0.2 if ur else 0.5)
        np.testing.assert_array_equal(d.numpy(), d_ref)


@pytest.mark.parametrize("bpm,W_real,H_real,B", [
    (5, W_REAL, H_REAL, 1),
    (-16, W_REAL, H_REAL, 2),
    (-30, 97, 64, 1),
    (20, 120, HP, 1),
])
def test_census_cost_matches_interpret(bpm, W_real, H_real, B):
    """The cost volume alone against the C of the reference's forward
    kernel, where a tiled kernel can go wrong: windows that leave the row
    on either side, and padding. A pad pixel is 0 even where its source
    column is out of range; a real pixel there is 255."""
    lp, rp = _pair(B, seed=50 + bpm)
    (cl_t, cr_t), (cl, cr) = _words(lp, rp)
    C_ref, _ = fused_census_fwd_t(cl_t, cr_t, D, 0.1, 0.8, bpm=bpm,
                                  W_real=W_real, H_real=H_real,
                                  interpret=True)
    C, Cw = sf.census_cost_plain(cl, cr, D, bpm=bpm, H_real=H_real,
                                 W_real=W_real)
    assert Cw is None
    C = C.numpy()
    np.testing.assert_array_equal(C, np.asarray(C_ref).transpose(0, 3, 1, 2))
    src = np.arange(WP)[:, None] - bpm - np.arange(D)[None, :]   # (x, d)
    outside = (src < 0) | (src >= W_real)
    real = C[:, :H_real, :W_real]
    assert (real[:, :, outside[:W_real]] == 255).all()
    assert (real[:, :, ~outside[:W_real]] < 255).all()
    assert outside[:W_real].any() and not outside[:W_real].all()
    if W_real < WP:
        # some pad pixels have no source column either
        assert outside[W_real:].any() or bpm == 20
        assert (C[:, :, W_real:] == 0).all()
    if H_real < HP:
        assert (C[:, H_real:] == 0).all()


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
    """The sweeps keep the reference's int16 stores: S_fwd = int(fwd),
    S_h = int(rev + float(S_fwd)) (one float32 add, then one truncation),
    S_h + int(down), and the last direction is added untruncated. Two
    pixels along x with P1 just below 1 give the fractional path cost
    that tells the four apart."""
    p1 = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    C = torch.tensor([[0, 5, 5, 5], [1, 0, 5, 5]],
                     dtype=torch.uint8).reshape(1, 1, 2, 4)
    # at x = 1 the (0, 1) path costs are (1, P1, 8, 8): d = 1 comes from
    # d = 0 at P1, d = 2 and 3 from the minimum at P2 = 3
    t = sf.sgm_path_plain(C, 0, 1, p1, 3.0)[0, 0, 1]
    np.testing.assert_array_equal(t.numpy(), np.float32([1, p1, 8, 8]))
    acc = sf.sgm_sweep(C, 0, 1, p1, 3.0, "i16_new")
    assert acc.dtype == torch.int16
    assert acc[0, 0, 1].tolist() == [1, 0, 8, 8]
    # float32(16384 + P1) rounds up to 16385: adding before truncating
    # differs from truncating before adding
    big = torch.full((1, 1, 2, 4), 16384, dtype=torch.int16)
    assert sf.sgm_sweep(C, 0, 1, p1, 3.0, "i16_addf",
                        big.clone())[0, 0, 1].tolist() == [
        16385, 16385, 16392, 16392]
    assert sf.sgm_sweep(C, 0, 1, p1, 3.0, "i16_addi",
                        big.clone())[0, 0, 1].tolist() == [
        16385, 16384, 16392, 16392]
    # the last direction is added in float32, not truncated: with sums
    # (1, 1, 9, 9) before it, S at x = 1 is (2, float32(1 + P1) = 2, 17,
    # 17), a tie that the first minimum d = 0 takes; cut to int first it
    # would be (2, 1, ...) and d = 1
    acc = torch.tensor([[0, 0, 9, 9], [1, 1, 9, 9]],
                       dtype=torch.int16).reshape(1, 1, 2, 4)
    d = sf.sgm_sweep_wta(C, 0, 1, p1, 3.0, acc, subpixel=False)
    assert d[0, 0, 1].item() == 0.0
    d32 = sf.sgm_sweep_wta(C, 0, 1, p1, 3.0, acc.float(), subpixel=False)
    assert torch.equal(d, d32)


def test_uniqueness_and_validity_rules():
    # one image row swept vertically: every pixel is a path of its own,
    # so its path costs are its costs C and the sums are set through acc
    C = torch.zeros((1, 1, 3, 32), dtype=torch.uint8)
    C[0, 0, 1] = 255                      # pixel 1: every pairing invalid
    S = torch.full((1, 1, 3, 32), 50.0)
    S[0, 0, 0, 10] = 10.0                 # pixel 0: clear winner
    S[0, 0, 2, 10], S[0, 0, 2, 20] = 10.0, 10.5   # pixel 2: ambiguous
    for acc in (S, (2 * S).to(torch.int16)):      # float32 and int16 sums
        d = sf.sgm_sweep_wta(C, -1, 0, 0.1, 0.8, acc, subpixel=True,
                             uniqueness_ratio=10.0)[0, 0]
        assert d[0].item() == 10.0
        assert d[1].item() == sf.NODATA   # cmin == 255
        assert d[2].item() == sf.NODATA   # 10.5 * 0.9 < 10
        d0 = sf.sgm_sweep_wta(C, -1, 0, 0.1, 0.8, acc, subpixel=True,
                              uniqueness_ratio=0.0)[0, 0]
        assert d0[2].item() == 10.0
        assert d0[1].item() == sf.NODATA
    with pytest.raises(ValueError, match="running sum"):
        sf.sgm_sweep_wta(C, -1, 0, 0.1, 0.8, S[..., :16], subpixel=True)
    with pytest.raises(ValueError, match="running sum"):
        sf.sgm_sweep_wta(C, -1, 0, 0.1, 0.8, S.to(torch.int32),
                         subpixel=True)


# ---------------------------------------------------------------------------
# each sweep twin against the sum written the long way
# ---------------------------------------------------------------------------

def _volume(seed, B=2, H=11, W=19, wide=False):
    """(C, Cw or None, pens for 8 directions): random costs with invalid
    pairings and three columns in which every pairing is invalid, so that
    every path there passes the 10000 clamp."""
    rng = np.random.default_rng(seed)
    ham = rng.integers(0, 300 if wide else 60, (B, H, W, D))
    bad = rng.random(ham.shape) < 0.05
    bad[:, :, 4:7] = True
    C = np.where(bad, 255, np.minimum(ham, 254)).astype(np.uint8)
    Cw = np.where(bad, -1, ham).astype(np.int16) if wide else None
    pens = [(round(float(rng.uniform(0.05, 1.0)), 3),
             round(float(rng.uniform(1.0, 9.0)), 3)) for _ in range(8)]
    return (torch.from_numpy(C), None if Cw is None else torch.from_numpy(Cw),
            pens)


def _long_way(C, Cw, pens, directions):
    """The per-direction volumes in the order fwd, rev, downs, ups, and
    the sums between them with the reference's truncation points."""
    dirs = sf.DIRECTIONS_4 if directions == 4 else sf.DIRECTIONS_8
    pen = dict(zip(dirs, pens))
    down = [d for d in sf._DOWN if d in dirs]
    up = [d for d in sf._UP if d in dirs]
    order = [(0, 1), (0, -1)] + down + up
    parts = [sf.sgm_path_plain(Cw if d == (0, 1) and Cw is not None else C,
                               *d, *pen[d]) for d in order]
    s_fwd = parts[0].to(torch.int32)
    s_h = (parts[1] + s_fwd.float()).to(torch.int32)
    dsum = parts[2]
    for k in range(1, len(down)):
        dsum = dsum + parts[2 + k]
    s_hd = s_h + dsum.to(torch.int32)
    return order, pen, parts, s_fwd, s_h, s_hd, len(down), len(up)


@pytest.mark.parametrize("directions,ur,subpixel,B,wide", [
    (4, 0.0, True, 1, False),
    (4, 10.0, False, 2, False),
    (4, 0.0, True, 1, True),
    (8, 0.0, True, 1, False),
    (8, 10.0, True, 2, False),
    (8, 0.0, False, 1, True),
])
def test_sweep_chain_equals_the_sum_written_the_long_way(
        directions, ur, subpixel, B, wide):
    """Every running sum of the chain, and its disparities, against
    sgm_path_plain volumes summed by sum_wta_plain: exact."""
    C, Cw, pens = _volume(directions + int(ur) + B, B=B, wide=wide)
    pens = pens[:directions]
    order, pen, parts, s_fwd, s_h, s_hd, n_down, n_up = _long_way(
        C, Cw, pens, directions)
    assert all((p == sf.CLAMP).any() for p in parts)   # the clamp is hit
    if wide:
        assert (Cw > 254).any() and not torch.equal(
            parts[0], sf.sgm_path_plain(C, 0, 1, *pen[(0, 1)]))
    ref = sf.sum_wta_plain(C, parts, n_down, n_up, subpixel=subpixel,
                           uniqueness_ratio=ur)

    acc = sf.sgm_sweep(C if Cw is None else Cw, 0, 1, *pen[(0, 1)], "i16_new")
    assert acc.dtype == torch.int16 and torch.equal(acc.int(), s_fwd)
    out = sf.sgm_sweep(C, 0, -1, *pen[(0, -1)], "i16_addf", acc)
    assert out is acc and torch.equal(acc.int(), s_h)     # in place
    if directions == 4:
        sf.sgm_sweep(C, 1, 0, *pen[(1, 0)], "i16_addi", acc)
        assert torch.equal(acc.int(), s_hd)
        assert int(s_hd.max()) == 30000                   # int16 holds it
    else:
        assert int(s_hd.max()) == 50000                   # int16 would not
        acc32 = sf.sgm_sweep(C, *order[2], *pen[order[2]], "f32_new")
        assert torch.equal(acc32, parts[2])
        sf.sgm_sweep(C, *order[3], *pen[order[3]], "f32_add", acc32=acc32)
        assert torch.equal(acc32, parts[2] + parts[3])
        out = sf.sgm_sweep(C, *order[4], *pen[order[4]], "f32_fin", acc,
                           acc32)
        assert out is acc32 and torch.equal(acc32, s_hd.float())
        assert torch.equal(acc.int(), s_h)                # only read
        for k in (5, 6):
            sf.sgm_sweep(C, *order[k], *pen[order[k]], "f32_add",
                         acc32=acc32)
        assert torch.equal(acc32, (s_hd.float() + parts[5]) + parts[6])
        acc = acc32
    before = acc.clone()
    d = sf.sgm_sweep_wta(C, *order[-1], *pen[order[-1]], acc,
                         subpixel=subpixel, uniqueness_ratio=ur)
    assert torch.equal(acc, before)                       # only read
    np.testing.assert_array_equal(d.numpy(), ref.numpy())
    v = d.numpy() > -1e8
    assert 0.2 < v.mean() < 1.0
    if subpixel:
        assert (d.numpy()[v] % 1 != 0).any()


@pytest.mark.parametrize("op", list(sf.SWEEP_OPS))
@pytest.mark.parametrize("direction", [(0, 1), (0, -1), (1, 0), (-1, 1)])
def test_sweep_op_formula(op, direction):
    """Each op of sgm_sweep on its own, any direction: what it does with
    t = min(L, 10000) and with the sums it is given."""
    C, _, pens = _volume(7)
    rng = np.random.default_rng(3)
    t = sf.sgm_path_plain(C, *direction, *pens[0])
    a16 = torch.from_numpy(rng.integers(0, 20001, C.shape).astype(np.int16))
    a32 = torch.from_numpy(
        (rng.integers(0, 80000, C.shape) / 4).astype(np.float32))
    want = {
        "i16_new": lambda: t.to(torch.int32),
        "i16_addf": lambda: (t + a16.float()).to(torch.int32),
        "i16_addi": lambda: a16.int() + t.to(torch.int32),
        "f32_new": lambda: t,
        "f32_add": lambda: a32 + t,
        "f32_fin": lambda: (a16.int() + (a32 + t).to(torch.int32)).float(),
    }[op]()
    g16 = a16.clone() if op in sf._READS_16 else None
    g32 = a32.clone() if op in sf._READS_32 else None
    out = sf.sgm_sweep(C, *direction, *pens[0], op, g16, g32)
    if op.startswith("i16"):
        assert out.dtype == torch.int16 and torch.equal(out.int(), want)
    else:
        assert out.dtype == torch.float32 and torch.equal(out, want)
    if op == "f32_fin":
        assert torch.equal(g16, a16)
    # a sum the op does not take, or lacks, is refused
    with pytest.raises(ValueError, match="running sum"):
        sf.sgm_sweep(C, *direction, *pens[0], op,
                     None if op in sf._READS_16 else a16.clone(), g32)
    with pytest.raises(ValueError, match="op must be"):
        sf.sgm_sweep(C, *direction, *pens[0], "sum")


@pytest.mark.parametrize("directions", [4, 8])
def test_census_sgm_wta_is_the_chain_of_twins(directions):
    """census_sgm_wta on CPU words equals its plain=True run and the sum
    written the long way on its own cost volume."""
    lp, rp = _pair(2, seed=11)
    _, (cl, cr) = _words(lp, rp)
    pens = ((0.1, 0.8),) * directions
    kw = dict(bpm=5, W_real=W_REAL, H_real=H_REAL, pens=pens,
              directions=directions, subpixel=True, uniqueness_ratio=10.0)
    d, C = sf.census_sgm_wta(cl, cr, D, **kw)
    dp, Cp = sf.census_sgm_wta(cl, cr, D, plain=True, **kw)
    assert torch.equal(C, Cp) and torch.equal(d, dp)
    _, _, parts, _, _, s_hd, n_down, n_up = _long_way(C, None, pens,
                                                      directions)
    assert int(s_hd.max()) == (30000 if directions == 4 else 50000)
    ref = sf.sum_wta_plain(C, parts, n_down, n_up, subpixel=True,
                           uniqueness_ratio=10.0)
    assert torch.equal(d, ref)
