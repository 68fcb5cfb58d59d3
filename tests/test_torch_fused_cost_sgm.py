"""Torch port: the lean fused cost + SGM path (the plain twins of the
``fused_census_fwd`` / ``fused_bt_fwd`` kernels, TPU kernels J and K, and
the two aggregations built on them) against
``i3dr_stereo_tpu.ops.fused_cost_sgm`` run in Pallas interpret mode, on
the same numpy inputs.

Tolerance: exact. C equal; S equal in int16 mode and in float32 mode,
the 1e9-level entries included. What the TPU kernel cannot run (a window
base below -64, a width that is no multiple of 8) is held against a
brute-force numpy of the contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.ops import fused_cost_sgm as ref
from i3dr_stereo_tpu.ops.census import census_transform as ref_census
from i3dr_stereo_tpu.ops.cost import xsobel_prefilter as ref_xsobel
from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs
from i3dr_stereo_tpu_torch.ops import sgm
from i3dr_stereo_tpu_torch.ops.census import census_transform

torch.set_num_threads(2)

BIG = np.float32(1.0e9)
P1, P2 = 3.25, 21.5


def _images(B, H, W, seed, shift=3):
    rng = np.random.default_rng(seed)
    L = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    R = np.roll(L, -shift, axis=2) + rng.normal(0, 6, (B, H, W)).astype(
        np.float32)
    return L, R


def _census_words(L, R, win):
    """The reference's census words of both images: (jax uint32 word
    planes, the same bits as int32 torch word planes)."""
    cl = ref.census_word_planes(ref_census(jnp.asarray(L), win, win))
    cr = ref.census_word_planes(ref_census(jnp.asarray(R), win, win))
    to_t = lambda w: torch.from_numpy(np.asarray(w).view(np.int32).copy())
    return (cl, cr), (to_t(cl), to_t(cr))


def _np_step(prev, c, p1, p2):
    m = prev.min(-1, keepdims=True)
    big = np.full_like(prev[..., :1], BIG)
    up = np.concatenate([big, prev[..., :-1]], -1)
    dn = np.concatenate([prev[..., 1:], big], -1)
    best = np.minimum(np.minimum(prev, m + p2), np.minimum(up + p1, dn + p1))
    return (c + best) - m


def _brute(cost_fn, B, H, W, base_rows, D, min_disp, p1, p2):
    """The contract in numpy: cost_fn(x, src) -> unclamped (B, H, D) cost
    for in-image src; returns (C uint8, L float32)."""
    p1, p2 = np.float32(p1), np.float32(p2)
    C = np.empty((B, H, W, D), np.uint8)
    Lout = np.empty((B, H, W, D), np.float32)
    carry = np.zeros((B, H, D), np.float32)
    d = np.arange(D)
    for x in range(W):
        src = x - base_rows[:, None] - min_disp - d[None, :]      # (H, D)
        ok = np.broadcast_to((src >= 0) & (src <= W - 1), (B, H, D))
        cost = cost_fn(x, np.clip(src, 0, W - 1)).astype(np.float32)
        C[:, :, x] = np.where(ok, np.minimum(cost, 254), 255).astype(np.uint8)
        carry = _np_step(carry, np.where(ok, cost, BIG), p1, p2)
        Lout[:, :, x] = carry
    return C, Lout


def _brute_census(clw, crw, base_rows, D, min_disp, p1, p2):
    cl = clw.numpy().view(np.uint32)
    cr = crw.numpy().view(np.uint32)
    NW, B, H, W = cl.shape
    rows = np.arange(H)[:, None]

    def cost_fn(x, src):
        x_or = cl[:, :, :, x, None] ^ cr[:, :, rows, src]
        return np.bitwise_count(x_or).sum(0)

    return _brute(cost_fn, B, H, W, base_rows, D, min_disp, p1, p2)


def _assert_same(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# J: fused_census_horizontal
# ---------------------------------------------------------------------------

# win, (B, H, W), D, min_disp, base per 8-row tile (scalar = uniform)
CENSUS_CASES = {
    "5x5_D8": (5, (1, 16, 40), 8, 0, 0),
    "9x9_D32_residual_window": (9, (1, 16, 48), 32, 0, -16),
    "9x9_D32_base_plus4_min_disp": (9, (2, 8, 40), 32, 3, 4),
    "9x9_D48_nonuniform_base": (9, (1, 24, 56), 48, -2, (5, -16, 0)),
    "9x9_D130": (9, (1, 8, 160), 130, 0, 0),
    "17x17_unclamped_forward": (17, (1, 8, 40), 8, 0, 0),
    "H12_tile_of_4": (5, (2, 12, 32), 8, 1, (0, 2, -3)),
    # a base that leaves a whole row tile without a valid column: to the
    # left (base = W) and to the right (base = -64, the reference's limit)
    "9x9_D32_base_W_empties_tile_1": (9, (1, 16, 40), 32, 0, (-16, 40)),
    "9x9_D32_base_minus64_empties_tile_1": (9, (2, 16, 32), 32, 0, (0, -64)),
}


def _base_array(base, H):
    th = fcs.row_tile(H)
    n = H // th
    return (np.full((n,), base, np.int32) if np.isscalar(base)
            else np.asarray(base, np.int32))


@pytest.fixture(scope="module")
def census_runs():
    """Every census case once through the reference (both out dtypes) and
    once through the port."""
    out = {}
    for name, (win, (B, H, W), D, md, base) in CENSUS_CASES.items():
        L, R = _images(B, H, W, seed=len(name))
        if win == 17:
            R = -L  # distances up to 288 > 254
        (jl, jr), (tl, tr) = _census_words(L, R, win)
        b = _base_array(base, H)
        runs = {}
        for jd, td in ((jnp.int16, torch.int16), (jnp.float32, torch.float32)):
            Cr, Sr = ref.fused_census_horizontal(
                jl, jr, jnp.asarray(b), D, P1, P2, min_disp=md, out_dtype=jd,
                interpret=True)
            Cp, Sp = fcs.fused_census_horizontal(
                tl, tr, torch.from_numpy(b), D, P1, P2, min_disp=md,
                out_dtype=td)
            runs[td] = (Cp, Sp, np.asarray(Cr), np.asarray(Sr))
        out[name] = runs
    return out


@pytest.mark.parametrize("name", list(CENSUS_CASES))
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32],
                         ids=["int16", "float32"])
def test_census_horizontal_matches_interpret(name, dtype, census_runs):
    Cp, Sp, Cr, Sr = census_runs[name][dtype]
    _assert_same(Cp, Cr, "C")
    _assert_same(Sp, Sr, "S")
    assert (Cr == 255).any() and (Cr < 255).any()
    if name.startswith("17x17"):
        assert (Cr == 254).any()    # the clamp bites; the sweep is unclamped
        assert Sr.max() > 254
    if "empties_tile_1" in name:
        # rows 8..15: no pairing at all, and a carry that never starts
        assert (Cr[:, 8:] == 255).all()
        assert (Sr[:, 8:] >= (10000 if dtype == torch.int16 else 1e9)).all()


def test_census_right_edge_upper_bound():
    """A negative base points right-edge columns past W-1: those pairings
    are 255 / invalid, not a match against padding."""
    L, R = _images(1, 8, 32, seed=3)
    _, (tl, tr) = _census_words(L, R, 5)
    C, S = fcs.fused_census_horizontal(tl, tr, torch.full((1,), -6,
                                                          dtype=torch.int32),
                                       8, P1, P2, out_dtype=torch.float32)
    # src = x + 6 - d > 31  <=>  d < x - 25
    for x in (27, 31):
        assert (C[0, :, x, :x - 25] == 255).all()
        assert (C[0, :, x, x - 25:] < 255).all()
        assert (S[0, :, x, :x - 25] >= 1e9).all()


@pytest.mark.parametrize("shape,D,md,base", [
    ((1, 8, 96), 16, 0, -80),            # below the TPU's -64
    ((2, 16, 37), 12, 2, (-70, 9)),      # ragged W, non-uniform
    ((1, 5, 21), 33, -1, 0),             # H = 5: tiles of one row
], ids=["base_-80", "ragged_W37", "H5_D33"])
def test_census_horizontal_matches_brute_force(shape, D, md, base):
    B, H, W = shape
    L, R = _images(B, H, W, seed=W)
    _, (tl, tr) = _census_words(L, R, 9)
    b = _base_array(base, H)
    C, S = fcs.fused_census_horizontal(tl, tr, torch.from_numpy(b), D, P1, P2,
                                       min_disp=md, out_dtype=torch.float32)
    rows = np.repeat(b, fcs.row_tile(H))
    Cb, Lb = _brute_census(tl, tr, rows, D, md, P1, P2)
    _assert_same(C, Cb, "C")
    _assert_same(S, Lb, "L")
    _, S16 = fcs.fused_census_horizontal(tl, tr, torch.from_numpy(b), D, P1,
                                         P2, min_disp=md)
    _assert_same(S16, np.minimum(Lb, 10000).astype(np.int32).astype(np.int16),
                 "S int16")
    assert (Cb < 255).any()


def test_brute_force_agrees_with_interpret():
    """The numpy contract itself against the reference, where the
    reference can run."""
    L, R = _images(1, 8, 40, seed=11)
    (jl, jr), (tl, tr) = _census_words(L, R, 9)
    Cr, Sr = ref.fused_census_horizontal(jl, jr, jnp.full((1,), -16), 32, P1,
                                         P2, out_dtype=jnp.float32,
                                         interpret=True)
    Cb, Lb = _brute_census(tl, tr, np.full((8,), -16), 32, 0, P1, P2)
    _assert_same(Cb, Cr, "C")
    _assert_same(Lb, Sr, "L")


# ---------------------------------------------------------------------------
# K: fused_bt_horizontal
# ---------------------------------------------------------------------------

BT_CASES = {
    "D8": ((1, 16, 40), 8, 0, 0),
    "D32_min_disp": ((2, 8, 48), 32, 4, 0),
    "D48_nonuniform_base": ((1, 24, 56), 48, 0, (3, -16, 0)),
    "D130": ((1, 8, 160), 130, 0, 0),
    # a row narrower than the D + 1 halo and than one staged tile
    "D128_narrow": ((1, 8, 48), 128, 0, 0),
    # the second row tile's base leaves it no valid column
    "D16_empty_tile": ((2, 16, 40), 16, 0, (0, 60)),
}


def _prefiltered(B, H, W, seed, cap=31):
    L, R = _images(B, H, W, seed)
    return (np.array(ref_xsobel(jnp.asarray(L), cap)),
            np.array(ref_xsobel(jnp.asarray(R), cap)))


@pytest.fixture(scope="module")
def bt_runs():
    out = {}
    for name, ((B, H, W), D, md, base) in BT_CASES.items():
        lp, rp = _prefiltered(B, H, W, seed=len(name) + 20)
        b = _base_array(base, H)
        runs = {}
        for jd, td in ((jnp.int16, torch.int16), (jnp.float32, torch.float32)):
            Cr, Sr = ref.fused_bt_horizontal(
                jnp.asarray(lp), jnp.asarray(rp), jnp.asarray(b), D, 2 * P1,
                2 * P2, min_disp=md, out_dtype=jd, interpret=True)
            Cp, Sp = fcs.fused_bt_horizontal(
                torch.from_numpy(lp), torch.from_numpy(rp),
                torch.from_numpy(b), D, 2 * P1, 2 * P2, min_disp=md,
                out_dtype=td)
            runs[td] = (Cp, Sp, np.asarray(Cr), np.asarray(Sr))
        out[name] = runs
    return out


@pytest.mark.parametrize("name", list(BT_CASES))
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32],
                         ids=["int16", "float32"])
def test_bt_horizontal_matches_interpret(name, dtype, bt_runs):
    Cp, Sp, Cr, Sr = bt_runs[name][dtype]
    _assert_same(Cp, Cr, "C")
    _assert_same(Sp, Sr, "S")
    assert (Cr == 255).any() and (Cr < 255).any()
    assert (Cr[Cr < 255] % 2 == 1).any()    # half-sample costs, doubled


def test_bt_fractional_images_round_half_to_even():
    """Fractional inputs make 2 * cost land on .5: rint, not roundf."""
    rng = np.random.default_rng(5)
    lp = (rng.integers(0, 250, (1, 8, 32)) * 0.25).astype(np.float32)
    rp = (rng.integers(0, 250, (1, 8, 32)) * 0.25).astype(np.float32)
    b = np.zeros((1,), np.int32)
    Cr, Sr = ref.fused_bt_horizontal(jnp.asarray(lp), jnp.asarray(rp),
                                     jnp.asarray(b), 8, 6.5, 43.0,
                                     out_dtype=jnp.float32, interpret=True)
    Cp, Sp = fcs.fused_bt_horizontal(torch.from_numpy(lp),
                                     torch.from_numpy(rp),
                                     torch.from_numpy(b), 8, 6.5, 43.0,
                                     out_dtype=torch.float32)
    _assert_same(Cp, Cr, "C")
    _assert_same(Sp, Sr, "S")


# ---------------------------------------------------------------------------
# the full aggregations
# ---------------------------------------------------------------------------

PENS8 = [(1.5, 9.0), (2.0, 11.0), (1.5, 9.0), (2.0, 11.0), (0.75, 30.0),
         (2.0, 11.0), (1.5, 9.0), (0.5, 4.0)]


NO_REVERSE = ((0, 1), (1, 0), (1, 1), (1, -1), (-1, 0))


@pytest.mark.parametrize("dirs,pens,base,D,dtype", [
    (sgm.DIRECTIONS_4, PENS8[:4], -16, 32, "int16"),
    (sgm.DIRECTIONS_8, PENS8, 2, 24, "int16"),
    (sgm.DIRECTIONS_8, PENS8, 0, 16, "float32"),
    (sgm.DIRECTIONS_4, None, 0, 40, "float32"),
    (NO_REVERSE, None, -4, 32, "int16"),
], ids=["4path_pens", "8path_pens", "8path_pens_f32", "4path_uniform_f32",
        "no_reverse_int16"])
def test_fused_census_sgm_matches_interpret(dirs, pens, base, D, dtype):
    L, R = _images(2, 16, 40, seed=D)
    cl, cr = ref_census(jnp.asarray(L), 9, 9), ref_census(jnp.asarray(R), 9, 9)
    Sr, Cr = ref.fused_census_sgm(
        cl, cr, D, base=base, p1=P1, p2=P2, per_direction_penalties=pens,
        directions=dirs, out_dtype=getattr(jnp, dtype), interpret=True)
    tcl = census_transform(torch.from_numpy(L), 9, 9)
    tcr = census_transform(torch.from_numpy(R), 9, 9)
    np.testing.assert_array_equal(tcl.numpy().view(np.uint32), np.asarray(cl))
    Sp, Cp = fcs.fused_census_sgm(
        tcl, tcr, D, base=base, p1=P1, p2=P2, per_direction_penalties=pens,
        directions=dirs, out_dtype=getattr(torch, dtype))
    _assert_same(Cp, Cr, "C")
    _assert_same(Sp, Sr, "S")
    level = 9999 if dtype == "int16" else 5e8
    assert (np.asarray(Sr) >= level).any() and (np.asarray(Sr) < level).any()


@pytest.mark.parametrize("dirs,D,md,dtype", [
    (sgm.DIRECTIONS_8, 32, 0, "int16"),
    (sgm.DIRECTIONS_5, 24, 3, "int16"),
    (sgm.DIRECTIONS_8, 16, 0, "float32"),
    (NO_REVERSE, 16, 0, "float32"),
], ids=["8path", "5path_min_disp", "8path_f32", "no_reverse_f32"])
def test_fused_bt_sgm_matches_interpret(dirs, D, md, dtype):
    lp, rp = _prefiltered(2, 16, 40, seed=D + 1)
    Sr, Cr = ref.fused_bt_sgm(jnp.asarray(lp), jnp.asarray(rp), D,
                              min_disp=md, p1=8.0, p2=32.0, directions=dirs,
                              out_dtype=getattr(jnp, dtype), interpret=True)
    Sp, Cp = fcs.fused_bt_sgm(torch.from_numpy(lp), torch.from_numpy(rp), D,
                              min_disp=md, p1=8.0, p2=32.0, directions=dirs,
                              out_dtype=getattr(torch, dtype))
    _assert_same(Cp, Cr, "C")
    _assert_same(Sp, Sr, "S")


def _lean_inputs(kind, seed):
    """(fused aggregation, its forward kernel's name in fcs, its inputs,
    keyword arguments, the forward's (left, right, base, p1, p2))."""
    if kind == "census":
        L, R = _images(2, 16, 40, seed=seed)
        tcl = census_transform(torch.from_numpy(L), 9, 9)
        tcr = census_transform(torch.from_numpy(R), 9, 9)
        fwd_in = (fcs.census_word_planes(tcl), fcs.census_word_planes(tcr),
                  torch.full((2,), -4, dtype=torch.int32), P1, P2)
        return (fcs.fused_census_sgm, "fused_census_horizontal", (tcl, tcr),
                dict(base=-4, p1=P1, p2=P2), fwd_in)
    lp, rp = (torch.from_numpy(x) for x in _prefiltered(2, 16, 40, seed))
    return (fcs.fused_bt_sgm, "fused_bt_horizontal", (lp, rp),
            dict(p1=8.0, p2=32.0), (lp, rp, torch.zeros((2,), dtype=torch.int32),
                                    16.0, 64.0))


@pytest.mark.parametrize("kind", ["census", "bt"])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32],
                         ids=["int16", "float32"])
def test_lean_aggregate_asks_the_forward_pass_for_its_mode(kind, dtype,
                                                           monkeypatch):
    """int16 mode asks J / K for int16 path costs, as the reference does
    (its S_fwd.astype(int32)); float32 mode for float32."""
    fn, fwd_name, args, kw, _ = _lean_inputs(kind, seed=5)
    asked = []
    real = getattr(fcs, fwd_name)

    def spy(*a, **k):
        asked.append(k["out_dtype"])
        return real(*a, **k)

    monkeypatch.setattr(fcs, fwd_name, spy)
    S, _ = fn(*args, 24, directions=sgm.DIRECTIONS_8, out_dtype=dtype, **kw)
    assert asked == [dtype]
    assert S.dtype == (torch.int32 if dtype == torch.int16 else torch.float32)


@pytest.mark.parametrize("kind,dirs,pens,dtype", [
    ("census", sgm.DIRECTIONS_8, PENS8, torch.int16),
    ("census", sgm.DIRECTIONS_4, None, torch.float32),
    ("census", NO_REVERSE, None, torch.int16),
    ("bt", sgm.DIRECTIONS_8, None, torch.int16),
    ("bt", NO_REVERSE, None, torch.float32),
], ids=["census_8path_pens_int16", "census_4path_f32",
        "census_no_reverse_int16", "bt_8path_int16", "bt_no_reverse_f32"])
def test_lean_chain_equals_the_sum_of_partials(kind, dirs, pens, dtype):
    """The lean chain (J / K's plane, the other directions folded into
    it) equals the forward pass's float32 L and the per-direction
    partials summed in the TPU's order, bit for bit."""
    fn, fwd_name, args, kw, (fl, fr, base, q1, q2) = _lean_inputs(kind, 9)
    D = 24
    if pens is not None:
        kw = dict(kw, per_direction_penalties=pens)
    S, C = fn(*args, D, directions=dirs, out_dtype=dtype, plain=True, **kw)
    pen = ({d: (P1, P2) for d in dirs} if pens is None
           else {d: tuple(pens[i]) for i, d in enumerate(dirs)})
    if kind == "bt":
        pen = {d: (16.0, 64.0) for d in dirs}
    Cf, Lf = getattr(fcs, fwd_name + "_plain")(fl, fr, base, D, *pen[(0, 1)],
                                               out_dtype=torch.float32)
    assert torch.equal(C, Cf)
    groups = sgm._groups(dirs, pen, 40, D, 1)[1:]
    parts = [Lf] + [sgm.sgm_volume_path_plain(C, dy, dx, *pp)
                    for pp, ds in groups for dy, dx in ds]
    ref_S = sgm.sgm_volume_sum_plain(parts, [1] + [len(ds) for _, ds in groups],
                                     dtype == torch.int16)
    assert torch.equal(S, ref_S)


def test_lean_grouping_splits_at_the_exact_D():
    """The lean path checks the TPU's VMEM rule with the exact D: at
    W = 2448, D = 256 a three-direction family splits, at D = 32 not."""
    pen = {d: (1.0, 2.0) for d in sgm.DIRECTIONS_8}
    sizes = lambda D: [len(ds) for _, ds in
                       sgm._groups(sgm.DIRECTIONS_8, pen, 2448, D, 1)]
    assert sizes(32) == [1, 1, 3, 3]
    assert sizes(256) == [1, 1, 1, 1, 1, 1, 1, 1]


def test_plain_switch_and_wrapper_checks():
    L, R = _images(1, 8, 24, seed=1)
    tcl = census_transform(torch.from_numpy(L), 5, 5)
    tcr = census_transform(torch.from_numpy(R), 5, 5)
    a = fcs.fused_census_sgm(tcl, tcr, 8, base=-4)
    b = fcs.fused_census_sgm(tcl, tcr, 8, base=-4, plain=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="W->E"):
        fcs.fused_census_sgm(tcl, tcr, 8, directions=((0, -1), (1, 0)))
    planes = fcs.census_word_planes(tcl)
    base = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 512"):
        fcs.fused_census_horizontal(planes, planes, base, 513, 1.0, 2.0)
    with pytest.raises(ValueError, match="one entry per tile"):
        fcs.fused_census_horizontal(planes, planes, torch.zeros(3), 8, 1.0,
                                    2.0)
    with pytest.raises(ValueError, match="out_dtype"):
        fcs.fused_census_horizontal(planes, planes, base, 8, 1.0, 2.0,
                                    out_dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fcs.fused_census_horizontal(planes.to("meta"), planes.to("meta"),
                                    base, 8, 1.0, 2.0)
    img = torch.zeros((1, 8, 24))
    with pytest.raises(ValueError, match="CUDA"):
        fcs.fused_bt_horizontal(img.to("meta"), img.to("meta"), base, 8, 1.0,
                                2.0)
    with pytest.raises(ValueError, match="float32"):
        fcs.fused_bt_horizontal(img.double(), img.double(), base, 8, 1.0, 2.0)
