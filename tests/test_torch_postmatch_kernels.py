"""Torch port: the plain twins of the post-match kernels (``csrc/wls_lines.cu``
and ``csrc/gauss_rays.cu``) against independent references on the CPU.

- ``thomas_lines_plain`` is the kernel's partitioned line solve (32
  segments a line, interfaces solved by Thomas's algorithm): held against
  a float64 Thomas solve and the JAX package's ``_thomas_rows`` at the
  tolerances of ``tests/test_torch_postmatch.py``, at the lengths where
  the partition changes shape (one element, two, fewer than 32 segments,
  a ragged last segment) and on a line of holes to its end (the zero
  pivot, where the reference is NaN), in both passes; a line of at most
  32 elements is one element a segment, where the partition is Thomas's
  algorithm itself, bit for bit.
- ``gauss_interpolate_plain`` against NumPy models of the kernel forms:
  the reference's rounds on byte states (a state is "no support" or the
  subset of rounds taken; its distance from a table of float32 sums in
  round order built from ``_ray_table``) and the doubling evaluated as
  the recursion it unrolls into, subtrees that cannot win skipped, hole
  by hole.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu.ops import wls as ref_wls
from i3dr_stereo_tpu_torch.ops import gauss_interp as gi
from i3dr_stereo_tpu_torch.ops import wls
from test_torch_postmatch import TOL_THOMAS, TOL_WITNESS, _thomas_f64

torch.set_num_threads(2)

LAM_FIRST = 1.5 * 8000.0 * 16.0 / 63.0      # the WLS fill's first pass


def _t(x):
    return torch.from_numpy(np.array(x))


def _system(seed, shape, holes=0.3, axis=-1):
    """Data weights (1, 0 in holes), data, and the edge weights the WLS
    filter makes from a layered scene's left image along ``axis``
    (exp(-|dI| / 0.15) on I / 255), for (B, H, W) planes."""
    B, H, W = shape
    rng = np.random.default_rng(seed)
    g = np.stack([layered_scene(max(H, 32), max(W, 64), seed=seed + b)
                  .left[:H, :W] for b in range(B)]) / 255.0
    a = (rng.random(shape) > holes).astype(np.float32)
    d = rng.uniform(0, 30, shape).astype(np.float32)
    w = np.exp(-np.abs(np.diff(g, axis=axis)) / 0.15).astype(np.float32)
    return a, w, d


# ---------------------------------------------------------------------------
# the partitioned line solve
# ---------------------------------------------------------------------------

# N: 1, 2, fewer than 32 (segments of one element), 32, one past it (a
# ragged last segment of one), segments of 3 with a ragged last one, and
# 77 a segment (the flagship frame's rows of 2448) cut short
LENGTHS = (1, 2, 20, 32, 33, 70, 100, 2448)


def _lines(N):
    """Three lines of N; the first with its last min(N // 3, 8) elements
    holes."""
    a, w, d = _system(N, (1, 3, N))
    a[0, 0, N - min(N // 3, 8):] = 0
    return a[0], w[0], d[0]


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's solves of every case, one run a length."""
    out = {}
    for N in LENGTHS:
        a, w, d = _lines(N)
        for lam in (LAM_FIRST, 3.0):
            out[N, lam] = np.asarray(ref_wls._thomas_rows(
                jnp.asarray(a), jnp.asarray(w), jnp.asarray(d), lam))
    return out


@pytest.mark.parametrize("N", LENGTHS)
def test_partitioned_solve_matches_thomas(N, jax_solves):
    a, w, d = _lines(N)
    for lam in (LAM_FIRST, 3.0):
        got = wls.thomas_lines_plain(_t(a), _t(w), _t(d), lam).numpy()
        assert np.isfinite(got).all()
        want64 = _thomas_f64(a.astype(np.float64), w, d, np.float32(lam))
        np.testing.assert_allclose(got, want64, rtol=0, atol=TOL_WITNESS)
        # the reference is NaN on a line whose last pivot is 0
        ref = jax_solves[N, lam]
        ok = np.isfinite(ref).all(-1)
        assert ok[1:].all()
        np.testing.assert_allclose(got[ok], ref[ok], rtol=0,
                                   atol=TOL_THOMAS)


def _thomas_f32(a, w, d, lam):
    """Thomas's algorithm in float32 torch as the kernel runs it (the
    twin's coefficients and zero-pivot repair, a reciprocal of each pivot
    and products), written here."""
    zeros = torch.zeros_like(d[..., :1])
    wl, wr = torch.cat([zeros, w], -1), torch.cat([w, zeros], -1)
    diag = a + lam * (wl + wr) + 1e-8
    lower, upper, rhs = -lam * wl, -lam * wr, a * d
    c = p = torch.zeros_like(d[..., 0])
    cs, ps = [], []
    for i in range(d.shape[-1]):
        den = diag[..., i] - lower[..., i] * c
        inv = torch.reciprocal(torch.where(den == 0, 1e-8, den))
        c = upper[..., i] * inv
        p = (rhs[..., i] - lower[..., i] * p) * inv
        cs.append(c)
        ps.append(p)
    u = [ps[-1]]
    for i in range(d.shape[-1] - 2, -1, -1):
        u.append(ps[i] - cs[i] * u[-1])
    return torch.stack(u[::-1], -1)


@pytest.mark.parametrize("N", [1, 2, 5, 31, 32])
def test_partition_of_short_lines_is_thomas(N):
    """A line of at most 32 elements is one element a segment: no
    interior, the interface rows are the line's own rows."""
    a, w, d = (x[0] for x in _system(40 + N, (1, 4, N)))
    for lam in (LAM_FIRST, 3.0):
        got = wls.thomas_lines_plain(_t(a), _t(w), _t(d), lam)
        assert torch.equal(got, _thomas_f32(_t(a), _t(w), _t(d), lam))


@pytest.mark.parametrize("vertical", [False, True])
def test_partitioned_solve_zero_pivot_both_passes(vertical):
    """Lines with holes to their end, and a whole line of holes on a flat
    guide, where the reference's last pivot (lam w less the same product,
    the 1e-8 lost next to it) is exactly 0 and it divides by it (NaN): the
    twin is finite and agrees with the float64 solve, along rows and along
    columns."""
    a, w, d = _system(9, (2, 48, 64), holes=0.2,
                      axis=-2 if vertical else -1)
    a[0, :, 54:] = 0          # rows with a tail of holes
    a[0, 36:, :] = 0          # columns with a tail of holes
    a[1, 7, :] = 0            # a whole row of holes
    a[1, :, 11] = 0           # a whole column of holes
    if vertical:
        w[1, :, 11] = 1.0
    else:
        w[1, 7, :] = 1.0
    got = wls.thomas_lines(_t(a), _t(w), _t(d), LAM_FIRST,
                           vertical=vertical).numpy()
    assert np.isfinite(got).all()
    sw = (lambda x: np.swapaxes(x, -1, -2)) if vertical else (lambda x: x)
    want = sw(_thomas_f64(sw(a).astype(np.float64), sw(w), sw(d),
                          np.float32(LAM_FIRST)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_WITNESS)
    ref = sw(np.asarray(ref_wls._thomas_rows(
        *(jnp.asarray(sw(x)) for x in (a, w, d)), LAM_FIRST)))
    line = ref[1, 7] if not vertical else ref[1, :, 11]
    assert np.isnan(line).all()


# ---------------------------------------------------------------------------
# the Gauss fill: NumPy models of the kernel forms
# ---------------------------------------------------------------------------

NONE = 255   # the byte state "no support" (the reference's BIG)


def _directions(n_directions, max_radius):
    """Each direction's rounds from the kernel's host table
    (``_ray_table``): (dy, dx) as int32 words, the lengths in float32."""
    tab = gi._ray_table(n_directions, max_radius, torch.device("cpu"))
    tab = tab.numpy()
    R = tab.shape[1] // 3
    steps = tab[:, :2 * R].view(np.int32).reshape(-1, R, 2)
    return [(steps[k], tab[k, 2 * R:]) for k in range(n_directions)]


def _subset_tables(steps, lens):
    """A subset S of rounds: its distance, the float32 sum of its lengths
    in round order (0 for the empty one), and its offset."""
    R = len(lens)
    dst = np.full(256, np.float32(gi.BIG), np.float32)
    off = np.zeros((256, 2), np.int64)
    for S in range(1 << R):
        acc = np.float32(0.0)
        for r in range(R):
            if S >> r & 1:
                acc = np.float32(acc + lens[r])
                off[S] += steps[r]
        dst[S] = acc
    return dst, off


def _shift(x, dy, dx, fill):
    out = np.full_like(x, fill)
    H, W = x.shape[-2:]
    ys, ye, xs, xe = max(-dy, 0), H - max(dy, 0), max(-dx, 0), W - max(dx, 0)
    if ys < ye and xs < xe:
        out[..., ys:ye, xs:xe] = x[..., ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def _rounds_model(d, v, n_directions, max_radius):
    """Each direction's (val, dst) by the rounds on byte states: round r
    moves the state t of p + o_r onto p as t + {r} where that subset's
    distance is strictly smaller; val is d at p + the subset's offset."""
    B, H, W = d.shape
    ys, xs = np.mgrid[:H, :W]
    out = []
    for steps, lens in _directions(n_directions, max_radius):
        dst_of, off = _subset_tables(steps, lens)
        state = np.where(v, 0, NONE).astype(np.uint8)
        for r, (dy, dx) in enumerate(steps):
            if dy or dx:
                t = _shift(state, dy, dx, NONE)
                cand = np.where(t == NONE, NONE, t | (1 << r)).astype(np.uint8)
                state = np.where(dst_of[cand] < dst_of[state], cand, state)
        qy = np.clip(ys + off[state, 0], 0, H - 1)
        qx = np.clip(xs + off[state, 1], 0, W - 1)
        val = np.where(state == NONE, np.float32(0),
                       d[np.arange(B)[:, None, None], qy, qx])
        out.append((val, dst_of[state]))
    return out


def _walk_model(d, v, n_directions, max_radius):
    """Each direction's (val, dst) by the recursion the rounds unroll into,
    N(r, q) = pick(N(r-1, q), N(r-1, q + o_r)), a subtree skipped where its
    root leaves the image or where the state it would replace is no
    farther than the round's length; hole by hole (valid pixels keep
    (d, 0))."""
    B, H, W = d.shape
    big = np.float32(gi.BIG)

    def node(b, L, y, x, steps, lens):
        if L == 0:
            return (d[b, y, x], np.float32(0)) if v[b, y, x] else \
                (np.float32(0), big)
        val, dst = node(b, L - 1, y, x, steps, lens)
        dy, dx = steps[L - 1]
        if (dy or dx) and dst > lens[L - 1]:
            yy, xx = y + dy, x + dx
            v2, d2 = (node(b, L - 1, yy, xx, steps, lens)
                      if 0 <= yy < H and 0 <= xx < W else (np.float32(0), big))
            d2 = np.float32(d2 + lens[L - 1])
            if d2 < dst:
                val, dst = v2, d2
        return val, dst

    out = []
    for steps, lens in _directions(n_directions, max_radius):
        val = np.where(v, d, np.float32(0))
        dst = np.where(v, np.float32(0), big)
        for b, y, x in zip(*np.nonzero(~v)):
            val[b, y, x], dst[b, y, x] = node(b, len(lens), y, x, steps, lens)
        out.append((val, dst))
    return out


def _twin_rounds(d, v, n_directions, max_radius):
    """The twin's (val, dst) of each direction, its own rounds."""
    dt, vt = _t(d), _t(v)
    out = []
    for offsets in gi.ray_offsets(n_directions, max_radius):
        val = torch.where(vt, dt, 0.0)
        dst = torch.where(vt, 0.0, gi.BIG)
        for dy, dx in offsets:
            if dy or dx:
                sl = float(np.hypot(dy, dx))
                v2 = gi._shift_with_fill(val, dy, dx, 0.0)
                d2 = gi._shift_with_fill(dst, dy, dx, gi.BIG) + sl
                take = d2 < dst
                val = torch.where(take, v2, val)
                dst = torch.where(take, d2, dst)
        out.append((val.numpy(), dst.numpy()))
    return out


def _fill_from(states, d, v, max_radius, sigma=16.0, min_elements=0):
    """The twin's weights and sums over given per-direction states."""
    dt, vt = _t(d), _t(v)
    wsum = torch.zeros_like(dt)
    vsum = torch.zeros_like(dt)
    nrays = torch.zeros_like(dt)
    for val, dst in states:
        val, dst = _t(val), _t(dst)
        hit = dst < min(max_radius, gi.BIG / 2)
        w = torch.where(hit, torch.exp(wls.div_const(-(dst * dst),
                                                     2.0 * sigma * sigma)),
                        0.0)
        wsum = wsum + w
        vsum = vsum + w * val
        nrays = nrays + hit.to(torch.float32)
    filled = torch.where(wsum > 0, vsum / torch.clamp(wsum, min=1e-20), 0.0)
    ok = (nrays >= max(min_elements, 1)) & (wsum > 0)
    return torch.where(vt, dt, filled), vt | ok


GAUSS_MODEL_CASES = [
    (0, (1, 12, 17), 0.4, 32, 64),    # the shipped fill
    (1, (2, 9, 13), 0.7, 16, 16),     # a batch, mostly holes
    (2, (1, 20, 24), 0.3, 8, 5),      # rounds of length 0 skipped
    (3, (1, 6, 70), 0.9, 32, 40),     # holes wider than the radius
]


@pytest.mark.parametrize("seed,shape,holes,n_dir,radius", GAUSS_MODEL_CASES)
@pytest.mark.parametrize("model", ["rounds", "walk"])
def test_gauss_kernel_models_match_twin(model, seed, shape, holes, n_dir,
                                        radius):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 60, shape).astype(np.float32)
    v = rng.random(shape) >= holes
    v[0, :, :2] = False                     # a hole band at the border
    states = (_rounds_model if model == "rounds" else _walk_model)(
        d, v, n_dir, radius)
    for (val, dst), (tval, tdst) in zip(states,
                                        _twin_rounds(d, v, n_dir, radius)):
        np.testing.assert_array_equal(dst, tdst)
        np.testing.assert_array_equal(val, tval)
    got_d, got_v = _fill_from(states, d, v, radius)
    want_d, want_v = gi.gauss_interpolate_plain(
        _t(d), _t(v), n_directions=n_dir, max_radius=radius)
    assert torch.equal(got_d, want_d) and torch.equal(got_v, want_v)
