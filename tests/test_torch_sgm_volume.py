"""Torch port: volume SGM (the plain twin of the ``sgm_volume`` kernel,
TPU kernels H and I) against ``sgm_aggregate_pallas`` run in Pallas
interpret mode, the JAX package's aggregation as the TPU runs it, on the
same numpy volumes.

The twin pads the volume as the TPU does and keeps its summation order,
so it equals the reference bit for bit: below 1e9/2 and at the 1e9-level
entries alike (a parabolic subpixel next to an invalid disparity reads
those). The accumulating chain (each direction folded into the running
sum in place, group totals in a float32 plane) also equals the sum of
per-direction partials in the TPU's order, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.ops.sgm import sgm_aggregate as ref_xla
from i3dr_stereo_tpu.ops.sgm_pallas import sgm_aggregate_pallas
from i3dr_stereo_tpu_torch.ops import sgm

torch.set_num_threads(2)

BIG = 1.0e9


def _volume(shape, seed, kind="float", invalid_cols=0):
    """float: random fractional costs; int: integer costs; u8: census-
    scale uint8 with the 255 sentinel. 1e9 (255) entries are scattered,
    and the first ``invalid_cols`` columns are invalid at every disparity
    above the column index, as min_disparity leaves them."""
    rng = np.random.default_rng(seed)
    if kind == "u8":
        C = rng.integers(0, 81, shape).astype(np.uint8)
        bad = 255
    else:
        C = (rng.uniform(0, 60, shape) if kind == "float"
             else rng.integers(0, 90, shape)).astype(np.float32)
        bad = BIG
    C[rng.random(shape) < 0.04] = bad
    for x in range(invalid_cols):
        C[..., x, x:] = bad
    return C


def _both(C, dirs, pens=None, p1=3.25, p2=21.5, int16=False):
    ref = np.asarray(sgm_aggregate_pallas(
        jnp.asarray(C), p1, p2, dirs, pens,
        out_dtype=jnp.int16 if int16 else None, interpret=True))
    port = sgm.sgm_aggregate(torch.from_numpy(C), p1, p2, dirs, pens,
                             out_dtype=torch.int16 if int16 else None)
    return port.numpy(), ref


def _assert_exact(port, ref, level):
    assert port.dtype == ref.dtype and port.shape == ref.shape
    lo = ref < level
    np.testing.assert_array_equal(port < level, lo)
    np.testing.assert_array_equal(port[lo], ref[lo])
    # the padding's 1e9-level values reach the output: equal too
    np.testing.assert_array_equal(port, ref)
    assert lo.any() and (~lo).any()


@pytest.mark.parametrize("shape,dirs,kind,invalid_cols", [
    ((1, 16, 24, 32), sgm.DIRECTIONS_8, "float", 0),
    ((2, 13, 21, 6), sgm.DIRECTIONS_8, "float", 3),       # ragged, D=6
    ((11, 19, 130), sgm.DIRECTIONS_4, "float", 0),        # unbatched, D->256
    ((1, 12, 17, 32), sgm.DIRECTIONS_5, "int", 5),
    ((2, 9, 14, 24), sgm.DIRECTIONS_4, "int", 0),
])
def test_float_volume_matches_interpret(shape, dirs, kind, invalid_cols):
    C = _volume(shape, seed=sum(shape), kind=kind, invalid_cols=invalid_cols)
    port, ref = _both(C, dirs)
    _assert_exact(port, ref, BIG / 2)


def test_per_direction_penalties_two_groups_in_one_family():
    """Top-down (1,0) and (1,-1) share a penalty, (1,1) has its own: two
    groups in one family, summed group by group."""
    C = _volume((1, 14, 22, 40), seed=4, invalid_cols=4)
    pens = [(1.5, 9.0), (2.0, 11.0), (1.5, 9.0), (2.0, 11.0),
            (0.75, 30.0), (2.0, 11.0), (1.5, 9.0), (0.5, 4.0)]
    port, ref = _both(C, sgm.DIRECTIONS_8, pens=pens)
    _assert_exact(port, ref, BIG / 2)


@pytest.mark.parametrize("shape,dirs", [
    ((1, 12, 20, 40), sgm.DIRECTIONS_8),
    ((2, 10, 13, 64), sgm.DIRECTIONS_4),
    ((9, 17, 130), sgm.DIRECTIONS_5),
])
def test_uint8_sentinel_int16_mode(shape, dirs):
    C = _volume(shape, seed=shape[-1], kind="u8", invalid_cols=3)
    port, ref = _both(C, dirs, p1=7.0, p2=86.0, int16=True)
    assert ref.dtype == np.int32
    _assert_exact(port, ref, 9999)


def test_wide_volume_splits_groups_as_the_tpu():
    """At W * D this wide the TPU runs each vertical direction alone
    (its VMEM rule), which changes the int16 clamps and the float32
    summation order: the twin must split where the TPU splits."""
    C = _volume((1, 8, 1160, 400), seed=8, kind="u8")
    dirs = ((0, 1), (1, 0), (1, 1), (1, -1))
    port, ref = _both(C, dirs, p1=7.0, p2=86.0, int16=True)
    _assert_exact(port, ref, 9999)
    assert not sgm._vmem_ok_vertical(1160, 512, 3, 1)
    joined = sgm.sgm_volume_sum_plain(
        [torch.zeros((1,)), torch.full((1,), BIG), torch.full((1,), BIG)],
        [3], True)
    split = sgm.sgm_volume_sum_plain(
        [torch.zeros((1,)), torch.full((1,), BIG), torch.full((1,), BIG)],
        [1, 1, 1], True)
    assert joined.item() == 10000 and split.item() == 20000


def test_twin_near_xla_reference():
    """The XLA lax.scan reference (no padding, no grouping) agrees within
    1e-3 below 1e9/2, as tests/test_sgm_pallas.py holds the TPU kernels."""
    C = _volume((2, 15, 23, 20), seed=6, invalid_cols=4)
    port = sgm.sgm_aggregate(torch.from_numpy(C), 3.25, 21.5,
                             sgm.DIRECTIONS_8).numpy()
    ref = np.asarray(ref_xla(jnp.asarray(C), 3.25, 21.5, sgm.DIRECTIONS_8))
    ok = ref < BIG / 2
    np.testing.assert_array_equal(port < BIG / 2, ok)
    np.testing.assert_allclose(port[ok], ref[ok], rtol=0, atol=1e-3)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        sgm.sgm_aggregate(torch.zeros((1, 8, 8, 32), device="meta"))
    with pytest.raises(ValueError, match="512"):
        sgm.sgm_aggregate(torch.zeros((1, 8, 8, 520), device="meta"))
    with pytest.raises(ValueError, match="float32 or uint8"):
        sgm.sgm_aggregate(torch.zeros((1, 8, 8, 32), dtype=torch.int16))
    # the planes one launch folds into: float32 out takes a float32 acc,
    # int32 out an int32 or (uint8 costs only) int16 acc, all one shape
    C8 = torch.zeros((1, 8, 8, 32), dtype=torch.uint8, device="meta")
    Cf = torch.zeros((1, 8, 8, 32), device="meta")
    f32, i32, i16 = (torch.zeros((1, 8, 8, 32), dtype=t, device="meta")
                     for t in (torch.float32, torch.int32, torch.int16))
    for C, out, x, acc in ((C8, f32, None, i32), (C8, i32, None, f32),
                           (Cf, i32, None, i16), (C8, i16, None, None),
                           (C8, f32, i32, None), (C8, f32[..., :8], None, None)):
        with pytest.raises(ValueError, match="int32 plane"):
            sgm.sgm_volume_step(C, 0, 1, 1.0, 2.0, out, x, acc)
    with pytest.raises(ValueError, match="CUDA"):
        sgm.sgm_volume_step(C8, 0, 1, 1.0, 2.0, i32, f32, i16)


PENS8 = [(1.5, 9.0), (2.0, 11.0), (1.5, 9.0), (2.0, 11.0), (0.75, 30.0),
         (2.0, 11.0), (1.5, 9.0), (0.5, 4.0)]


def _chain_and_partials(C, dirs, pens, p1, p2, int16):
    """(the accumulating chain's S, the sum of per-direction partials,
    the group sizes) over the padded volume, both through plain torch."""
    Cb, groups, i16, _ = sgm.plan(torch.from_numpy(C), p1, p2, dirs, pens,
                                  torch.int16 if int16 else None)
    chain = sgm.fold_paths(Cb, groups, i16, sgm.sgm_volume_step_plain)
    parts = [sgm.sgm_volume_path_plain(Cb, dy, dx, *pp)
             for pp, ds in groups for dy, dx in ds]
    sizes = [len(ds) for _, ds in groups]
    return chain, sgm.sgm_volume_sum_plain(parts, sizes, i16), sizes


# shape, directions, per-direction penalties, cost kind, int16 mode, the
# group sizes in summation order
CHAIN_CASES = {
    "f32_8paths": ((1, 12, 18, 24), sgm.DIRECTIONS_8, None, "float", False,
                   [1, 1, 3, 3]),
    "int16_8paths": ((1, 12, 18, 40), sgm.DIRECTIONS_8, None, "u8", True,
                     [1, 1, 3, 3]),
    "f32_pens_two_groups": ((1, 10, 15, 20), sgm.DIRECTIONS_8, PENS8,
                            "float", False, [1, 1, 2, 1, 2, 1]),
    "int16_pens_two_groups": ((2, 9, 13, 30), sgm.DIRECTIONS_8, PENS8, "u8",
                              True, [1, 1, 2, 1, 2, 1]),
    "f32_no_reverse_horizontal": ((1, 11, 16, 24),
                                  ((0, 1), (1, 0), (1, 1), (1, -1), (-1, 0),
                                   (-1, 1)), None, "int", False, [1, 3, 2]),
    "int16_vertical_group_first": ((1, 11, 16, 24),
                                   ((1, 0), (1, 1), (1, -1), (-1, 0)), None,
                                   "u8", True, [3, 1]),
    "f32_vertical_group_first": ((2, 9, 14, 12),
                                 ((1, 1), (1, -1), (1, 0), (-1, -1)), None,
                                 "float", False, [3, 1]),
}


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_accumulating_chain_equals_partials_and_interpret(name):
    """The chain's twin equals the sum of per-direction partials and the
    JAX kernels in interpret mode, bit for bit: groups of one, of two and
    of three, a group first, per-direction penalties, no (0, -1)."""
    shape, dirs, pens, kind, int16, sizes = CHAIN_CASES[name]
    C = _volume(shape, seed=len(name), kind=kind, invalid_cols=3)
    p1, p2 = (7.0, 86.0) if int16 else (3.25, 21.5)
    chain, summed, got_sizes = _chain_and_partials(C, dirs, pens, p1, p2,
                                                   int16)
    assert got_sizes == sizes
    assert chain.dtype == (torch.int32 if int16 else torch.float32)
    assert torch.equal(chain, summed)
    port, ref = _both(C, dirs, pens, p1=p1, p2=p2, int16=int16)
    _assert_exact(port, ref, 9999 if int16 else BIG / 2)
    H, W, D = shape[-3:]
    np.testing.assert_array_equal(chain[:, :H, :W, :D].numpy().reshape(
        port.shape), port)


def test_split_family_chain_equals_partials():
    """Where the TPU runs each vertical direction alone, the chain folds
    each into S with its own int16 clamp, as the partials' sum does."""
    C = _volume((1, 8, 1160, 400), seed=8, kind="u8")
    chain, summed, sizes = _chain_and_partials(
        C, ((0, 1), (1, 0), (1, 1), (1, -1)), None, 7.0, 86.0, True)
    assert sizes == [1, 1, 1, 1]
    assert torch.equal(chain, summed)


def _recorded_ops(groups, int16, S=None, shape=(1, 8, 8, 32)):
    """The launches fold_paths makes: [(direction, out, x, acc)] with the
    planes named S (the returned sum), T (the group total), F (the given
    forward plane)."""
    seen = []

    def step(C, dy, dx, p1, p2, out, x=None, acc=None):
        seen.append(((dy, dx), out, x, acc))

    out = sgm.fold_paths(torch.zeros(shape, dtype=torch.uint8), groups,
                         int16, step, S)
    names = {out.data_ptr(): "S"}
    if S is not None and S.data_ptr() not in names:
        names[S.data_ptr()] = "F"

    def name(t):
        return None if t is None else names.setdefault(t.data_ptr(), "T")

    return [(d, name(o), name(x), name(a)) for d, o, x, a in seen]


def test_chain_folds_each_direction_into_s_and_t():
    """Eight paths: one launch a direction, S and one group-total plane T
    updated in place, no per-direction volume and no sum pass."""
    pen = {d: (1.0, 2.0) for d in sgm.DIRECTIONS_8}
    groups = sgm._groups(sgm.DIRECTIONS_8, pen, 8, 32, 1)
    assert _recorded_ops(groups, False) == [
        ((0, 1), "S", None, None), ((0, -1), "S", None, "S"),
        ((1, 0), "T", None, None), ((1, 1), "T", "T", None),
        ((1, -1), "S", "T", "S"),
        ((-1, 0), "T", None, None), ((-1, -1), "T", "T", None),
        ((-1, 1), "S", "T", "S")]
    # a group first: its last direction writes S = f(T + L)
    first = sgm._groups(((1, 0), (1, 1), (-1, 0)), pen, 8, 32, 1)
    assert _recorded_ops(first, True) == [
        ((1, 0), "T", None, None), ((1, 1), "S", "T", None),
        ((-1, 0), "S", None, "S")]


def test_lean_chain_starts_from_the_forward_plane():
    """float32 mode folds into the forward pass's plane in place; int16
    mode reads its int16 plane once into the int32 sum."""
    pen = {d: (1.0, 2.0) for d in sgm.DIRECTIONS_4}
    groups = sgm._groups(sgm.DIRECTIONS_4, pen, 8, 32, 1)[1:]
    f32 = torch.zeros((1, 8, 8, 32))
    assert _recorded_ops(groups, False, f32) == [
        ((0, -1), "S", None, "S"), ((1, 0), "S", None, "S"),
        ((-1, 0), "S", None, "S")]
    i16 = torch.zeros((1, 8, 8, 32), dtype=torch.int16)
    assert _recorded_ops(groups, True, i16) == [
        ((0, -1), "S", None, "F"), ((1, 0), "S", None, "S"),
        ((-1, 0), "S", None, "S")]
    # the forward pass alone: its int16 plane becomes the int32 sum
    S = sgm.fold_paths(torch.zeros((1, 8, 8, 32), dtype=torch.uint8), [],
                       True, sgm.sgm_volume_step_plain, i16 + 7)
    assert S.dtype == torch.int32 and bool((S == 7).all())
