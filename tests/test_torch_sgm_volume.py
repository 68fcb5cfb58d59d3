"""Torch port: volume SGM (the plain twin of the ``sgm_volume`` kernels,
TPU kernels H and I) against ``sgm_aggregate_pallas`` run in Pallas
interpret mode, the JAX package's aggregation as the TPU runs it, on the
same numpy volumes.

The twin pads the volume as the TPU does and keeps its summation order,
so it equals the reference bit for bit: below 1e9/2 and at the 1e9-level
entries alike (a parabolic subpixel next to an invalid disparity reads
those)."""

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
