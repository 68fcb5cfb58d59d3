"""Torch port: TSDF fusion (``mapping/tsdf.py``) against the JAX package
on the same seeded inputs.

The reference's update (``mapping/tsdf.py:_integrate``) is XLA, not a
Pallas kernel, so it runs as it is. XLA's CPU backend contracts its
multiply-adds into FMAs (ROADMAP Queue 3); the twin rounds every
operation on its own, as the ``tsdf_integrate`` kernel does (kernel and
twin are held bit-equal on the card by ``chip_smoke.py``). So, measured on
the CPU and asserted below:

- ``weight`` is equal (on every voxel here) and ``tsdf`` within
  ``TSDF_ATOL`` (measured 6.6e-7) off the voxels at a rounding edge: a
  projection within 1e-4 of a half-integer, or an sdf within 1e-5 of
  -trunc, where an FMA may round the other way (2-3 of the 1451-2977
  seen voxels after each frame; asserted to be under 1 %);
- the outputs (``occupied_points``, ``occupancy_grid``) of one state are
  identical in both packages;
- a map the JAX volume started and both packages continue with the same
  frame stays within ``TSDF_ATOL``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from i3dr_stereo_tpu.mapping import odometry as jodo
from i3dr_stereo_tpu.mapping import tsdf as jtsdf
from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.convert import tsdf_from_reference
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.mapping import TSDFVolume, make_map_consumer
from i3dr_stereo_tpu_torch.mapping import tsdf as ptsdf

torch.set_num_threads(2)

TSDF_ATOL = 5e-6          # tsdf, twin vs reference (measured 6.6e-7)
SHAPE = (32, 28, 24)
VOXEL = 0.125
ORIGIN = np.array((-2.0, -1.5, 0.25), np.float32)
H, W = 64, 80
K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)


def _frames(n=3, seed=0):
    """Seeded depth maps (0.5-4 m, 10 % holes) and world->camera poses,
    the last of them leaving most of the grid behind the camera."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
        d[rng.random((H, W)) < 0.1] = 0.0
        T = np.array(jodo._se3_exp(rng.normal(0, 0.15, 6).astype(
            np.float32)), np.float32)
        if i == n - 1:
            T[2, 3] -= 2.5
        out.append((d, T))
    return out


def _edges(d, T):
    """Voxels whose projection lies within 1e-4 px of a half-integer or
    whose sdf lies within 1e-5 of -trunc (float64 geometry)."""
    i, j, k = np.meshgrid(*[np.arange(n) for n in SHAPE], indexing="ij")
    w = [ORIGIN[a] + (idx + 0.5) * VOXEL for a, idx in enumerate((i, j, k))]
    c = [T[r, 0] * w[0] + T[r, 1] * w[1] + T[r, 2] * w[2] + T[r, 3]
         for r in range(3)]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K[0, 0] * c[0] / c[2] + K[0, 2]
        v = K[1, 1] * c[1] / c[2] + K[1, 2]
    edge = np.zeros(SHAPE, bool)
    for x in (u, v):
        edge |= np.abs(x - np.floor(x) - 0.5) < 1e-4
    ui = np.clip(np.nan_to_num(np.round(u), nan=0), 0, W - 1).astype(int)
    vi = np.clip(np.nan_to_num(np.round(v), nan=0), 0, H - 1).astype(int)
    sdf = d[vi, ui] - c[2]
    edge |= np.abs(sdf + 3 * VOXEL) < 1e-5
    return edge


@pytest.fixture(scope="module")
def fused():
    """Both packages' (tsdf, weight) after each of three frames, and the
    voxels at a rounding edge so far."""
    tj = wj = jnp.zeros(SHAPE, jnp.float32)
    tp = wp = torch.zeros(SHAPE)
    edge = np.zeros(SHAPE, bool)
    out = []
    for d, T in _frames():
        tj, wj = jtsdf._integrate(tj, wj, jnp.asarray(d), jnp.asarray(K),
                                  jnp.asarray(T), jnp.asarray(ORIGIN),
                                  jnp.float32(VOXEL), trunc_vox=3)
        tp, wp = ptsdf.integrate(tp, wp, torch.from_numpy(d), K, T, ORIGIN,
                                 VOXEL, 3)
        edge |= _edges(d, T)
        out.append((np.asarray(tj), np.asarray(wj), tp.numpy(), wp.numpy(),
                    edge.copy()))
    return out


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_integrate_twin_matches_reference(fused, frame):
    tj, wj, tp, wp, edge = fused[frame]
    seen = wj > 0
    assert seen.sum() > 1000
    assert edge[seen].mean() < 0.01
    off = ~edge
    np.testing.assert_array_equal(wp[off], wj[off])
    np.testing.assert_allclose(tp[off], tj[off], rtol=0, atol=TSDF_ATOL)
    assert np.isfinite(tp).all()


def test_integrate_twin_rewrites_unseen_voxels(fused):
    """The last frame sees almost nothing; every voxel a frame does not see
    keeps its weight and its running average (to an ulp, as the
    reference's (t * w + 0) / w)."""
    tj1, wj1, tp1, wp1, _ = fused[1]
    tj2, wj2, tp2, wp2, _ = fused[2]
    unseen = wp2 == wp1
    assert unseen.mean() > 0.9
    np.testing.assert_allclose(tp2[unseen], tp1[unseen], rtol=0,
                               atol=1e-6)


def test_outputs_match_reference(fused):
    """One state, both packages' outputs: identical points and grid."""
    tj, wj, _, _, _ = fused[1]
    ref = jtsdf.TSDFVolume(shape=SHAPE, voxel_size=VOXEL,
                           origin=tuple(ORIGIN))
    ref.tsdf, ref.weight = jnp.asarray(tj), jnp.asarray(wj)
    ref.frames_integrated = 2
    port = tsdf_from_reference(ref, device="cpu")
    assert port.frames_integrated == 2 and port.shape == SHAPE
    pts = port.occupied_points()
    assert len(pts) > 100
    np.testing.assert_array_equal(pts, ref.occupied_points())
    np.testing.assert_array_equal(port.occupancy_grid(),
                                  ref.occupancy_grid())
    for kw in (dict(band=0.2), dict(min_weight=2.0)):
        np.testing.assert_array_equal(port.occupied_points(**kw),
                                      ref.occupied_points(**kw))


def test_map_started_in_jax_continues_in_the_port():
    """tsdf_from_reference carries a JAX map across; both packages
    continue it with the same frame and stay within TSDF_ATOL."""
    (d0, T0), (d1, T1), _ = _frames(seed=3)
    ref = jtsdf.TSDFVolume(shape=SHAPE, voxel_size=VOXEL,
                           origin=tuple(ORIGIN))
    ref.integrate(d0, K, T0)
    ref.integrate(d1, K, T1)
    port = tsdf_from_reference(ref, device="cpu")
    np.testing.assert_array_equal(port.tsdf.numpy(), np.asarray(ref.tsdf))
    ref.integrate(d1, K)
    port.integrate(d1, K)
    assert port.frames_integrated == ref.frames_integrated == 3
    edge = _edges(d1, np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(port.weight.numpy()[~edge],
                                  np.asarray(ref.weight)[~edge])
    np.testing.assert_allclose(port.tsdf.numpy()[~edge],
                               np.asarray(ref.tsdf)[~edge], rtol=0,
                               atol=TSDF_ATOL)


def test_tsdf_integrates_flat_wall():
    vol = TSDFVolume(shape=(32, 32, 32), voxel_size=0.125,
                     origin=(-2.0, -2.0, 0.0), device="cpu")
    Hw, Ww = 64, 80
    Kw = np.array([[100.0, 0, Ww / 2], [0, 100.0, Hw / 2], [0, 0, 1]],
                  np.float32)
    depth = np.full((Hw, Ww), 2.0, np.float32)        # wall at z = 2 m
    for _ in range(3):
        vol.integrate(depth, Kw)
    assert vol.frames_integrated == 3
    pts = vol.occupied_points()
    assert len(pts) > 0
    assert np.abs(pts[:, 2] - 2.0).max() <= 2 * 0.125
    assert float(vol.weight.max()) >= 3.0
    assert vol.occupancy_grid().any()


def test_tsdf_pose_moves_surface():
    """A camera translated +0.5 m along z sees the wall 0.5 m closer;
    with the pose supplied, the fused surface stays at the world z."""
    vol = TSDFVolume(shape=(32, 32, 32), voxel_size=0.125,
                     origin=(-2.0, -2.0, 0.0), device="cpu")
    Hw, Ww = 64, 80
    Kw = np.array([[100.0, 0, Ww / 2], [0, 100.0, Hw / 2], [0, 0, 1]],
                  np.float32)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.5                              # z_c = z_w - 0.5
    vol.integrate(np.full((Hw, Ww), 1.5, np.float32), Kw, T)
    pts = vol.occupied_points()
    assert len(pts) > 0
    assert np.abs(pts[:, 2] - 2.0).max() <= 2 * 0.125


def test_map_consumer_through_processing_graph():
    """Stereo frames -> the port's matcher graph -> points2 -> the
    map_consumer hook -> a TSDF volume holding the scene's surfaces."""
    from i3dr_stereo_tpu_torch.bridge.launch import launch_processing

    rig = StereoRig.synthetic(96, 80, fx=100.0, baseline_m=0.3)
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(disparity_range=16,
                                                     speckle_size=0)
    vol = TSDFVolume(shape=(40, 40, 40), voxel_size=0.2,
                     origin=(-4.0, -4.0, 0.0), device="cpu")
    lg = launch_processing(rig, stereo_algorithm=Algorithm.SGBM,
                           config=cfg, rectify_inputs=False,
                           with_crop=False, warmup=False,
                           map_consumer=make_map_consumer(vol, rig),
                           device="cpu")
    sc = layered_scene(80, 96, max_disp=12, background_disp=8)
    for t in (0.0, 0.2):
        lg.graph.publish("/stereo/left/image_raw", t, sc.left)
        lg.graph.publish("/stereo/right/image_raw", t, sc.right)
    assert vol.frames_integrated == 2
    z = vol.occupied_points()[:, 2]
    assert len(z) > 0
    # the background plane, Z = fx * B / d = 100 * 0.3 / 8 = 3.75 m, is
    # among the fused surfaces, and nothing lies beyond it + truncation
    assert (np.abs(z - 3.75) < 0.45).any()
    assert z.max() <= 3.75 + 3 * 0.2 + 0.2


# the stereo-fed map of chip_smoke.py:map_stereo_fed: the flagship config
# (bench.py:_flagship_cfg) on the ideal rig, fx 580 and B 0.3, over
# layered_scene, whose background plane lies at 580 * 0.3 / 16 = 10.875 m;
# the voxel is 0.025 m and the truncation 3 voxels
PLANE_M = 580.0 * 0.3 / 16
BEYOND_M = PLANE_M + 3 * 0.025 + 0.025
# the TPU's branches of the JAX pipeline, Pallas in interpret mode
TPU_BRANCHES = {"I3DR_SGM_BACKEND": "pallas_t_interpret",
                "I3DR_SPECKLE_BACKEND": "pallas_interpret",
                "I3DR_REMAP_BACKEND": "gather"}


def flagship_depth(H, W, max_disp, port):
    """Depth and its validity of one flagship frame of (H, W) through the
    port's StereoPipeline on the CPU (``port``) or the JAX package's (run
    with ``TPU_BRANCHES`` set)."""
    if port:
        from i3dr_stereo_tpu_torch.config import params
        from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import (
            StereoPipeline)
        rig, kw = StereoRig, dict(device="cpu")
    else:
        from i3dr_stereo_tpu.config import params
        from i3dr_stereo_tpu.core.camera import StereoRig as rig
        from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline
        kw = {}
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM].replace(
        disparity_range=256, max_pyramid_level=4, speckle_size=100,
        speckle_downsample=2, median_filter=True)
    pipe = StereoPipeline(
        rig.synthetic(W, H, fx=580.0, baseline_m=0.3), cfg,
        params.PointCloudConfig(depth_max=100.0, depth_min=0.5), **kw)
    sc = layered_scene(H, W, max_disp=max_disp, background_disp=16,
                       layers=6, seed=1)
    res = pipe.process(np.clip(sc.left, 0, 255).astype(np.uint8),
                       np.clip(sc.right, 0, 255).astype(np.uint8))
    return np.asarray(res.depth), np.asarray(res.depth_valid)


def behind_plane(depth, valid):
    """Valid depth pixels beyond the plane plus the truncation and a voxel,
    and the deepest of them."""
    z = depth[valid & (depth > BEYOND_M)]
    return len(z), float(z.max()) if len(z) else None


def test_flagship_depth_behind_the_plane_is_the_references():
    """The matcher puts some valid depth beyond the background plane: the
    port's depth is the JAX pipeline's, pixel for pixel, those included."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TPU_BRANCHES.items():
            mp.setenv(k, v)
        ref = flagship_depth(128, 160, 64, port=False)
    port = flagship_depth(128, 160, 64, port=True)
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0][ref[1]], ref[0][ref[1]], rtol=1e-6)
    n, deepest = behind_plane(*ref)
    assert n > 0 and behind_plane(*port) == (n, deepest)


@pytest.mark.parametrize("entry", ["TSDFVolume", "tsdf_from_reference"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` the volume lives on the card; with no card it
    raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ref = jtsdf.TSDFVolume(shape=(4, 4, 4))
    make = {"TSDFVolume": lambda: TSDFVolume(shape=(4, 4, 4)),
            "tsdf_from_reference": lambda: tsdf_from_reference(ref)}
    with pytest.raises(RuntimeError, match="CUDA"):
        make[entry]()


if __name__ == "__main__":
    # python tests/test_torch_mapping.py H W: the flagship frame's depth
    # beyond the plane in both packages at (H, W) over chip_smoke.py's scene
    # (max_disp 200), with JAX_PLATFORMS=cpu and the repo on PYTHONPATH
    import os
    import sys
    import time

    H_, W_ = int(sys.argv[1]), int(sys.argv[2])
    os.environ.update(TPU_BRANCHES)
    for name in ("port", "JAX"):
        t0 = time.perf_counter()
        d, v = flagship_depth(H_, W_, 200, port=name == "port")
        n, deepest = behind_plane(d, v)
        print(f"{name} {W_}x{H_}: {n} of {int(v.sum())} valid depth pixels "
              f"beyond {BEYOND_M:.4f} m ({n / v.sum():.4%}), deepest "
              f"{deepest} m; {int((v & (d > 12.8)).sum())} beyond the "
              f"512^3 x 0.025 m volume's 12.8 m "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
