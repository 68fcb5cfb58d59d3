"""Torch port: depth odometry (``mapping/odometry.py``, projective
point-to-plane ICP) against the JAX package on the same inputs.

The reference's tracker is XLA, not a Pallas kernel, so it runs as it is;
the port's CPU path is the plain torch twin of the ``icp_step`` kernel
(held against the kernel on the card by ``chip_smoke.py``). Measured on
the CPU and asserted below:

- ``render_plane_depth``, the depth pyramid, the level intrinsics and the
  back-projection are bit-equal;
- ``_se3_exp`` within ``SE3_ATOL`` (measured 0 on these inputs);
- normals within ``NORMAL_ATOL`` (measured 1.8e-7, XLA's FMAs) with equal
  validity off the 1-pixel border; on the border the port's normals are
  not valid (the reference's ``jnp.roll`` wraps there, a fault the port
  repairs, ROADMAP Queue 3);
- one level of ICP given both packages the same maps (the reference's
  normals and validity, wrapped border included): the pose within
  ``ICP_ATOL`` (measured 7.0e-7 after one step, 7.6e-8 after four), rmse
  and inlier fraction within 1e-6 relative;
- ``estimate_motion`` recovers the reference test's four motions at its
  gates (5 mm, 0.25 deg, inlier share > 0.3), and agrees with the
  reference within ``MOTION_T_ATOL`` / ``MOTION_R_DEG`` (measured 2.4e-4
  m and 8.6e-3 deg; rmse within 3.7e-5 m, the inlier share lower by up to
  2.2 %): the border pixels the repair drops move the estimate that far
  (with the reference's wrapped normals the port agrees within 2.6e-7 m);
- the moving-rig trajectory and map tests of the reference pass on the
  port at the reference's gates; the trajectory stays within
  ``TRAJ_T_ATOL`` / ``TRAJ_R_DEG`` of the reference's (measured 9.2e-4 m
  and 0.021 deg after 7 steps), the ground-truth map equals the
  reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from i3dr_stereo_tpu.mapping import odometry as jodo
from i3dr_stereo_tpu.mapping.tsdf import TSDFVolume as JTSDFVolume
from i3dr_stereo_tpu_torch.mapping import (
    DepthOdometry,
    TSDFVolume,
    estimate_motion,
    render_plane_depth,
)
from i3dr_stereo_tpu_torch.mapping import odometry as podo

torch.set_num_threads(2)

SE3_ATOL = 1e-7
NORMAL_ATOL = 1e-6        # measured 1.8e-7
ICP_ATOL = 5e-6           # pose entries after one level (measured 7.0e-7)
MOTION_T_ATOL = 5e-4      # m, port vs reference (measured 2.4e-4)
MOTION_R_DEG = 0.02       # deg, port vs reference (measured 8.6e-3)
TRAJ_T_ATOL = 2e-3        # m, 7-step trajectory (measured 9.2e-4)
TRAJ_R_DEG = 0.05         # deg, 7-step trajectory (measured 0.021)

H, W = 120, 160
K = np.array([[140.0, 0.0, 80.0], [0.0, 140.0, 60.0], [0.0, 0.0, 1.0]],
             np.float32)
# the reference test's room patch: all 6 DoF observable
SCENE = [
    ((0.0, 0.0, 3.0), (0.0, 0.0, -1.0), (3.0, 3.0, 0.01)),       # back wall
    ((-1.0, 0.0, 2.2), (1.0, 0.0, -0.7), (0.6, 1.6, 0.7)),       # tilted left
    ((0.0, 0.9, 2.0), (0.0, -1.0, -0.4), (1.8, 0.5, 0.9)),       # tilted floor
    ((0.45, -0.25, 1.6), (0.0, 0.0, -1.0), (0.35, 0.25, 0.01)),  # near box
]
MOTIONS = [
    dict(tx=0.03),
    dict(tz=0.05),
    dict(ry=np.radians(1.5)),
    dict(tx=0.02, ty=-0.015, tz=0.03, rx=np.radians(0.8),
         ry=np.radians(-1.0), rz=np.radians(0.5)),
]


def _pose(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0):
    return np.array(jodo._se3_exp(np.array([rx, ry, rz, tx, ty, tz],
                                           np.float32)), np.float32)


def _rot_err_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def _rot_diff_deg(Ra, Rb):
    """The angle between two nearby rotations from their Frobenius
    distance in float64 (arccos of a float32 trace cannot resolve angles
    below ~0.03 deg)."""
    f = np.linalg.norm(Ra.astype(np.float64) - Rb.astype(np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, f / (2 * np.sqrt(2)))))


@pytest.fixture(scope="module")
def motions():
    """Per motion: the ground truth, both depths and the reference's
    estimate (T_pc, diagnostics)."""
    d1 = render_plane_depth(K, np.eye(4), SCENE, H, W)
    out = []
    for m in MOTIONS:
        T_wc2 = _pose(**m)
        d2 = render_plane_depth(K, T_wc2, SCENE, H, W)
        out.append((T_wc2, d1, d2, jodo.estimate_motion(d1, d2, K)))
    return out


def test_render_plane_depth_bit_equal():
    for m in MOTIONS:
        T = _pose(**m)
        np.testing.assert_array_equal(
            render_plane_depth(K, T, SCENE, H, W),
            jodo.render_plane_depth(K, T, SCENE, H, W))


def test_se3_exp_matches_reference():
    rng = np.random.default_rng(5)
    xis = [np.zeros(6), np.array([0, 0, 0, 0.1, -0.2, 0.3]),
           np.array([0, 0, np.pi / 2, 0, 0, 0]),
           np.array([1e-9, 0, 0, 0.01, 0, 0]),
           *rng.normal(0, 0.3, (4, 6))]
    for xi in xis:
        xi = xi.astype(np.float32)
        np.testing.assert_allclose(podo._se3_exp(torch.from_numpy(xi)),
                                   np.asarray(jodo._se3_exp(xi)), rtol=0,
                                   atol=SE3_ATOL)


def test_pyramid_and_backprojection_bit_equal(motions):
    _, d1, d2, _ = motions[3]
    dj, dp = jnp.asarray(d2), torch.from_numpy(d2)
    Kj = jnp.asarray(K)
    for li in range(3):
        if li:
            dj, dp = jodo._downsample_depth(dj), podo._downsample_depth(dp)
            np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
        s = 2.0 ** li
        Klj = jnp.array([[Kj[0, 0] / s, 0.0, (Kj[0, 2] + 0.5) / s - 0.5],
                         [0.0, Kj[1, 1] / s, (Kj[1, 2] + 0.5) / s - 0.5],
                         [0.0, 0.0, 1.0]])
        Kl = podo.level_intrinsics(K, li)
        np.testing.assert_array_equal(Kl, np.asarray(Klj))
        np.testing.assert_array_equal(
            podo._backproject(dp, torch.from_numpy(Kl)).numpy(),
            np.asarray(jodo._backproject(dj, Klj)))


def test_normals_off_border_and_border_invalid(motions):
    _, _, d2, _ = motions[3]
    Vj = jodo._backproject(jnp.asarray(d2), jnp.asarray(K))
    nj, okj = (np.asarray(x) for x in jodo._normals(Vj, jnp.asarray(d2) > 0))
    n, ok = podo._normals(torch.from_numpy(np.array(Vj)),
                          torch.from_numpy(d2) > 0)
    n, ok = n.numpy(), ok.numpy()
    inner = (slice(1, -1), slice(1, -1))
    np.testing.assert_array_equal(ok[inner], okj[inner])
    np.testing.assert_allclose(n[inner], nj[inner], rtol=0, atol=NORMAL_ATOL)
    border = np.ones((H, W), bool)
    border[inner] = False
    assert not ok[border].any()
    assert okj[border].sum() > 300           # where the reference wraps
    assert np.isfinite(n).all()


@pytest.mark.parametrize("iters", [1, 4])
def test_icp_level_matches_reference(motions, iters):
    """Both packages given the same maps (the reference's normals and
    validity): one level's pose, rmse and inlier fraction."""
    _, d1, d2, _ = motions[3]
    dp, dc = jnp.asarray(d1), jnp.asarray(d2)
    Kj = jnp.asarray(K)
    Vp, Vc = jodo._backproject(dp, Kj), jodo._backproject(dc, Kj)
    Np, okp = jodo._normals(Vp, dp > 0)
    okp = okp & (dp > 0)
    Tj, rj, fj = jodo._icp_level(Vp, Np, okp, Vc, dc > 0, Kj, jnp.eye(4),
                                 iters, 0.5)

    def pack(*fields):
        return torch.from_numpy(np.concatenate(
            [np.asarray(f, np.float32).reshape(H, W, -1) for f in fields],
            -1)).clone()

    state = torch.zeros(podo.STATE)
    state[:16] = torch.eye(4).reshape(-1)
    state = podo._icp_level((None, pack(Vp, dp > 0, Np, okp)),
                            (pack(Vc, dc > 0), None),
                            (K[0, 0], K[1, 1], K[0, 2], K[1, 2]), state,
                            iters, 0.5)
    np.testing.assert_allclose(state[:16].reshape(4, 4).numpy(),
                               np.asarray(Tj), rtol=0, atol=ICP_ATOL)
    np.testing.assert_allclose(float(state[16]), float(rj), rtol=1e-6)
    np.testing.assert_allclose(float(state[17]), float(fj), rtol=1e-6)


@pytest.mark.parametrize("motion", range(len(MOTIONS)))
def test_estimate_motion_recovers_pose(motions, motion):
    T_wc2, d1, d2, (Tj, dj) = motions[motion]
    T_pc, diag = estimate_motion(d1, d2, K, device="cpu")
    assert np.linalg.norm(T_pc[:3, 3] - T_wc2[:3, 3]) < 0.005, diag
    assert _rot_err_deg(T_pc[:3, :3], T_wc2[:3, :3]) < 0.25, diag
    assert diag["inlier_frac"] > 0.3
    # against the reference's estimate
    assert np.linalg.norm(T_pc[:3, 3] - Tj[:3, 3]) < MOTION_T_ATOL
    assert _rot_diff_deg(T_pc[:3, :3], Tj[:3, :3]) < MOTION_R_DEG
    assert abs(diag["rmse"] - dj["rmse"]) < 1e-4
    assert 0 <= dj["inlier_frac"] - diag["inlier_frac"] < 0.03


def test_trajectory_ate_under_one_voxel():
    """8-pose sweep: the composed odometry's absolute trajectory error
    stays below one TSDF voxel (5 cm), and each pose near the reference
    tracker's."""
    rng = np.random.default_rng(7)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(7):
        step = _pose(tx=0.025 + rng.normal(0, 0.004),
                     ty=rng.normal(0, 0.004),
                     tz=0.02 + rng.normal(0, 0.004),
                     ry=np.radians(0.7 + rng.normal(0, 0.1)),
                     rx=np.radians(rng.normal(0, 0.1)))
        poses.append((poses[-1] @ step).astype(np.float32))
    odo, ref = DepthOdometry(K=K, device="cpu"), jodo.DepthOdometry(K=K)
    est, est_ref = [], []
    for T_wc in poses:
        d = render_plane_depth(K, T_wc, SCENE, H, W)
        est.append(odo.track(d).copy())
        est_ref.append(ref.track(d).copy())
    ate = [np.linalg.norm(e[:3, 3] - g[:3, 3]) for e, g in zip(est, poses)]
    assert max(ate) < 0.05, ate
    rerrs = [_rot_err_deg(e[:3, :3], g[:3, :3]) for e, g in zip(est, poses)]
    assert max(rerrs) < 1.0, rerrs
    for e, r in zip(est, est_ref):
        assert np.linalg.norm(e[:3, 3] - r[:3, 3]) < TRAJ_T_ATOL
        assert _rot_diff_deg(e[:3, :3], r[:3, :3]) < TRAJ_R_DEG


def test_map_from_estimated_poses_matches_gt_map():
    """TSDF fused with ICP poses ~= TSDF fused with ground-truth poses,
    and the port's ground-truth map equals the reference's."""
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(5):
        poses.append((poses[-1] @ _pose(tx=0.03, tz=0.025,
                                        ry=np.radians(0.8))).astype(
                                            np.float32))
    depths = [render_plane_depth(K, T, SCENE, H, W) for T in poses]

    def fuse(pose_list, cls=TSDFVolume, **kw):
        vol = cls(shape=(64, 64, 64), voxel_size=0.08,
                  origin=(-2.0, -2.0, 0.0), **kw)
        for d, T_wc in zip(depths, pose_list):
            vol.integrate(d, K, np.linalg.inv(T_wc).astype(np.float32))
        return vol

    odo = DepthOdometry(K=K, device="cpu")
    est = [odo.track(d).copy() for d in depths]
    occ_gt = fuse(poses, device="cpu").occupancy_grid()
    occ_est = fuse(est, device="cpu").occupancy_grid()
    inter = (occ_gt & occ_est).sum()
    union = (occ_gt | occ_est).sum()
    assert union > 0
    assert inter / union > 0.8, inter / union
    np.testing.assert_array_equal(occ_gt, fuse(poses, JTSDFVolume)
                                  .occupancy_grid())


def test_icp_step_state_and_reruns(motions):
    """The twin's state layout (A symmetric and positive on its diagonal,
    b, the two sums) and identical poses on a rerun."""
    _, d1, d2, _ = motions[0]
    prev = podo.pack_maps(torch.from_numpy(d1), K, 1)[0]
    cur = podo.pack_maps(torch.from_numpy(d2), K, 1)[0]
    cam = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    state = torch.zeros(podo.STATE)
    state[:16] = torch.eye(4).reshape(-1)
    a = podo.icp_step(cur[0], prev[1], cam, state, 0.5)
    b = podo.icp_step(cur[0], prev[1], cam, state, 0.5)
    assert torch.equal(a, b)
    A = a[18:54].reshape(6, 6)
    assert torch.equal(A, A.T) and bool((A.diagonal() > 0).all())
    sw = float(a[61])
    assert sw == round(sw) and 0.3 * H * W < sw <= H * W
    assert float(a[17]) == pytest.approx(sw / (H * W), rel=1e-6)
    assert float(a[16]) == pytest.approx((float(a[60]) / sw) ** 0.5,
                                         rel=1e-6)


@pytest.mark.parametrize("entry", ["DepthOdometry", "estimate_motion"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` the tracker runs on the card; with no card it
    raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = np.ones((8, 8), np.float32)
    make = {"DepthOdometry": lambda: DepthOdometry(K=K),
            "estimate_motion": lambda: estimate_motion(d, d, K)}
    with pytest.raises(RuntimeError, match="CUDA"):
        make[entry]()
