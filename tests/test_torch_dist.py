"""Torch port of ``dist/``: the (data x spatial) mesh, the halo exchange,
the sharded matcher and pipeline step, the multi-process batch and the
scaling harness, on CPU meshes (a device may appear more than once in a
port mesh, which is how one CPU stands in for eight devices here).

The halo exchange is held bit-equal to the JAX package's ``ppermute``
form under ``shard_map`` on the 8 virtual CPU devices. The JAX sharded
matcher runs its default (XLA) SGM branch: the Pallas branches in
interpret mode do not trace under ``shard_map``, so the port is held to
it within 1e-3, as ``tests/test_torch_sgm_volume.py`` holds the twin to
the XLA reference; the port's own sharded and unsharded runs are held
bit-equal.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu_torch.config.params import (ALGORITHM_DEFAULTS, Algorithm,
                                                 PointCloudConfig)
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.dist.mesh import make_mesh
from i3dr_stereo_tpu_torch.dist.multihost import (gather_frames,
                                                  global_frame_batch,
                                                  measure_scaling)
from i3dr_stereo_tpu_torch.dist.sharded import (_crop_halo, _exchange_halo,
                                                make_sharded_matcher,
                                                make_sharded_pipeline_step)
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.matchers.registry import compute_disparity
from i3dr_stereo_tpu_torch.ops.depth import disparity_to_depth
from i3dr_stereo_tpu_torch.ops.rectify import make_rectify_map, rectify_pair

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _scene_batch(b, h, w, max_disp=16):
    scenes = [layered_scene(h, w, max_disp=max_disp, seed=i) for i in range(b)]
    L = np.stack([s.left for s in scenes])
    R = np.stack([s.right for s in scenes])
    return L, R, scenes


def _agreement(res_s, res_1, h, cuts, margin):
    d_s, d_1 = res_s.disparity.numpy(), res_1.disparity.numpy()
    v = res_s.valid.numpy() & res_1.valid.numpy()
    away = np.ones(h, bool)
    for cut in cuts:
        away[cut - margin:cut + margin] = False
    sel = v & away[None, :, None]
    return sel.mean(), (np.abs(d_s - d_1) < 1.0)[sel].mean()


def test_mesh_shapes():
    mesh = make_mesh(4, 2, CPU8)
    assert mesh.shape == {"data": 4, "spatial": 2}
    assert mesh.first == torch.device("cpu")
    assert make_mesh(devices=CPU8).shape == {"data": 8, "spatial": 1}
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        make_mesh(3, 3, CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="have 0"):
            make_mesh()


@pytest.mark.parametrize("halo", [0, 3, 8])
def test_exchange_and_crop_halo_match_reference(halo, cpu_devices):
    """Mesh 2x4 on random arrays: block i gets the last rows of block
    i-1 above and the first rows of block i+1 below, zeros at the ends,
    bit-equal to ``ppermute``; the crop gives the blocks back."""
    import jax
    from jax.sharding import PartitionSpec as P

    from i3dr_stereo_tpu.dist import sharded as ref
    from i3dr_stereo_tpu.dist.mesh import make_mesh as ref_mesh

    x = np.random.default_rng(halo).standard_normal((4, 32, 10)) \
        .astype(np.float32)
    spec = P("data", "spatial", None)
    ext = jax.jit(ref.shard_map(
        lambda a: ref._exchange_halo(a, halo, "spatial"),
        mesh=ref_mesh(2, 4), in_specs=(spec,), out_specs=spec))
    want = np.asarray(ext(x))
    t = torch.from_numpy(x)
    got, back = [], []
    for i in range(2):
        blocks = [t[2 * i:2 * i + 2, 8 * j:8 * j + 8] for j in range(4)]
        e = _exchange_halo(blocks, halo)
        got.append(torch.cat(e, 1))
        back.append(torch.cat([_crop_halo(b, halo, 4) for b in e], 1))
    assert want.shape == (4, 4 * (8 + 2 * halo), 10)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    assert torch.equal(torch.cat(back), t)
    if halo:
        assert not want[:2, :halo].any() and not want[:2, -halo:].any()


@pytest.fixture(scope="module")
def sgbm_cfg():
    from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS as REF
    from i3dr_stereo_tpu.config.params import Algorithm as RefAlg

    return REF[RefAlg.SGBM].replace(disparity_range=16, speckle_size=0)


def test_data_parallel_match_equals_single_and_reference(sgbm_cfg,
                                                         cpu_devices):
    from i3dr_stereo_tpu.dist.mesh import make_mesh as ref_mesh
    from i3dr_stereo_tpu.dist.sharded import make_sharded_matcher as ref_sm
    from i3dr_stereo_tpu_torch.convert import config_from_reference

    cfg = config_from_reference(sgbm_cfg)
    L, R, _ = _scene_batch(4, 64, 80)
    res_s = make_sharded_matcher(cfg, make_mesh(4, 1, CPU8), halo=0)(L, R)
    res_1 = compute_disparity(torch.from_numpy(L), torch.from_numpy(R), cfg)
    assert res_s.disparity.shape == (4, 64, 80)
    assert torch.equal(res_s.disparity, res_1.disparity)
    assert torch.equal(res_s.valid, res_1.valid)
    want = ref_sm(sgbm_cfg, ref_mesh(4, 1), halo=0)(L, R)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(res_s.valid.numpy(), v)
    assert 0.3 < v.mean() < 1.0
    np.testing.assert_allclose(res_s.disparity.numpy()[v],
                               np.asarray(want.disparity)[v], rtol=0,
                               atol=1e-3)


def test_spatial_sharding_matches_away_from_cuts():
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(disparity_range=16,
                                                     speckle_size=0,
                                                     disp12_max_diff=-1.0)
    L, R, _ = _scene_batch(2, 64, 80)
    mesh = make_mesh(2, 4, CPU8)  # 4-way row split: cuts at rows 16, 32, 48
    res_s = make_sharded_matcher(cfg, mesh, halo=8)(L, R)
    res_1 = compute_disparity(torch.from_numpy(L), torch.from_numpy(R), cfg)
    sel, agree = _agreement(res_s, res_1, 64, (16, 32, 48), 4)
    assert agree > 0.99


def test_spatial_sharding_pyramid_flagship():
    """The flagship pyramid under a 4-way row split at the reference
    test's gate (2 levels, a 32-row halo: rows more than 8 px from every
    cut agree with the unsharded run)."""
    cfg = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=64, max_pyramid_level=2, speckle_size=0)
    L, R, _ = _scene_batch(2, 256, 320, max_disp=48)
    mesh = make_mesh(2, 4, CPU8)  # cuts at rows 64, 128, 192
    res_s = make_sharded_matcher(cfg, mesh, halo=32)(L, R)
    res_1 = compute_disparity(torch.from_numpy(L), torch.from_numpy(R), cfg)
    sel, agree = _agreement(res_s, res_1, 256, (64, 128, 192), 8)
    assert sel > 0.5          # the comparison is not vacuous
    assert agree > 0.99


def test_sharded_matcher_checks_shapes():
    cfg = ALGORITHM_DEFAULTS[Algorithm.BM].replace(disparity_range=16)
    L = np.zeros((3, 64, 80), np.float32)
    with pytest.raises(ValueError, match="data shards"):
        make_sharded_matcher(cfg, make_mesh(2, 1, CPU8))(L, L)
    with pytest.raises(ValueError, match="row blocks"):
        make_sharded_matcher(cfg, make_mesh(1, 3, CPU8))(L[:1], L[:1])


def test_sharded_full_pipeline_runs():
    rig = StereoRig.synthetic(80, 64, fx=100.0)
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(disparity_range=16,
                                                     speckle_size=0)
    cloud = PointCloudConfig(depth_max=1000.0)
    step = make_sharded_pipeline_step(rig, cfg, cloud, make_mesh(2, 2, CPU8),
                                      halo=8)
    L, R, scenes = _scene_batch(2, 64, 80)
    out = step(L, R)
    assert set(out) == {"rect_left", "rect_right", "disparity", "valid",
                        "depth", "depth_valid"}
    for v in out.values():
        assert v.shape == (2, 64, 80)
    maps = [make_rectify_map(c, interpolation="linear", device="cpu")
            for c in (rig.left, rig.right)]
    rl, rr = rectify_pair(torch.from_numpy(L), torch.from_numpy(R), *maps)
    assert torch.equal(out["rect_left"], rl)
    assert torch.equal(out["rect_right"], rr)
    depth, dv = disparity_to_depth(
        out["disparity"], out["valid"],
        torch.as_tensor(rig.Q, dtype=torch.float32), 0.0, 1000.0)
    assert torch.equal(out["depth"], depth) and torch.equal(
        out["depth_valid"], dv)
    d = out["disparity"].numpy()
    v = out["valid"].numpy() & scenes[0].valid[None]
    err = np.abs(d - np.stack([s.disparity for s in scenes]))[v]
    assert np.median(err) < 1.0


def test_sharded_full_pipeline_flagship_pyramid():
    rig = StereoRig.synthetic(96, 128, fx=100.0)
    cfg = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=32, max_pyramid_level=2, speckle_size=20)
    cloud = PointCloudConfig(depth_max=1000.0)
    step = make_sharded_pipeline_step(rig, cfg, cloud, make_mesh(2, 2, CPU8),
                                      halo=16)
    L, R, scenes = _scene_batch(2, 128, 96, max_disp=24)
    out = step(L, R)
    assert out["disparity"].shape == (2, 128, 96)
    assert out["depth"].shape == (2, 128, 96)
    d = out["disparity"].numpy()
    v = out["valid"].numpy()
    gt = np.stack([s.disparity for s in scenes])
    gv = np.stack([s.valid for s in scenes])
    sel = v & gv
    assert sel.mean() > 0.4
    assert np.median(np.abs(d - gt)[sel]) < 1.0


def test_global_frame_batch_one_process():
    mesh = make_mesh(4, 1, CPU8)
    L = np.random.default_rng(0).uniform(0, 255, (8, 16, 24)) \
        .astype(np.float32)
    gl, gr = global_frame_batch(mesh, L, L.copy())
    assert gl.shape == (8, 16, 24) and gl.offset == 0
    assert len(gl.shards) == 4 and all(s.shape == (2, 16, 24)
                                       for s in gl.shards)
    np.testing.assert_array_equal(gl.local().numpy(), L)
    assert torch.equal(gather_frames(gr.local()), gr.local())
    # the sharded matcher takes the placed batch as it is
    cfg = ALGORITHM_DEFAULTS[Algorithm.BM].replace(disparity_range=16,
                                                   speckle_size=0)
    got = make_sharded_matcher(cfg, mesh, halo=0)(gl, gr)
    want = compute_disparity(torch.from_numpy(L), torch.from_numpy(L), cfg)
    assert torch.equal(got.disparity, want.disparity)


def test_measure_scaling_runs():
    cfg = ALGORITHM_DEFAULTS[Algorithm.BM].replace(disparity_range=16,
                                                   speckle_size=0)

    def factory(mesh):
        return make_sharded_matcher(cfg, mesh, halo=0)

    def make_batch(n):
        sc = layered_scene(32, 48, max_disp=8, background_disp=4)
        L = np.stack([sc.left] * (2 * n))
        R = np.stack([sc.right] * (2 * n))
        return L, R

    res = measure_scaling(factory, make_batch, [1, 2, 4, 16], iters=2,
                          devices=CPU8)
    assert set(res) == {1, 2, 4}
    for n, row in res.items():
        assert row["devices"] == n and row["frames_per_s"] > 0
    assert res[1]["efficiency"] == 1.0


def test_two_process_global_frame_batch(tmp_path):
    """Two real processes under ``torch.distributed`` (gloo): each keeps
    its own frames, and only the per-frame results are gathered — the
    counterpart of tests/test_runner_multihost.py's two-process test."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    out = tmp_path / "mh.json"
    worker = os.path.join(os.path.dirname(__file__),
                          "_torch_multihost_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(i), str(port),
                               str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for i in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = json.loads(out.read_text())
    assert res == {"ok": True, "processes": 2, "frames": 8}


if __name__ == "__main__":
    # python tests/test_torch_dist.py H W MAX_DISP D: the flagship pyramid
    # (4 levels, bench.py:_flagship_cfg but D) on one layered scene, split
    # 1x4 on the CPU with a 64-row halo: the share of pixels valid in both
    # runs and more than 16 rows from every cut that agree within 1 px
    # with the unsharded run, and the same by bands of 8 rows from a cut
    h, w, max_disp, d = (int(x) for x in sys.argv[1:5])
    torch.set_num_threads(os.cpu_count())
    cfg = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=d, max_pyramid_level=4, speckle_size=100,
        speckle_downsample=2, median_filter=True)
    sc = layered_scene(h, w, max_disp=max_disp,
                       background_disp=max(1, max_disp // 12), layers=6,
                       seed=1)
    L, R = (torch.from_numpy(np.clip(np.rint(x), 0, 255).astype(np.uint8))[None]
            for x in (sc.left, sc.right))
    one = compute_disparity(L, R, cfg)
    split = make_sharded_matcher(cfg, make_mesh(1, 4, ["cpu"] * 4),
                                 halo=64)(L, R)
    rows = np.abs(np.arange(h)[:, None]
                  - np.array([h // 4 * k for k in (1, 2, 3)])[None]).min(1)
    v = (one.valid & split.valid).numpy()[0]
    ok = ((one.disparity - split.disparity).abs() < 1.0).numpy()[0]
    print(f"{w}x{h}, D {d}: {ok[v & (rows > 16)[:, None]].mean():.6f} "
          f"agree more than 16 rows from the cuts; by rows from a cut "
          + ", ".join(f"{b}-{b + 7}: "
                      f"{ok[v & ((rows >= b) & (rows < b + 8))[:, None]].mean():.6f}"
                      for b in range(0, 64, 8)))
