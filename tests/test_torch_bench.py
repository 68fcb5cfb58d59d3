"""Torch port of ``cli bench``: the bench module's inputs against the root
``bench.py``'s, ``sgm_direct_2448``'s function against the same lines
built from the JAX package's ops, and every configuration run on the CPU
at a small shape through ``bench.run`` and ``cli.main``.

The root script imports JAX inside its functions, but enables JAX's
persistent compile cache when it is imported; the fixture puts those
settings back."""

import functools
import json

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu_torch import bench, cli
from i3dr_stereo_tpu_torch.convert import config_from_reference

torch.set_num_threads(2)

KEYS = {"metric", "value", "unit", "vs_baseline", "device", "ms_events",
        "peak_gib", "iters", "launches", "size"}
# the root script's metric names
METRICS = {
    "flagship": "sgm_disparity_fps_2448x2048_256d_per_chip",
    "e2e_2448": "e2e_fps_2448x2048_ingest_rectify_pyramidSGM_depth",
    "flagship_flat": "sgm_disparity_fps_2448x2048_256d_flat",
    "sgbm_1280": "sgbm8_fps_1280x1024_128d",
    "bm_640": "bm_fps_640x480_64d",
    "pipeline_batch": "fused_pipeline_fps_640x480_64d_stream32x16",
    "sgm_direct_2448": "sgm_direct_bruteforce_fps_2448x2048_256d",
    "stages": "stages_sum_L0_ms",
}
STAGES = ("block_shift_warp", "census_transform_pair_9x9", "census_cost",
          "sgm_sweep_fwd", "sgm_sweep_rev", "sgm_sweep_down",
          "sgm_sweep_up_wta", "true_backmatch_wta", "speckle_ds2",
          "median3x3", "median3x3_masked", "rectify_cubic",
          "rectify_cubic_u8", "pyramid_resizes")


def _small_pair(h, w, seed=1):
    return bench._layered_pair(h, w, max_disp=20, seed=seed)


# each configuration at a shape the CPU runs in seconds
SMALL = {
    "flagship": dict(pair=_small_pair, size=(64, 96), iters=1),
    "e2e_2448": dict(pair=_small_pair, size=(64, 96), n=1, iters=1),
    "flagship_flat": dict(size=(64, 160), iters=1),
    "sgbm_1280": dict(size=(32, 160), iters=1),
    "bm_640": dict(size=(32, 96), iters=1),
    "pipeline_batch": dict(batch=2, size=(32, 96), iters=1),
    "sgm_direct_2448": dict(size=(32, 64), disparities=16, iters=1),
    "stages": dict(pair=_small_pair, size=(64, 96), iters=1),
}


@pytest.fixture(scope="module")
def root_bench():
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    import bench as root

    for k, v in saved.items():
        jax.config.update(k, v)
    return root


def _small(monkeypatch, name, **kw):
    monkeypatch.setitem(bench.BENCHES, name, functools.partial(
        bench.BENCHES[name], **{**SMALL[name], **kw}))


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.strip()]


@pytest.mark.parametrize("h,w,kw", [(48, 64, {}), (33, 70, dict(max_disp=40,
                                                                seed=3))])
def test_synthetic_pair_equals_the_root_bench(root_bench, h, w, kw):
    for a, b in zip(bench._synthetic_pair(h, w, **kw),
                    root_bench._synthetic_pair(h, w, **kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w,kw", [(40, 320, {}), (48, 96, dict(max_disp=20,
                                                                 seed=5))])
def test_layered_pair_equals_the_root_bench(root_bench, h, w, kw):
    for a, b in zip(bench._layered_pair(h, w, **kw),
                    root_bench._layered_pair(h, w, **kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_flagship_cfg_and_distorted_rig_equal_the_root_bench(root_bench):
    """The flagship config field by field; the distorted rig of the root
    script's ``e2e_2448`` rebuilt from its lines (``cv2.Rodrigues``):
    intrinsics, distortion and projections equal, rotations within
    1e-15 (a closed form against OpenCV's)."""
    import cv2

    assert bench._flagship_cfg() == config_from_reference(
        root_bench._flagship_cfg())
    rig = bench.distorted_rig()
    rots = (cv2.Rodrigues(np.array([0.004, -0.006, 0.002]))[0],
            cv2.Rodrigues(np.array([-0.003, 0.005, -0.002]))[0])
    Pr = np.array([[2380.0, 0, 1220.0, -2380.0 * 0.3],
                   [0, 2380.0, 1022.0, 0], [0, 0, 1, 0]])
    for cam, R, P in ((rig.left, rots[0], Pr * [1, 1, 1, 0]),
                      (rig.right, rots[1], Pr)):
        assert (cam.width, cam.height) == (2448, 2048)
        np.testing.assert_array_equal(cam.K, [[2400.0, 0, 1224.0],
                                              [0, 2400.0, 1024.0], [0, 0, 1]])
        np.testing.assert_array_equal(cam.D, [-0.18, 0.06, 0.0008, -0.0006,
                                              0.0])
        np.testing.assert_array_equal(cam.P, P)
        np.testing.assert_allclose(cam.R, R, rtol=0, atol=1e-15)


def test_sgm_direct_matches_the_reference_ops(root_bench):
    """``sgm_direct`` (the plain twins on the CPU) against the root
    script's lines built from the JAX package's ops, ``fused_census_sgm``
    in interpret mode as its own tests run it, at 64x96 with D = 32:
    bit-equal (measured: the valid masks equal and every valid
    disparity equal, |dd| = 0)."""
    import jax.numpy as jnp

    from i3dr_stereo_tpu.ops.census import census_transform
    from i3dr_stereo_tpu.ops.fused_cost_sgm import fused_census_sgm
    from i3dr_stereo_tpu.ops.lr_check import lr_consistency
    from i3dr_stereo_tpu.ops.sgm import DIRECTIONS_4
    from i3dr_stereo_tpu.ops.speckle import speckle_filter
    from i3dr_stereo_tpu.ops.wta import wta_disparity

    l, r = root_bench._synthetic_pair(64, 96, max_disp=32)
    L, R = jnp.asarray(l[None]), jnp.asarray(r[None])
    cl, cr = census_transform(L, 9, 9), census_transform(R, 9, 9)
    S, C = fused_census_sgm(cl, cr, 32, base=0, p1=10.0, p2=120.0,
                            directions=DIRECTIONS_4, out_dtype=jnp.int16,
                            interpret=True)
    disp, ok = wta_disparity(S, 0, uniqueness_ratio=10.0, subpixel=True)
    ok = ok & (jnp.min(C, axis=-1) < 255)
    disp, ok = lr_consistency(disp, ok, S.astype(jnp.float32), 0, 1.5)
    ok = speckle_filter(disp, ok, max_size=100, max_diff=0.5, downsample=2)
    want = np.asarray(jnp.where(ok, disp, -10000.0))

    got = bench.sgm_direct(torch.from_numpy(l[None]),
                           torch.from_numpy(r[None]), 32).numpy()
    assert got.shape == want.shape == (1, 64, 96)
    valid = want != -10000.0
    np.testing.assert_array_equal(got != -10000.0, valid)
    assert 0.2 < valid.mean() < 1.0
    np.testing.assert_array_equal(got[valid], want[valid])


@pytest.mark.parametrize("name", list(bench.BENCHES))
def test_each_config_runs_on_the_cpu(name, monkeypatch, capsys):
    _small(monkeypatch, name)
    assert bench.run(name, device="cpu") == 0
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == (len(STAGES) + 1 if name == "stages" else 1)
    for line in lines:
        assert line["config"] == name
        assert KEYS <= set(line), line
        assert line["value"] > 0 and line["vs_baseline"] is None
        assert line["device"] == "cpu" and line["launches"] == {}
        assert line["ms_events"] is None and line["peak_gib"] is None
    assert lines[-1]["metric"] == METRICS[name]
    if name == "e2e_2448":
        for k in ("e2e_serial_fps", "e2e_overlapped_fps", "ingest_only_fps",
                  "rectify_only_fps", "match_depth_only_fps",
                  "fused_compute_fps", "overlap_vs_ingest_only"):
            assert lines[0][k] > 0, k
        assert lines[0]["value"] == max(lines[0]["e2e_serial_fps"],
                                        lines[0]["e2e_overlapped_fps"])
    if name == "stages":
        assert bench.STAGES == STAGES
        assert [x["metric"] for x in lines[:-1]] == \
            [f"stage_{s}_ms" for s in STAGES]
        assert lines[-1]["value"] == pytest.approx(
            sum(x["value"] for x in lines[:-1]))


def test_cli_bench_bm_640_on_the_cpu(monkeypatch, capsys):
    _small(monkeypatch, "bm_640")
    assert cli.main(["bench", "--config", "bm_640", "--device", "cpu"]) == 0
    (line,) = _lines(capsys.readouterr().out)
    assert line["metric"] == METRICS["bm_640"] and line["value"] > 0
    assert "no kernel" in line["note"]


def test_a_failing_config_exits_non_zero(monkeypatch, capsys):
    """A configuration that raises prints its traceback to stderr and no
    line; under ``all`` the others still run, and the command exits 1."""
    def broken(dev):
        raise RuntimeError("broken config")

    monkeypatch.setitem(bench.BENCHES, "sgbm_1280", broken)
    assert cli.main(["bench", "--config", "sgbm_1280", "--device",
                     "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "RuntimeError: broken config" in out.err
    small = functools.partial(bench.bench_bm_640, **SMALL["bm_640"])
    monkeypatch.setattr(bench, "BENCHES", {"sgbm_1280": broken,
                                           "bm_640": small})
    assert cli.main(["bench", "--config", "all", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert [x["metric"] for x in _lines(out.out)] == [METRICS["bm_640"]]
    assert "broken config" in out.err


def test_unknown_config_raises():
    with pytest.raises(ValueError, match="unknown bench config"):
        bench.run("nope", device="cpu")
