"""Torch port of the stream runner and the CLI against the JAX package on
the same inputs: the runner's disparities and counts at batch 1 and 2,
depth 0 and 2; ``match`` on two PNGs (its files and JSON line), ``live``,
``replay`` over a recorded directory, and ``info``. The JAX side runs the
SGM on the TPU's branch (``pallas_t`` in interpret mode), as
tests/test_torch_registry.py does. The matchers run unrectified inputs
here, so every output compared is exact, except depth and points (1e-6
relative, the pipeline tests' tolerance)."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.io.synthetic import layered_scene

torch.set_num_threads(2)

H, W = 48, 64
RUNNER_SETTINGS = ((1, 0), (1, 2), (2, 0), (2, 2))


@pytest.fixture(scope="module")
def tpu_branch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        yield


def _run_stream(pkg, device_kw, settings):
    """Each runner setting over the same three pairs (the batch of two
    ends padded): per sink call its stamps, count and host disparity,
    then the runner's counts."""
    import importlib

    params = importlib.import_module(f"{pkg}.config.params")
    camera = importlib.import_module(f"{pkg}.core.camera")
    pairing = importlib.import_module(f"{pkg}.pipeline.pairing")
    runner = importlib.import_module(f"{pkg}.pipeline.runner")
    pipeline = importlib.import_module(f"{pkg}.pipeline.stereo_pipeline")
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.BM].replace(
        disparity_range=16)
    pipe = pipeline.StereoPipeline(
        rig=camera.StereoRig.synthetic(W, H, fx=100.0, baseline_m=0.3),
        config=cfg, rectify_inputs=False, **device_kw)
    pairs = []
    for i in range(3):
        sc = layered_scene(H, W, max_disp=12, seed=20 + i)
        pairs.append((pairing.Stamped(i * 0.2, sc.left, i),
                      pairing.Stamped(i * 0.2, sc.right, i)))
    out = {}
    for bs, depth in settings:
        calls = []
        r = runner.StreamRunner(pipe, batch_size=bs)
        stats = r.run(pairs, lambda st, c, res: calls.append(
            (list(st), c, np.asarray(res.disparity), np.asarray(res.valid))),
            depth=depth)
        out[(bs, depth)] = (calls, (stats.frames_in, stats.batches,
                                    stats.frames_out))
    return out


def test_runner_matches_reference(tpu_branch):
    ref = _run_stream("i3dr_stereo_tpu", {}, RUNNER_SETTINGS)
    port = _run_stream("i3dr_stereo_tpu_torch", {"device": "cpu"},
                       RUNNER_SETTINGS)
    for key in RUNNER_SETTINGS:
        (pc, ps), (rc, rs) = port[key], ref[key]
        assert ps == rs == (3, 3 // key[0] + 3 % key[0], 3), key
        assert len(pc) == len(rc)
        for (pst, pn, pd, pv), (rst, rn, rd, rv) in zip(pc, rc):
            assert pst == rst and pn == rn
            assert pd.shape == (key[0], H, W)
            np.testing.assert_array_equal(pv, rv)
            np.testing.assert_array_equal(pd, rd)
            assert pv[:pn].mean() > 0.3


def _main(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.cli").main


def _cli(pkg, argv, capsys):
    rc = _main(pkg)(argv + (["--device", "cpu"] if pkg.endswith("torch")
                            and argv[0] != "info" else []))
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    sc = layered_scene(H, W, max_disp=12, seed=3)
    paths = (str(d / "L.png"), str(d / "R.png"))
    for p, img in zip(paths, (sc.left, sc.right)):
        cv2.imwrite(p, np.clip(img, 0, 255).astype(np.uint8))
    return paths


def test_cli_match_matches_reference(tpu_branch, pngs, tmp_path, capsys):
    from i3dr_stereo_tpu.io.savers import load_ply

    outs = {}
    for pkg in ("i3dr_stereo_tpu", "i3dr_stereo_tpu_torch"):
        out = str(tmp_path / pkg)
        rc, text = _cli(pkg, ["match", *pngs, "-o", out, "--algorithm",
                              "SGBM", "--disparity-range", "16",
                              "--depth-max", "100"], capsys)
        assert rc == 0
        line = json.loads(text.strip().splitlines()[-1])
        assert line.pop("output") == out
        outs[pkg] = (out, line)
    (ro, rline), (po, pline) = outs.values()
    assert pline == rline and pline["valid_fraction"] > 0.3
    for name in ("disparity16.png", "disparity_color.png"):
        a, b = (cv2.imread(os.path.join(o, name), cv2.IMREAD_UNCHANGED)
                for o in (po, ro))
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(np.load(os.path.join(po, "depth.npy")),
                               np.load(os.path.join(ro, "depth.npy")),
                               rtol=1e-6, atol=0)
    (xa, ca), (xb, cb) = (load_ply(os.path.join(o, "points.ply"))
                          for o in (po, ro))
    assert len(xa) == len(xb) > 100
    np.testing.assert_allclose(xa, xb, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ca, cb)


def test_cli_live_matches_reference(tmp_path, capsys):
    args = ["live", "--frames", "2", "--width", "96", "--height", "64",
            "--algorithm", "BM"]
    rc, ref = _cli("i3dr_stereo_tpu", args, capsys)
    assert rc == 0
    view = str(tmp_path / "view.png")
    rc, port = _cli("i3dr_stereo_tpu_torch", args + ["--save-view", view],
                    capsys)
    assert rc == 0
    ref, port = (json.loads(t.strip().splitlines()[-1]) for t in (ref, port))
    assert (port["frames"], port["processed"]) == \
        (ref["frames"], ref["processed"]) == (2, 2)
    assert port["view"] == view and os.path.exists(view)


def test_cli_replay_over_a_recorded_directory(tmp_path, capsys):
    from i3dr_stereo_tpu_torch.io.sources import (SyntheticStereoSource,
                                                  record_pairs)

    d = str(tmp_path / "rec")
    assert record_pairs(d, SyntheticStereoSource(
        width=96, height=64, n_frames=3, max_disp=12).pairs()) == 3
    out = {}
    for pkg in ("i3dr_stereo_tpu", "i3dr_stereo_tpu_torch"):
        rc, text = _cli(pkg, ["replay", d, "--algorithm", "BM"], capsys)
        assert rc == 0
        out[pkg] = json.loads(text.strip().splitlines()[-1])
    for k in ("frames", "processed", "dropped"):
        assert out["i3dr_stereo_tpu_torch"][k] == out["i3dr_stereo_tpu"][k], k
    assert out["i3dr_stereo_tpu_torch"]["processed"] == 3


def test_cli_info_names_torch_not_jax(capsys):
    rc, text = _cli("i3dr_stereo_tpu_torch", ["info"], capsys)
    assert rc == 0
    info = json.loads(text)
    assert "jax" not in info and "backend" not in info
    assert info["torch"] == torch.__version__
    assert info["cuda_available"] == torch.cuda.is_available()
    assert len(info["devices"]) == torch.cuda.device_count()
