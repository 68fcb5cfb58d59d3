"""Torch port of the node graph: the live graph (``launch_stereo_camera``
with its synthetic source) against the JAX package's graph on the same
stream, on the branches the TPU runs (``pallas_t`` SGM and the Pallas
speckle filter in interpret mode, the gather remap). Every topic the
matcher node publishes is compared, then the files of its
``save_stereo`` service, then a live reconfigure reaching the next frame.

Tolerances are those of tests/test_torch_pipeline_full.py: rectified
images within 1e-4 (XLA's CPU backend fuses the reference remap's
multiply-adds), disparities and masks exact, depth and points within
1e-6 relative. An image saved as uint8 truncates values within 1e-4 of
each other, so those files may differ by one grey level."""

import importlib

import cv2
import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.io.synthetic import layered_scene

torch.set_num_threads(2)

H, W = 64, 96
RECT_ATOL = 1e-4
# per algorithm: the matcher config, then a live change through the
# node's reconfigure servers confined to fields the reference passes to
# its compiled step at run time (no retrace)
CASES = {
    "I3DRSGM": (dict(disparity_range=32, max_pyramid_level=2),
                dict(p2=1.6, speckle_range=2)),
    "SGBM": (dict(disparity_range=16, speckle_size=20),
             dict(p2=800.0, uniqueness_ratio=5.0)),
}
CLOUD_CHANGE = dict(depth_max=3.0)
TOPICS = ("left/image_rect", "right/image_rect", "disparity", "depth",
          "points2")


def _drive(pkg, alg_name, folder, **kw):
    """The live graph of package ``pkg`` over two synthetic frames, its
    save_stereo service, then a reconfigure and one more frame."""
    launch = importlib.import_module(f"{pkg}.bridge.launch")
    params = importlib.import_module(f"{pkg}.config.params")
    camera = importlib.import_module(f"{pkg}.core.camera")
    sources = importlib.import_module(f"{pkg}.io.sources")
    services = importlib.import_module(f"{pkg}.bridge.services")
    alg = params.Algorithm[alg_name]
    cfg_kw, change = CASES[alg_name]
    lg = launch.launch_stereo_camera(
        camera.StereoRig.synthetic(W, H, fx=100.0, baseline_m=0.3),
        stereo_algorithm=alg,
        source=sources.SyntheticStereoSource(width=W, height=H, n_frames=2,
                                             max_disp=12),
        config=params.ALGORITHM_DEFAULTS[alg].replace(**cfg_kw),
        warmup=False, **kw)
    got = {t: [] for t in TOPICS}
    for t in TOPICS:
        lg.graph.subscribe(f"/stereo/{t}", lambda s, d, t=t: got[t].append(d))
    n = launch.run_source(lg)
    node = lg.node("generate_disparity")
    saved = lg.graph.call("/stereo/save_stereo",
                          services.SaveStereoRequest(folderpath=folder))
    node.disparity_cfg.update(**change)
    node.cloud_cfg.update(**CLOUD_CHANGE)
    sc = layered_scene(H, W, max_disp=12, seed=9)
    lg.graph.publish("/stereo/left/image_raw", 10.0, sc.left)
    lg.graph.publish("/stereo/right/image_raw", 10.0, sc.right)
    return dict(n=n, got=got, processed=node.frames_processed,
                dropped=node.frames_dropped, saved=saved,
                config=node.pipeline.config, cloud=node.pipeline.cloud)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        mp.setenv("I3DR_REMAP_BACKEND", "gather")
        for alg in CASES:
            out[alg] = {
                "ref": _drive("i3dr_stereo_tpu", alg,
                              str(tmp_path_factory.mktemp(f"ref_{alg}"))),
                "port": _drive("i3dr_stereo_tpu_torch", alg,
                               str(tmp_path_factory.mktemp(f"port_{alg}")),
                               device="cpu")}
    return out


def _assert_frame(got, want, i, density=0.3):
    for t in ("left/image_rect", "right/image_rect"):
        assert isinstance(got[t][i], np.ndarray)
        np.testing.assert_allclose(got[t][i], np.asarray(want[t][i]),
                                   rtol=0, atol=RECT_ATOL, err_msg=t)
    g, w = got["disparity"][i], want["disparity"][i]
    assert g.keys() == w.keys()
    assert g["valid"].mean() > density
    np.testing.assert_array_equal(g["valid"], np.asarray(w["valid"]))
    np.testing.assert_array_equal(g["disparity"], np.asarray(w["disparity"]))
    for k in ("min_disparity", "disparity_range", "f", "T"):
        assert g[k] == w[k], k
    np.testing.assert_allclose(got["depth"][i], np.asarray(want["depth"][i]),
                               rtol=1e-6, atol=0)
    gp, wp = got["points2"][i], want["points2"][i]
    assert gp.keys() == wp.keys()
    v = gp["valid"]
    np.testing.assert_array_equal(v, np.asarray(wp["valid"]))
    np.testing.assert_allclose(gp["xyz"][v], np.asarray(wp["xyz"])[v],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gp["rgb"], np.asarray(wp["rgb"]), rtol=0,
                               atol=RECT_ATOL)


@pytest.mark.parametrize("alg", list(CASES))
def test_graph_topics_match_reference(runs, alg):
    ref, port = runs[alg]["ref"], runs[alg]["port"]
    assert port["n"] == ref["n"] == 2
    assert (port["processed"], port["dropped"]) == \
        (ref["processed"], ref["dropped"]) == (3, 0)
    for t in TOPICS:
        assert len(port["got"][t]) == len(ref["got"][t]) == 3, t
    for i in range(2):
        _assert_frame(port["got"], ref["got"], i)


@pytest.mark.parametrize("alg", list(CASES))
def test_save_stereo_files_match_reference(runs, alg):
    from i3dr_stereo_tpu.io.savers import load_ply

    ref, port = runs[alg]["ref"]["saved"], runs[alg]["port"]["saved"]
    assert port.ok and ref.ok
    assert sorted(port.paths) == sorted(ref.paths) == [
        "disparity", "left_raw", "left_rect", "points", "right_raw",
        "right_rect"]
    for k in ("left_raw", "right_raw", "disparity", "left_rect",
              "right_rect"):
        a, b = (cv2.imread(p.paths[k], cv2.IMREAD_UNCHANGED)
                for p in (port, ref))
        assert a.dtype == b.dtype and a.shape == b.shape == (H, W), k
        diff = np.abs(a.astype(int) - b.astype(int)).max()
        assert diff <= (1 if k.endswith("rect") else 0), k
    (xa, ra), (xb, rb) = (load_ply(p.paths["points"]) for p in (port, ref))
    assert len(xa) == len(xb) > 100
    np.testing.assert_allclose(xa, xb, rtol=1e-6, atol=1e-6)
    assert np.abs(ra.astype(int) - rb.astype(int)).max() <= 1


@pytest.mark.parametrize("alg", list(CASES))
def test_reconfigure_reaches_the_next_frame(runs, alg):
    from i3dr_stereo_tpu_torch.convert import config_from_reference

    ref, port = runs[alg]["ref"], runs[alg]["port"]
    assert port["config"] == config_from_reference(ref["config"])
    for k, v in CASES[alg][1].items():
        assert getattr(port["config"], k) == v, k
    assert port["cloud"].depth_max == ref["cloud"].depth_max == \
        CLOUD_CHANGE["depth_max"]
    # the nearer depth bound leaves the nearest surfaces alone
    _assert_frame(port["got"], ref["got"], 2, density=0.05)
    depth = port["got"]["depth"][2]
    assert 0 < depth.max() <= CLOUD_CHANGE["depth_max"]
