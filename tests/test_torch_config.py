"""Torch port: the framework-free copies (config, camera, synthetic scene),
the state converters and the port's guards, against the JAX package."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu.config import params as ref_params
from i3dr_stereo_tpu.core import camera as ref_camera
from i3dr_stereo_tpu.io.synthetic import layered_scene as ref_layered_scene
from i3dr_stereo_tpu.io.synthetic import slanted_scene as ref_slanted_scene
from i3dr_stereo_tpu_torch.config import params
from i3dr_stereo_tpu_torch.convert import config_from_reference, rig_from_reference
from i3dr_stereo_tpu_torch.core import camera
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene, slanted_scene

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("alg", list(ref_params.Algorithm))
def test_algorithm_defaults_field_by_field(alg):
    ref = ref_params.ALGORITHM_DEFAULTS[alg]
    port = params.ALGORITHM_DEFAULTS[params.Algorithm(int(alg))]
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    for name, v in _fields(ref).items():
        pv = getattr(port, name)
        if isinstance(v, (ref_params.Algorithm, ref_params.CostFunction)):
            assert pv.name == v.name and pv.value == v.value, name
        else:
            assert pv == v and type(pv) is type(v), name


def test_enums_and_cloud_config_match():
    assert [(a.name, a.value) for a in params.Algorithm] == \
        [(a.name, a.value) for a in ref_params.Algorithm]
    assert [(c.name, c.value) for c in params.CostFunction] == \
        [(c.name, c.value) for c in ref_params.CostFunction]
    assert _fields(params.PointCloudConfig()) == \
        _fields(ref_params.PointCloudConfig())


@pytest.mark.parametrize("kw", [
    dict(window_size=14, disparity_range=70, census_width=20,
         census_height=8),
    dict(disparity_range=256, max_pyramid_level=4, speckle_size=0,
         speckle_downsample=2, p1=0.3, uniqueness_ratio=12.0),
])
def test_sanitize_replace_and_convert(kw):
    base = ref_params.ALGORITHM_DEFAULTS[ref_params.Algorithm.I3DRSGM]
    ref = base.replace(**kw)
    port = config_from_reference(base).replace(**kw)
    assert port == config_from_reference(ref)
    assert _fields(port)["census_width"] == ref.census_width
    with pytest.raises(ValueError):
        params.MatcherConfig(prefilter_type="bogus").sanitize()


def test_calc_q_and_rig_match(tmp_path):
    ref = ref_camera.StereoRig.synthetic(320, 240, fx=410.0, baseline_m=0.12)
    port = rig_from_reference(ref)
    np.testing.assert_array_equal(port.Q, ref.Q)
    np.testing.assert_array_equal(camera.calc_q(port.left, port.right),
                                  ref_camera.calc_q(ref.left, ref.right))
    assert (port.fx, port.baseline, port.width, port.height) == \
        (ref.fx, ref.baseline, ref.width, ref.height)
    syn = camera.StereoRig.synthetic(320, 240, fx=410.0, baseline_m=0.12)
    np.testing.assert_array_equal(syn.Q, ref.Q)


def test_rig_from_yaml_matches(tmp_path):
    yaml = pytest.importorskip("yaml")
    ref = ref_camera.StereoRig.synthetic(640, 480, fx=580.0)
    ref = ref_camera.StereoRig(
        dataclasses.replace(ref.left, D=np.array([0.1, -0.02, 0.001, 0.0, 0.0])),
        ref.right)
    paths = []
    for side, cam in (("left", ref.left), ("right", ref.right)):
        p = tmp_path / f"{side}.yaml"
        p.write_text(yaml.safe_dump(cam.to_dict()))
        paths.append(str(p))
    port = camera.StereoRig.from_yaml(*paths)
    back = ref_camera.StereoRig.from_yaml(*paths)
    for a, b in ((port.left, back.left), (port.right, back.right)):
        for name in ("K", "D", "R", "P"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(port.Q, back.Q)


@pytest.mark.parametrize("kw", [
    dict(height=96, width=128, max_disp=20, seed=4),
    dict(height=64, width=160, max_disp=24, seed=7, layers=5,
         background_disp=5, right_gain=1.1, noise_sigma=2.0),
    dict(height=80, width=120, max_disp=16, seed=3, fractional=True),
])
def test_layered_scene_bit_identical(kw):
    a, b = layered_scene(**kw), ref_layered_scene(**kw)
    for f in ("left", "right", "disparity", "occluded", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kw", [
    {},
    dict(height=64, width=96, d_near=12.0, d_far=3.5, seed=4, right_gain=1.1,
         right_bias=-3.0),
    dict(height=48, width=80, seed=9, noise_sigma=2.5),
])
def test_slanted_scene_bit_identical(kw):
    import i3dr_stereo_tpu_torch.io as port_io

    assert port_io.slanted_scene is slanted_scene
    a, b = slanted_scene(**kw), ref_slanted_scene(**kw)
    for f in ("left", "right", "disparity", "occluded", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kw", [
    {}, dict(disparity_range=100, window_size=6, census_width=20),
    dict(downsample_scale=0.5, num_directions=8, pyramid=False, p1=7.0),
])
def test_shape_key_matches_reference(kw):
    assert params.MatcherConfig.SHAPE_FIELDS == \
        ref_params.MatcherConfig.SHAPE_FIELDS
    for alg in ref_params.Algorithm:
        ref = ref_params.ALGORITHM_DEFAULTS[alg].replace(**kw)
        port = config_from_reference(ref)
        def plain(key):    # the two packages' enums by name and value
            return [(v.name, v.value) if hasattr(v, "name") else v
                    for v in key]

        assert plain(port.shape_key()) == plain(ref.shape_key())


def test_gather_along_rows_reference_matches():
    """Bit-equal to the JAX package's ``take_along_axis`` form on a seeded
    input whose shifts reach past both image edges."""
    import jax.numpy as jnp

    from i3dr_stereo_tpu.ops.block_gather import (
        gather_along_rows_reference as ref_gather)
    from i3dr_stereo_tpu_torch.ops.block_gather import (
        gather_along_rows_reference)

    rng = np.random.default_rng(11)
    src = rng.normal(size=(2, 9, 37)).astype(np.float32)
    idx = rng.integers(-45, 45, (2, 9, 37)).astype(np.int32)
    got = gather_along_rows_reference(torch.from_numpy(src),
                                      torch.from_numpy(idx)).numpy()
    want = np.asarray(ref_gather(jnp.asarray(src), jnp.asarray(idx)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_to_mono_matches_reference():
    """A BGR uint8 image goes through the luma sum of both packages. The
    port adds three float32 products left to right; the reference calls
    ``tensordot``, which XLA's CPU backend may fuse into multiply-adds or
    sum in another order. Both round a value below 256 a few times, to
    2**-16 each: 1e-4 absolute covers it and is far below a grey level."""
    import jax.numpy as jnp

    from i3dr_stereo_tpu.core.frame import to_mono_f32 as ref_mono
    from i3dr_stereo_tpu_torch.core.frame import to_mono_f32

    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
    mono = rng.uniform(0, 255, (17, 23)).astype(np.float32)
    got = to_mono_f32(torch.from_numpy(bgr)).numpy()
    want = np.asarray(ref_mono(jnp.asarray(bgr)))
    assert got.shape == want.shape == (17, 23) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and it is the BT.601 luma, not a pass-through of either package
    luma = bgr.astype(np.float64) @ np.array([0.114, 0.587, 0.299])
    np.testing.assert_allclose(got, luma, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(to_mono_f32(torch.from_numpy(mono)).numpy(),
                                  mono)
    np.testing.assert_array_equal(np.asarray(ref_mono(jnp.asarray(mono))),
                                  mono)


def test_port_imports_no_jax():
    """Every Python module of the port imports without JAX. The walk
    also meets the ``native/`` libraries that ``g++`` builds beside their
    ctypes bindings (a ``.so`` reads as an extension module): those are
    not Python modules and are passed over."""
    code = (
        "import importlib, importlib.machinery, importlib.util, pkgutil, sys\n"
        "import i3dr_stereo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not isinstance(importlib.util.find_spec(m.name).loader,\n"
        "                      importlib.machinery.ExtensionFileLoader):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'i3dr_stereo_tpu' or m.startswith('i3dr_stereo_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=_REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_imports_no_jax():
    """The GPU smoke script imports nothing of JAX or of the JAX package
    (neither exists on the machine with the card)."""
    import ast

    tree = ast.parse(open(os.path.join(_REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "i3dr_stereo_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "i3dr_stereo_tpu"}, roots


def test_cuda_device_raises_without_cuda():
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM].replace(
        speckle_size=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoPipeline(camera.StereoRig.synthetic(64, 48), cfg, device="cuda")
    with pytest.raises(ValueError, match="device"):
        StereoPipeline(camera.StereoRig.synthetic(64, 48), cfg, device="meta")


@pytest.mark.parametrize("entry", [
    "StereoPipeline", "make_rectify_map", "StereoMatcher", "create_matcher",
    "GenerateDisparityNode", "RectifyNode", "DisparityToDepthNode",
    "CropByDisparityNode", "warmup_matchers", "launch_stereo_matcher",
    "launch_stereo_camera", "launch_processing", "launch_replay",
    "cli_match", "cli_live", "cli_replay", "cli_bench", "DeviceMem", "Frame",
    "StereoFrame"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Without ``device`` the entry points run on the card; with no card
    they raise, never falling back to the CPU."""
    import cv2

    from i3dr_stereo_tpu_torch import cli
    from i3dr_stereo_tpu_torch.bridge import graph, launch, nodes
    from i3dr_stereo_tpu_torch.core import frame
    from i3dr_stereo_tpu_torch.matchers import base
    from i3dr_stereo_tpu_torch.ops import rectify
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline
    from i3dr_stereo_tpu_torch.utils.device_memory import DeviceMem

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.SGBM]
    rig = camera.StereoRig.synthetic(64, 48)
    png = str(tmp_path / "l_rect000000.png")
    cv2.imwrite(png, np.zeros((48, 64), np.uint8))
    make = {
        "StereoPipeline": lambda: StereoPipeline(rig, cfg),
        "make_rectify_map": lambda: rectify.make_rectify_map(
            camera.CameraModel.ideal(16, 8, 10.0)),
        "StereoMatcher": lambda: base.StereoMatcher(cfg),
        "create_matcher": lambda: base.create_matcher(params.Algorithm.SGBM),
        "GenerateDisparityNode": lambda: nodes.GenerateDisparityNode(
            graph.Graph(), rig, cfg),
        "RectifyNode": lambda: nodes.RectifyNode(graph.Graph(), rig),
        "DisparityToDepthNode": lambda: nodes.DisparityToDepthNode(
            graph.Graph(), rig),
        "CropByDisparityNode": lambda: nodes.CropByDisparityNode(
            graph.Graph()),
        "warmup_matchers": lambda: nodes.warmup_matchers(cfg),
        "launch_stereo_matcher": lambda: launch.launch_stereo_matcher(
            rig, warmup=False),
        "launch_stereo_camera": lambda: launch.launch_stereo_camera(rig),
        "launch_processing": lambda: launch.launch_processing(rig),
        "launch_replay": lambda: launch.launch_replay(rig, str(tmp_path)),
        "cli_match": lambda: cli.main(["match", png, png,
                                       "-o", str(tmp_path / "out")]),
        "cli_live": lambda: cli.main(["live", "--frames", "1"]),
        "cli_replay": lambda: cli.main(["replay", str(tmp_path)]),
        "cli_bench": lambda: cli.main(["bench", "--config", "bm_640"]),
        "DeviceMem": lambda: DeviceMem(),
        "Frame": lambda: frame.Frame.create(np.zeros((4, 4))),
        "StereoFrame": lambda: frame.StereoFrame.create(np.zeros((4, 4)),
                                                        np.zeros((4, 4))),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_cpu_matcher_moves_its_inputs_to_the_cpu():
    """``device="cpu"``: numpy frames and tensors alike are matched by the
    plain twins on the CPU, forward and backward."""
    from i3dr_stereo_tpu_torch.matchers import base

    sc = layered_scene(40, 64, max_disp=12, seed=3)
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.BM].replace(
        disparity_range=16)
    m = base.create_matcher(cfg, device="cpu")
    assert m.device == torch.device("cpu")
    fwd = m.match(sc.left, sc.right)
    bwd = m.backward_match(sc.left, sc.right)
    for res in (fwd, bwd):
        assert res.disparity.device.type == "cpu"
        assert res.valid.device.type == "cpu"
        assert tuple(res.disparity.shape) == (40, 64)
    again = m.match(torch.from_numpy(sc.left), torch.from_numpy(sc.right))
    assert torch.equal(again.disparity, fwd.disparity)
    assert torch.equal(again.valid, fwd.valid) and bool(fwd.valid.any())


def test_kernel_wrappers_reject_non_cuda_accelerator_tensors():
    from i3dr_stereo_tpu_torch.ops.block_gather import block_shift_gather

    src = torch.zeros((1, 8, 16), device="meta")
    idx = torch.zeros((1, 8, 16), dtype=torch.int32, device="meta")
    q = torch.zeros((1, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        block_shift_gather(src, idx, q, 4)


@pytest.mark.parametrize("op", ["remap", "speckle_keep", "gauss_rays",
                                "wls_lines", "bt_box_cost"])
def test_new_kernel_wrappers_reject_non_cuda_accelerator_tensors(op):
    from i3dr_stereo_tpu_torch.ops import (cost, gauss_interp, rectify,
                                           speckle, wls)

    if op == "bt_box_cost":
        img = torch.zeros((1, 8, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            cost.bt_box_cost_volume(img, img, 0, 8, 9)
    elif op == "gauss_rays":
        d = torch.zeros((1, 8, 16), device="meta")
        v = torch.zeros((1, 8, 16), dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            gauss_interp.gauss_interpolate(d, v)
    elif op == "wls_lines":
        d = torch.zeros((1, 8, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            wls.thomas_lines(d, torch.zeros((1, 7, 16), device="meta"), d,
                             5.0, vertical=True)
    elif op == "remap":
        m = rectify.make_rectify_map(camera.CameraModel.ideal(16, 8, 10.0),
                                     device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            rectify.remap(torch.zeros((8, 16), device="meta"), m)
    else:
        d = torch.zeros((1, 8, 16), device="meta")
        v = torch.zeros((1, 8, 16), dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            speckle.speckle_keep(d, v, 10, 1.0)


def test_unported_features_raise():
    """The options that raised before the post-match stages were ported
    now run through ``StereoPipeline.update_config`` and match the JAX
    pipeline (its TPU branch, ``pallas_t_interpret``): occlusion detection
    and fill with the Gauss gap fill on the pyramid, and the dense
    I3DRSGM's ``interp`` (the WLS fill; every pixel also within 2e-3 px
    of a float64 witness of it). Rectification is off on both
    sides (XLA's CPU remap fuses multiply-adds, which
    tests/test_torch_pipeline_full.py covers). BP / CSBP, which raised
    until they were ported, run through the same pipelines'
    ``update_config`` and match the reference off its near ties (read
    off the port's beliefs, as tests/test_torch_bp.py does for the jitted
    reference)."""
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import (
        StereoPipeline as RefPipeline)
    from i3dr_stereo_tpu_torch.matchers import registry
    from i3dr_stereo_tpu_torch.matchers.registry import MATCHER_REGISTRY
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline
    from test_torch_bp import _assert_matches, _near, _port_belief_recorder
    from test_torch_postmatch import check_wls_witness, record_wls

    sc = layered_scene(48, 64, max_disp=12, seed=3)
    rig = camera.StereoRig.synthetic(64, 48)
    base = params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM]
    assert base.speckle_size == 100
    ref_base = ref_params.ALGORITHM_DEFAULTS[ref_params.Algorithm.I3DRSGM]
    # depth bounds off: every disparity reaches the result
    pipe = StereoPipeline(rig, base.replace(max_pyramid_level=2),
                          params.PointCloudConfig(depth_min=0.0,
                                                  depth_max=0.0),
                          device="cpu", rectify_inputs=False)
    ref = RefPipeline(ref_camera.StereoRig.synthetic(64, 48),
                      ref_base.replace(max_pyramid_level=2),
                      ref_params.PointCloudConfig(depth_min=0.0,
                                                  depth_max=0.0),
                      rectify_inputs=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_SGM_BACKEND", "pallas_t_interpret")
        mp.setenv("I3DR_SPECKLE_BACKEND", "pallas_interpret")
        for kw, tol in ((dict(occlusion_detection=True,
                              occlusion_interp=True,
                              interpolate_missing=True), 1e-5),
                        (dict(occlusion_detection=False,
                              occlusion_interp=False,
                              interpolate_missing=False, pyramid=False,
                              disparity_range=32, interp=True), 1e-3)):
            pipe.update_config(**kw)
            ref.update_config(**kw)
            with pytest.MonkeyPatch.context() as rec:
                calls = record_wls(rec, registry)
                got = pipe.process(sc.left, sc.right)
            want = ref.process(sc.left, sc.right)
            d, d_ref = got.disparity.numpy(), np.asarray(want.disparity)
            np.testing.assert_array_equal(got.valid.numpy(),
                                          np.asarray(want.valid))
            assert got.valid.float().mean() > 0.9
            # the reference's WLS fill can divide by a zero pivot (NaN);
            # the port's is finite and agrees with the float64 witness
            # (tests/test_torch_postmatch.py)
            ok = np.isfinite(d_ref)
            assert np.isfinite(d).all() and ok.mean() > 0.5
            np.testing.assert_allclose(d[ok], d_ref[ok], rtol=0, atol=tol)
            if kw.get("interp"):
                check_wls_witness(d, calls, d_ref)
            else:
                assert not calls
        for alg in (params.Algorithm.BP_GPU, params.Algorithm.CSBP_GPU):
            pipe.update_config(algorithm=alg, disparity_range=16)
            ref.update_config(algorithm=ref_params.Algorithm(alg.value),
                              disparity_range=16)
            assert MATCHER_REGISTRY[alg].__name__ in ("bp_match",
                                                      "csbp_match")
            rec = {}
            with pytest.MonkeyPatch.context() as mp:
                _port_belief_recorder(mp, rec)
                got = pipe.process(sc.left, sc.right)
            want = ref.process(sc.left, sc.right)
            assert got.valid.float().mean() > 0.5
            _assert_matches(got.disparity.numpy(), got.valid.numpy(),
                            dict(d=np.asarray(want.disparity),
                                 v=np.asarray(want.valid),
                                 near=_near(rec["belief"])),
                            alg == params.Algorithm.CSBP_GPU)

