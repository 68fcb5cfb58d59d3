"""Torch port of the shell around the pipeline: the framework-free copies
pinned to their originals, the small additions the shell needs, the frame
containers, metrics and memory readers, and the nodes that compute
without a matcher (depth, crop, rectify) against the JAX package's nodes
on the same inputs."""

import dataclasses
import difflib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from i3dr_stereo_tpu.config import params as ref_params
from i3dr_stereo_tpu.core import camera as ref_camera
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.config import params
from i3dr_stereo_tpu_torch.convert import rig_from_reference
from i3dr_stereo_tpu_torch.core import camera

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
# the JAX reference runs its remap through XLA's CPU backend, which fuses
# multiply-adds; the port keeps them apart (tests/test_torch_pipeline_full.py)
RECT_ATOL = 1e-4

# framework-free modules of the reference, copied into the port (a name
# without a suffix is a .py module)
COPIES = ("bridge/graph", "bridge/services", "bridge/reconfigure",
          "pipeline/pairing", "core/frames", "utils/logging", "io/savers",
          "io/sources", "io/calib_store", "io/calibrate", "viz/colormap",
          "viz/cloud", "viz/viewer", "native/__init__", "native/shm",
          "native/shm_ring.cpp", "native/gvsp", "native/gvsp_rx.cpp",
          "bridge/drivers", "io/gige", "viz/serve")
# reference faults repaired in a copy: the reference's lines it drops and
# the lines it adds, in order (normalized as ``_normalized`` reads them);
# every other line is the reference's. The tests that fail on the
# reference's lines are in tests/test_torch_capture.py.
FIXES = {
    # gvsp_rx_poll_missing with room for one run writes it; the engine
    # keeps each frame's first-packet time (gvsp_rx_popped_received);
    # Rx::find drops the stray packets of recently completed blocks
    "native/gvsp_rx.cpp": ([
        '      if (max_runs >= 2) { runs[0] = 0; runs[1] = 0; }',
    ], [
        "  double received = 0;              // host time of the block's 1st packet",
        '  double popped_received = 0;       // of the frame last popped',
        '  // ids of the blocks completed last: a stray packet of one of them (a',
        '  // duplicate, a late resend) is dropped, where a new entry for it could',
        '  // evict a block still filling',
        '  static constexpr int kRecent = 16;',
        '  uint16_t recent[kRecent] = {};',
        '  int n_recent = 0, recent_pos = 0;',
        '  bool completed_recently(uint16_t bid) const {',
        '    for (int i = 0; i < n_recent; i++)',
        '      if (recent[i] == bid) return true;',
        '    return false;',
        '  }',
        "  // the block's entry, a new one where it has none (evicting the oldest",
        '  // incomplete block when every entry is in use), or nullptr for a stray',
        '  // packet of a block completed recently',
        '    if (completed_recently(bid)) return nullptr;',
        '    s.received = b.created;',
        '    recent[recent_pos] = b.block_id;',
        '    recent_pos = (recent_pos + 1) % kRecent;',
        '    if (n_recent < kRecent) n_recent++;',
        '      if (!b) continue;             // a stray of a completed block',
        '  rx->popped_received = s.received;',
        '      if (max_runs >= 1) { runs[0] = 0; runs[1] = 0; }',
        '// Host monotonic time (s) at which the first packet of the frame last',
        '// popped arrived.',
        'double gvsp_rx_popped_received(void* h) {',
        '  Rx* rx = (Rx*)h;',
        '  std::lock_guard<std::mutex> lk(rx->mu);',
        '  return rx->popped_received;',
        '}',
    ]),
    # the engine's first-packet time of each frame, for pairs()
    "native/gvsp": ([], [
        '    lib.gvsp_rx_popped_received.restype = ctypes.c_double',
        '    lib.gvsp_rx_popped_received.argtypes = [ctypes.c_void_p]',
        '                if r == 1:  # when its first packet reached the engine',
        '                    self.received = self._lib.gvsp_rx_popped_received(',
        '                        self._h)',
    ]),
    # GigEStereoSource.pairs(): pair on the host's clock (the device
    # stamps of two cameras share no clock), return after close()
    "io/gige": ([
        '        """Yield timestamp-matched (left, right) frames. Each camera\'s',
        '        blocking frame iterator runs in its own thread; the pairing',
        '        loop matches stamps within tolerance and drops the older',
        '        frame of any unmatched pair."""',
        '                if not put(f):',
        '                    item = qs[i].get()',
        '                yield cur[0], cur[1]',
    ], [
        '        self.received = blk.created     # the host time of its 1st packet',
        '@dataclasses.dataclass',
        'class HostStamped(Stamped):',
        '    """A frame stamped on the host\'s monotonic clock as its block began',
        "    to arrive (``stamp``), with the camera's own stamp beside it",
        '    (``device_stamp``: GEV ticks read on a 1 GHz base)."""',
        '    device_stamp: float = 0.0',
        '        """Yield (left, right) frames matched on the host\'s clock. Each',
        "        camera's blocking frame iterator runs in its own thread and",
        '        stamps every frame with the ``time.monotonic()`` at which its',
        "        block's first packet reached the receiver (:class:`HostStamped`):",
        "        no backlog delays that stamp, where a block's completion, read",
        '        once its last packet is processed, may be tens of ms late in a',
        '        busy interpreter. The pairing loop matches those stamps within',
        '        tolerance and drops the older frame of any unmatched pair; both',
        '        frames of a pair carry the later of their two stamps, so',
        "        downstream pairing sees one instant. Two cameras' GEV timestamps",
        '        are free-running counters with no common epoch (or tick rate),',
        '        so they are never compared: each frame keeps its own as',
        '        ``device_stamp``. The loop returns once ``close()`` is called,',
        '        whatever the queues hold."""',
        '                if not put(HostStamped(src.receiver.received, f.data,',
        '                                       f.seq, f.stamp)):',
        '                    if self._stop.is_set():',
        '                        return',
        '                    try:',
        '                        item = qs[i].get(timeout=0.1)',
        '                    except queue.Empty:',
        '                        continue',
        '                t = max(cur[0].stamp, cur[1].stamp)',
        '                yield (dataclasses.replace(cur[0], stamp=t),',
        '                       dataclasses.replace(cur[1], stamp=t))',
    ]),
}


def _normalized(path):
    """A module's lines with the port's package name read as the
    reference's, its ``import cv2`` statements and blank lines left out:
    the copies import cv2 inside the functions that need it."""
    src = open(os.path.join(_REPO, path)).read()
    src = re.sub(r"\bi3dr_stereo_tpu_torch\b", "i3dr_stereo_tpu", src)
    return [line for line in src.splitlines()
            if line.strip() and line.strip() != "import cv2"]


def _changes(ref, port):
    """The reference's lines the copy drops and the lines it adds."""
    dropped, added = [], []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref, port, autojunk=False).get_opcodes():
        if tag != "equal":
            dropped += ref[i1:i2]
            added += port[j1:j2]
    return dropped, added


@pytest.mark.parametrize("module", COPIES)
def test_copy_matches_reference(module):
    path = module if "." in module else f"{module}.py"
    port = f"i3dr_stereo_tpu_torch/{path}"
    assert _changes(_normalized(f"i3dr_stereo_tpu/{path}"),
                    _normalized(port)) == FIXES.get(module, ([], []))
    top = [line for line in open(os.path.join(_REPO, port)).read()
           .splitlines() if line.startswith(("import ", "from "))]
    assert "import cv2" not in top
    assert not any("jax" in line for line in top)


def test_shell_modules_load_without_cv2():
    """The modules the GPU smoke's shell phase imports load where
    ``import cv2`` fails (the machine with the card has no OpenCV)."""
    mods = chip_smoke.SHELL_MODULES
    assert "i3dr_stereo_tpu_torch.cli" in mods
    code = ("import importlib, sys\n"
            "sys.modules['cv2'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'i3dr_stereo_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=_REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_camera_additions_match_reference():
    ref = ref_camera.StereoRig.synthetic(320, 240, fx=410.0, baseline_m=0.12)
    ref = ref_camera.StereoRig(
        dataclasses.replace(ref.left, D=np.array([0.1, -0.02, 0.001, 0, 0])),
        ref.right)
    port = rig_from_reference(ref)
    for a, b in ((port.left, ref.left), (port.right, ref.right)):
        assert a.to_dict() == b.to_dict()
    for z in (0.5, 3.0, 17.25):
        assert port.depth_to_disparity(z) == ref.depth_to_disparity(z)
        assert port.disparity_to_depth(z) == ref.disparity_to_depth(z)


@pytest.mark.parametrize("kw", [
    {}, dict(brightness=-3, exposure=5, gain=481, exposure_auto=True),
    dict(brightness=5000, exposure=200000, gain=-1, gain_auto=True)])
def test_camera_settings_clamp_match_reference(kw):
    a = params.CameraSettings(**kw).clamp()
    b = ref_params.CameraSettings(**kw).clamp()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_pointcloud_to_numpy_takes_tensors():
    from i3dr_stereo_tpu.ops.depth import pointcloud_to_numpy as ref_pc
    from i3dr_stereo_tpu_torch.ops.depth import pointcloud_to_numpy

    rng = np.random.default_rng(3)
    pc = {"xyz": rng.normal(size=(50, 3)).astype(np.float32),
          "valid": rng.random(50) > 0.4,
          "rgb": rng.uniform(0, 255, (50, 3)).astype(np.float32)}
    want = ref_pc(pc)
    for got in (pointcloud_to_numpy({k: torch.from_numpy(v)
                                     for k, v in pc.items()}),
                pointcloud_to_numpy(pc)):
        for x, y in zip(got, want):
            assert isinstance(x, np.ndarray)
            np.testing.assert_array_equal(x, y)
    xyz, rgb = pointcloud_to_numpy({k: torch.from_numpy(pc[k])
                                    for k in ("xyz", "valid")})
    assert rgb is None and xyz.shape == (int(pc["valid"].sum()), 3)


def test_frames_and_to_uint8():
    from i3dr_stereo_tpu.core.frame import to_uint8 as ref_u8
    from i3dr_stereo_tpu_torch.core.frame import Frame, StereoFrame, to_uint8

    img = np.linspace(-20, 300, 60, dtype=np.float32).reshape(6, 10)
    f = Frame.create(img, 0.5, 3, device="cpu")
    assert f.device == torch.device("cpu")
    assert f.stamp.dtype == torch.float32 and float(f.stamp) == 0.5
    assert f.seq.dtype == torch.int32 and int(f.seq) == 3
    sf = StereoFrame.create(img, img + 1, 2.0, 7, device="cpu")
    assert (sf.height, sf.width) == (6, 10) and sf.device.type == "cpu"
    with pytest.raises(ValueError, match="shape"):
        StereoFrame.create(img, img[:5], device="cpu")
    for x in (img, torch.from_numpy(img)):
        got = to_uint8(x)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref_u8(img))


def test_metrics_and_device_memory(tmp_path):
    from i3dr_stereo_tpu.utils.device_memory import DeviceMem as RefMem
    from i3dr_stereo_tpu_torch.utils.device_memory import DeviceMem
    from i3dr_stereo_tpu_torch.utils.metrics import Metrics, device_trace

    m = Metrics()
    t = torch.ones(4)
    with m.time("cpu"), m.span("cpu"):
        t = t + 1
    assert m.summary()["stages"]["cpu"]["count"] == 1
    with device_trace(str(tmp_path / "trace")):
        with m.span("sum"):
            torch.ones(8).sum()
    assert [s.name for s in m.spans()] == ["sum"]
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    mem = DeviceMem("cpu")
    ref = RefMem()
    assert (mem.get_mem_total(), mem.get_mem_used(), mem.get_mem_free()) == \
        (ref.get_mem_total(), ref.get_mem_used(), ref.get_mem_free()) \
        == (0, 0, 0)
    assert mem.summary()["device"] == "cpu"


def _graphs():
    from i3dr_stereo_tpu.bridge.graph import Graph as RefGraph
    from i3dr_stereo_tpu_torch.bridge.graph import Graph

    return RefGraph(), Graph()


def _listen(g, topic):
    got = []
    g.subscribe(topic, lambda s, d: got.append((s, d)))
    return got


@pytest.fixture(scope="module")
def scene():
    return layered_scene(H, W, max_disp=12, seed=4)


def _ref_rig():
    return ref_camera.StereoRig.synthetic(W, H, fx=100.0, baseline_m=0.3)


def _disparity_msg(sc):
    return {"disparity": sc.disparity.astype(np.float32), "valid": sc.valid,
            "min_disparity": 0, "disparity_range": 16}


def test_disparity_to_depth_node_matches_reference(scene):
    """Both nodes get their bounds before their first frame: the
    reference's jitted closures freeze them at the first trace
    (ROADMAP.md, Queue 3), so parity is held only there."""
    from i3dr_stereo_tpu.bridge.nodes import DisparityToDepthNode as Ref
    from i3dr_stereo_tpu_torch.bridge.nodes import DisparityToDepthNode

    rg, pg = _graphs()
    Ref(rg, _ref_rig(), depth_max=8.0, depth_min=0.5)
    node = DisparityToDepthNode(pg, rig_from_reference(_ref_rig()),
                                depth_max=8.0, depth_min=0.5, device="cpu")
    out = {}
    for name, g in (("ref", rg), ("port", pg)):
        out[name] = (_listen(g, "/stereo/depth"), _listen(g, "/stereo/points2"))
        g.publish("/stereo/left/image_rect", 0.1, scene.left)
        g.publish("/stereo/disparity", 0.1, _disparity_msg(scene))
    (rd, rp), (pd, pp) = out["ref"], out["port"]
    assert len(pd) == len(rd) == 1 and len(pp) == len(rp) == 1
    want, got = np.asarray(rd[0][1]), pd[0][1]
    assert isinstance(got, np.ndarray) and (want > 0).mean() > 0.3
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    rpts, ppts = rp[0][1], pp[0][1]
    np.testing.assert_array_equal(ppts["valid"], np.asarray(rpts["valid"]))
    np.testing.assert_array_equal(ppts["rgb"], np.asarray(rpts["rgb"]))
    v = ppts["valid"]
    np.testing.assert_allclose(ppts["xyz"][v], np.asarray(rpts["xyz"])[v],
                               rtol=1e-6, atol=1e-6)
    # the port reads its bounds on every call: a change reaches the next
    # frame as if the node had been built with it
    node.depth_max = 2.0
    rg2, _ = _graphs()
    Ref(rg2, _ref_rig(), depth_max=2.0, depth_min=0.5)
    fresh = _listen(rg2, "/stereo/depth")
    rg2.publish("/stereo/disparity", 0.2, _disparity_msg(scene))
    pg.publish("/stereo/disparity", 0.2, _disparity_msg(scene))
    np.testing.assert_allclose(pd[-1][1], np.asarray(fresh[0][1]),
                               rtol=1e-6, atol=0)
    assert (pd[-1][1] > 0).sum() < (pd[0][1] > 0).sum()


def test_crop_node_matches_reference_and_is_lazy(scene):
    from i3dr_stereo_tpu.bridge.nodes import CropByDisparityNode as Ref
    from i3dr_stereo_tpu_torch.bridge.nodes import CropByDisparityNode

    rg, pg = _graphs()
    Ref(rg)
    CropByDisparityNode(pg, device="cpu")
    seen = {"ref": [], "port": []}
    for name, g in (("ref", rg), ("port", pg)):
        g.publish("/stereo/left/image_rect", 0.1, scene.left)
        g.publish("/stereo/disparity", 0.1, _disparity_msg(scene))
        assert g.topic("/stereo/left/image_rect_disp_cropped") \
            .n_published == 0                                   # lazy
        g.subscribe("/stereo/left/image_rect_disp_cropped",
                    lambda s, d, n=name: seen[n].append(d))
        g.publish("/stereo/disparity", 0.2, _disparity_msg(scene))
    assert len(seen["port"]) == len(seen["ref"]) == 1
    got = seen["port"][0]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(seen["ref"][0]))
    assert (got == 0).any() and (got != 0).any()


def _distorted_rig():
    K = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]])
    D = 0.2 * np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    Pl = np.array([[59.0, 0, 31.5, 0], [0, 59.0, 24.5, 0], [0, 0, 1, 0]])
    Pr = Pl.copy()
    Pr[0, 2], Pr[0, 3] = 32.5, -59.0 * 0.3
    R = np.eye(3)
    return ref_camera.StereoRig(ref_camera.CameraModel(W, H, K, D, R, Pl),
                                ref_camera.CameraModel(W, H, K, D, R, Pr))


def test_rectify_node_matches_reference(scene, tmp_path):
    import cv2

    from i3dr_stereo_tpu.bridge.nodes import RectifyNode as Ref
    from i3dr_stereo_tpu.bridge.services import SaveRectifiedRequest as RefReq
    from i3dr_stereo_tpu_torch.bridge.nodes import RectifyNode
    from i3dr_stereo_tpu_torch.bridge.services import SaveRectifiedRequest

    raw = np.clip(scene.left, 0, 255).astype(np.uint8)
    rg, pg = _graphs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I3DR_REMAP_BACKEND", "gather")
        Ref(rg, _distorted_rig())
        RectifyNode(pg, rig_from_reference(_distorted_rig()), device="cpu")
        out = {}
        for name, g in (("ref", rg), ("port", pg)):
            out[name] = [_listen(g, f"/stereo/{s}/image_rect")
                         for s in ("left", "right")]
            g.publish("/stereo/left/image_raw", 0.1, raw)
            g.publish("/stereo/right/image_raw", 0.1, scene.right)
    for r, p in zip(out["ref"], out["port"]):
        got = p[0][1]
        assert isinstance(got, np.ndarray) and got.shape == (H, W)
        np.testing.assert_allclose(got, np.asarray(r[0][1]), rtol=0,
                                   atol=RECT_ATOL)
    assert not np.array_equal(out["port"][0][0][1], raw.astype(np.float32))
    a = pg.call("/stereo/save_rectified",
                SaveRectifiedRequest(folderpath=str(tmp_path / "p")))
    b = rg.call("/stereo/save_rectified",
                RefReq(folderpath=str(tmp_path / "r")))
    assert a.ok and b.ok and sorted(a.paths) == sorted(b.paths)
    for side in a.paths:
        x, y = (cv2.imread(res.paths[side], cv2.IMREAD_UNCHANGED)
                for res in (a, b))
        # uint8 truncation of images within 1e-4 of each other
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1


def test_warmup_matchers_builds_a_cpu_matcher():
    from i3dr_stereo_tpu_torch.bridge.nodes import warmup_matchers

    for alg in (params.Algorithm.I3DRSGM, params.Algorithm.SGBM):
        assert warmup_matchers(params.ALGORITHM_DEFAULTS[alg], device="cpu")
