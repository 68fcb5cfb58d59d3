"""Benchmark configurations of the port: the counterpart of the
repository root's ``bench.py``, which the JAX package's ``cli bench``
runs.

    python -m i3dr_stereo_tpu_torch.cli bench --config all
    python -m i3dr_stereo_tpu_torch.cli bench --config bm_640 --device cpu

Eight configurations (:data:`BENCHES`, the root script's names and
inputs): ``flagship`` and ``flagship_flat`` (the I3DRSGM pyramid at
2448x2048 with 256 disparities, on the layered and the constant-shift
pair), ``sgbm_1280``, ``bm_640``, ``pipeline_batch`` (``StereoPipeline``
on a 16-frame batch), ``sgm_direct_2448`` (:func:`sgm_direct`, census
SGM over all 256 disparities), ``e2e_2448`` (uint8 numpy frames of the
distorted rig into ``process``, the upload inside the timed loop) and
``stages`` (the flagship level 0's stages one by one). Each prints one
JSON line (``stages`` one a stage, then their sum) with its name
(``config``), the root script's ``metric``, ``value``, ``unit`` and
``vs_baseline``, and:

- ``value``: frames a second (ms a call for ``stages``) by the host's
  clock over ``iters`` calls issued back to back and closed by one
  ``torch.cuda.synchronize()``: the rate a loop gets. It equals the
  events' rate only where the card, not the host, binds the call;
- ``ms_events``: CUDA events around one call, the median of ``iters``
  after warm-up (``null`` on the CPU, which has no events);
- ``peak_gib``: the most device memory allocated during the
  configuration (``null`` on the CPU);
- ``launches``: the port's kernels launched by one call, by name
  (``_build.LAUNCHES``), which shows the path the call took;
- ``device``: the card's name and power limit (``nvidia-smi``), and
  ``size``, the image size the call ran at;
- ``vs_baseline`` is ``null`` in every line: the root script's 30
  frames/s is a TPU target, no yardstick for this card.

The root script's TPU workarounds are not copied: it chained K calls in
one ``lax.scan`` and differenced K against 2K because its remote runtime
acknowledged dispatch, not execution; here CUDA events and one
synchronize time the card. It turned any failure into a line with value
0 and exit code 0; here a failing configuration prints its traceback to
stderr, prints no line, the others still run, and :func:`run` returns 1.
Without a card the CUDA device raises (``--device cpu`` runs the plain
torch twins): nothing falls back.

``stages`` names its rows after the port's stages: the root script's
``censusT_9x9`` is ``census_transform_pair_9x9`` (a level's two images,
one launch), its ``fwd_t`` is two rows, ``census_cost`` and
``sgm_sweep_fwd`` (the port builds the cost volume once and sweeps it),
``vdown_t_1dir`` / ``vup_wta_t_1dir`` are ``sgm_sweep_down`` /
``sgm_sweep_up_wta``, and the remaps are ``rectify_cubic`` /
``rectify_cubic_u8``. Its ``transpose_C_u8`` and ``transpose_Sh_i16``
have no counterpart, since the port's volumes keep one (B, H, W, D)
layout from the cost to the WTA, and are left out. Every call runs at
the root script's shapes, layered pair at 2448x2048 padded to
2560x2048, D = 32.

The inputs are copies of the root script's: :func:`_synthetic_pair`
(quirks included: it band-limits before it rolls), :func:`_layered_pair`,
:func:`_flagship_cfg` and the distorted rig of its ``e2e_2448``
(:func:`distorted_rig`); ``tests/test_torch_bench.py`` holds them equal.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from i3dr_stereo_tpu_torch import _build
from i3dr_stereo_tpu_torch.config.params import (ALGORITHM_DEFAULTS, Algorithm,
                                                 PointCloudConfig)
from i3dr_stereo_tpu_torch.core.camera import CameraModel, StereoRig
from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
from i3dr_stereo_tpu_torch.matchers.pyramid import _downsample2, _upsample2_disp
from i3dr_stereo_tpu_torch.matchers.registry import MATCHER_REGISTRY
from i3dr_stereo_tpu_torch.ops.block_gather import (block_anchors,
                                                    block_shift_gather,
                                                    pad_edge)
from i3dr_stereo_tpu_torch.ops.census import census_transform_pair
from i3dr_stereo_tpu_torch.ops.depth import disparity_to_depth
from i3dr_stereo_tpu_torch.ops.fused_cost_sgm import fused_census_sgm
from i3dr_stereo_tpu_torch.ops.lr_check import lr_consistency
from i3dr_stereo_tpu_torch.ops.median import median3x3, median3x3_masked
from i3dr_stereo_tpu_torch.ops.rectify import (make_rectify_map, remap,
                                               rectify_pair)
from i3dr_stereo_tpu_torch.ops.sgm import DIRECTIONS_4
from i3dr_stereo_tpu_torch.ops.sgm_fused_t import (census_cost,
                                                   right_disparity_from_C,
                                                   sgm_sweep, sgm_sweep_wta)
from i3dr_stereo_tpu_torch.ops.speckle import speckle_filter
from i3dr_stereo_tpu_torch.ops.wta import wta_disparity
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

H_FULL, W_FULL = 2048, 2448
# the rows of ``stages``, in order
STAGES = ("block_shift_warp", "census_transform_pair_9x9", "census_cost",
          "sgm_sweep_fwd", "sgm_sweep_rev", "sgm_sweep_down",
          "sgm_sweep_up_wta", "true_backmatch_wta", "speckle_ds2",
          "median3x3", "median3x3_masked", "rectify_cubic",
          "rectify_cubic_u8", "pyramid_resizes")


# ---------------------------------------------------------------------------
# inputs: copies of the root bench.py's
# ---------------------------------------------------------------------------

def _synthetic_pair(h, w, max_disp=128, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w + max_disp)).astype(np.float32)
    # cheap band-limit so census/BT have gradients
    img = 0.25 * (np.roll(img, 1, 1) + np.roll(img, -1, 1)
                  + np.roll(img, 1, 0) + np.roll(img, -1, 0))
    left = img[:, max_disp:]
    return left, np.roll(left, -max_disp // 4, axis=1)


def _layered_pair(h, w, max_disp=200, seed=1):
    """Depth-varying scene with occlusions and discontinuities: the
    flagship input (a constant-shift pair is the pyramid's best case)."""
    sc = layered_scene(h, w, max_disp=max_disp, background_disp=16,
                       layers=6, seed=seed)
    return sc.left, sc.right


def _flagship_cfg():
    return ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=256, max_pyramid_level=4,
        speckle_size=100, speckle_downsample=2, median_filter=True)


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of a rotation vector (what ``cv2.Rodrigues``
    gives; the card's machine has no OpenCV)."""
    r = np.asarray(rvec, dtype=np.float64)
    theta = np.linalg.norm(r)
    k = r / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.cos(theta) * np.eye(3) + (1 - np.cos(theta)) * np.outer(k, k)
            + np.sin(theta) * kx)


_K = np.array([[2400.0, 0, 1224.0], [0, 2400.0, 1024.0], [0, 0, 1]])
_D = np.array([-0.18, 0.06, 0.0008, -0.0006, 0.0])
_P = np.array([[2380.0, 0, 1220.0, 0], [0, 2380.0, 1022.0, 0], [0, 0, 1, 0]])


def distorted_rig(width=W_FULL, height=H_FULL) -> StereoRig:
    """The root script's real-shaped calibration (distortion and a
    rotation a view, a 0.3 m baseline) for ``width`` x ``height``."""
    Pr = _P.copy()
    Pr[0, 3] = -2380.0 * 0.3      # Tx = -fx * B
    return StereoRig(
        left=CameraModel(width, height, _K, _D,
                         rodrigues([0.004, -0.006, 0.002]), _P),
        right=CameraModel(width, height, _K, _D,
                          rodrigues([-0.003, 0.005, -0.002]), Pr))


def sgm_direct(left, right, D: int = 256, *, plain: bool = False):
    """The root script's ``sgm_direct_2448`` function: census 9x9 ->
    ``fused_census_sgm`` over D disparities (4 paths, P1/P2 10/120, int16
    mode) -> WTA (uniqueness 10, subpixel) -> min C < 255 -> LR check at
    1.5 -> speckle 100 / 0.5 at downsample 2; -10000 where invalid.
    ``plain`` runs the plain twins of the kernels on any device."""
    cl, cr = census_transform_pair(left, right, 9, 9, plain=plain)
    S, C = fused_census_sgm(cl, cr, D, base=0, p1=10.0, p2=120.0,
                            directions=DIRECTIONS_4, out_dtype=torch.int16,
                            plain=plain)
    disp, ok = wta_disparity(S, 0, uniqueness_ratio=10.0, subpixel=True)
    ok = ok & (C.amin(-1) < 255)
    del C
    disp, ok = lr_consistency(disp, ok, S.to(torch.float32), 0, 1.5)
    del S
    ok = speckle_filter(disp, ok, max_size=100, max_diff=0.5, downsample=2,
                        plain=plain)
    return torch.where(ok, disp, -10000.0)


# ---------------------------------------------------------------------------
# the device line and the timer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def device_line(dev: torch.device) -> str:
    """The card's name and power limit, e.g. ``NVIDIA H100 80GB HBM3,
    700.00 W``; ``cpu`` for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, check=True, timeout=60)
        limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "power limit not read"
    return f"{name}, {limit}"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(fn, dev: torch.device, iters: int, warmup: int = 2):
    """Time ``fn()``: ``host_s``, seconds a call by the host's clock over
    ``iters`` calls back to back closed by one synchronize; ``ms_events``,
    the median of ``iters`` calls each between two CUDA events (None on
    the CPU); ``launches``, the kernels one more call launched."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    ms_events = None
    if dev.type == "cuda":
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms_events = statistics.median(times)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    host_s = (time.perf_counter() - t0) / iters
    _build.reset_launches()
    fn()
    _sync(dev)
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    return SimpleNamespace(host_s=host_s, ms_events=ms_events,
                           launches=launches)


def _peak_gib(dev: torch.device):
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _line(metric, value, unit, dev, t, iters, size, **extra) -> dict:
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": None, "device": device_line(dev),
            "ms_events": t.ms_events, "peak_gib": _peak_gib(dev),
            "iters": iters, "launches": t.launches,
            "size": f"{size[1]}x{size[0]}", **extra}


def _on(dev, *images):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)[None]
            for x in images]


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------

def bench_flagship(dev, *, pair=_layered_pair,
                   metric="sgm_disparity_fps_2448x2048_256d_per_chip",
                   size=(H_FULL, W_FULL), iters=10):
    """2448x2048, 256 disparities through the 4-level pyramid
    (``MATCHER_REGISTRY[I3DRSGM]`` at :func:`_flagship_cfg`), on the
    layered scene (occlusions and discontinuities)."""
    cfg = _flagship_cfg()
    impl = MATCHER_REGISTRY[cfg.algorithm]
    L, R = _on(dev, *pair(*size))
    t = measure(lambda: impl(L, R, cfg).disparity, dev, iters)
    return [_line(metric, 1.0 / t.host_s, "frames/s", dev, t, iters, size)]


def bench_flagship_flat(dev, **kw):
    """The flagship on the constant-shift pair: every speckle tile is
    smooth."""
    return bench_flagship(dev, pair=_synthetic_pair,
                          metric="sgm_disparity_fps_2448x2048_256d_flat",
                          **kw)


def bench_sgbm_1280(dev, *, size=(1024, 1280), iters=10):
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
        disparity_range=128, window_size=5, speckle_size=0, num_directions=8)
    impl = MATCHER_REGISTRY[cfg.algorithm]
    L, R = _on(dev, *_synthetic_pair(*size))
    t = measure(lambda: impl(L, R, cfg).disparity, dev, iters)
    return [_line("sgbm8_fps_1280x1024_128d", 1.0 / t.host_s, "frames/s",
                  dev, t, iters, size)]


def bench_bm_640(dev, *, size=(480, 640), iters=20):
    cfg = ALGORITHM_DEFAULTS[Algorithm.BM].replace(disparity_range=64,
                                                   speckle_size=0)
    impl = MATCHER_REGISTRY[cfg.algorithm]
    L, R = _on(dev, *_synthetic_pair(*size))
    t = measure(lambda: impl(L, R, cfg).disparity, dev, iters)
    return [_line("bm_fps_640x480_64d", 1.0 / t.host_s, "frames/s", dev, t,
                  iters, size,
                  note="BM is plain torch in both packages: no kernel")]


def bench_pipeline_batch(dev, *, batch=16, size=(480, 640), iters=5):
    """``StereoPipeline`` (rectify -> SGBM -> depth, no points) on a
    16-frame batch of device-resident frames of the ideal rig."""
    H, W = size
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
        disparity_range=64, window_size=1, p1=8.0, p2=32.0, speckle_size=0)
    pipe = StereoPipeline(rig=StereoRig.synthetic(W, H, fx=500.0),
                          config=cfg, compute_points=False,
                          cloud=PointCloudConfig(depth_max=100.0), device=dev)
    l, r = _synthetic_pair(H, W)
    L = torch.from_numpy(np.broadcast_to(l, (batch, H, W)).copy()).to(dev)
    R = torch.from_numpy(np.broadcast_to(r, (batch, H, W)).copy()).to(dev)
    t = measure(lambda: pipe.process(L, R), dev, iters)
    return [_line("fused_pipeline_fps_640x480_64d_stream32x16",
                  batch / t.host_s, "frames/s", dev, t, iters, size,
                  batch=batch)]


def bench_sgm_direct_2448(dev, *, size=(H_FULL, W_FULL), disparities=256,
                          iters=3):
    """:func:`sgm_direct` over all 256 disparities at 2448x2048: what
    skipping the pyramid costs (a diagnostic, not the product's path)."""
    L, R = _on(dev, *_synthetic_pair(*size))
    t = measure(lambda: sgm_direct(L, R, disparities), dev, iters, warmup=1)
    return [_line("sgm_direct_bruteforce_fps_2448x2048_256d", 1.0 / t.host_s,
                  "frames/s", dev, t, iters, size, disparities=disparities)]


def _uploader(dev):
    """``put(array) -> (tensor, ready event or None)``: a uint8 frame to
    the device through pinned memory on a stream of its own."""
    if dev.type != "cuda":
        return lambda a: (torch.from_numpy(a), None)
    side = torch.cuda.Stream(dev)

    def put(a):
        host = torch.from_numpy(a).pin_memory()
        with torch.cuda.stream(side):
            x = host.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return x, ready

    return put


def _take(x, ready):
    if ready is not None:
        stream = torch.cuda.current_stream(x.device)
        stream.wait_event(ready)
        x.record_stream(stream)
    return x


def bench_e2e_2448(dev, *, pair=_layered_pair, size=(H_FULL, W_FULL), n=12,
                   iters=6):
    """A stream of uint8 numpy frames of the distorted rig (3 layered
    scenes in turn) into ``StereoPipeline.process`` (bicubic rectify ->
    the flagship pyramid -> depth to 100 m, no points), the upload inside
    the timed loop and one synchronize at its end: serially, and with a
    transfer thread uploading frame i+1 through pinned memory on its own
    stream while frame i is dispatched. Also the rates of the upload
    alone, of the rectification alone, of the match and depth alone and
    of the whole frame on device-resident images."""
    H, W = size
    cfg = _flagship_cfg()
    impl = MATCHER_REGISTRY[cfg.algorithm]
    pipe = StereoPipeline(rig=distorted_rig(W, H), config=cfg,
                          rectify_inputs=True, compute_points=False,
                          cloud=PointCloudConfig(depth_max=100.0), device=dev)
    frames = [tuple(x.astype(np.uint8) for x in pair(H, W, seed=10 + i))
              for i in range(3)]

    def run_stream(k, compute=True):
        outs = []
        t0 = time.perf_counter()
        for i in range(k):
            l, r = frames[i % len(frames)]
            if compute:
                outs.append(pipe.process(l, r).depth)
            else:
                outs.append((torch.as_tensor(l, device=dev),
                             torch.as_tensor(r, device=dev)))
        _sync(dev)
        return (time.perf_counter() - t0) / k

    put = _uploader(dev)

    def run_overlapped(k):
        outs = []
        with ThreadPoolExecutor(1) as ex:
            t0 = time.perf_counter()
            fut = ex.submit(lambda f: (put(f[0]), put(f[1])), frames[0])
            for i in range(k):
                (L, lr), (R, rr) = fut.result()
                if i + 1 < k:
                    fut = ex.submit(lambda f: (put(f[0]), put(f[1])),
                                    frames[(i + 1) % len(frames)])
                outs.append(pipe.process(_take(L, lr), _take(R, rr)).depth)
            _sync(dev)
            return (time.perf_counter() - t0) / k

    run_stream(2)                 # warm both paths
    run_stream(2, False)
    run_overlapped(2)
    e2e, e2e_ov, ingest = run_stream(n), run_overlapped(n), run_stream(n, False)
    L0, R0 = (torch.as_tensor(x, device=dev) for x in frames[0])
    t_rect = measure(lambda: rectify_pair(L0, R0, pipe._lmap, pipe._rmap),
                     dev, iters)
    lr0, rr0 = rectify_pair(L0, R0, pipe._lmap, pipe._rmap)

    def match_depth():
        res = impl(lr0, rr0, cfg)
        return disparity_to_depth(res.disparity, res.valid, pipe._Q,
                                  0.0, 100.0)[0]

    t_md = measure(match_depth, dev, iters)
    t_frame = measure(lambda: pipe.process(L0, R0).depth, dev, iters)
    fps = max(1.0 / e2e, 1.0 / e2e_ov)
    return [_line(
        "e2e_fps_2448x2048_ingest_rectify_pyramidSGM_depth", fps,
        "frames/s", dev, t_frame, iters, size,
        e2e_serial_fps=1.0 / e2e, e2e_overlapped_fps=1.0 / e2e_ov,
        overlap_vs_ingest_only=ingest / e2e_ov,
        ingest_only_fps=1.0 / ingest,
        rectify_only_fps=1.0 / t_rect.host_s,
        rectify_only_ms_events=t_rect.ms_events,
        match_depth_only_fps=1.0 / t_md.host_s,
        match_depth_only_ms_events=t_md.ms_events,
        fused_compute_fps=1.0 / t_frame.host_s, frames_a_stream=n,
        note="ms_events, launches and fused_compute_fps: the whole frame "
             "(process) on device-resident uint8 images")]


def bench_stages(dev, *, pair=_layered_pair, size=(H_FULL, W_FULL),
                 iters=10):
    """The flagship's level-0 stages one by one at 2448x2048 padded to
    2560x2048, D = 32, on the layered pair: one row a stage (ms a call)
    and their sum. Each in-place sweep is timed on a scratch copy of the
    running sum; the disparities the later stages read come from one
    chain of the sweeps."""
    H, W = size
    D = 32
    Hp, Wp = -(-H // 128) * 128, -(-W // 128) * 128
    pen = (8.0, 64.0)
    L, R = _on(dev, *pair(H, W))
    Lp = pad_edge(L, Hp, Wp).contiguous()
    Rp = pad_edge(R, Hp, Wp).contiguous()
    rows = {}

    def stage(name, fn, n=iters):
        rows[name] = (measure(fn, dev, n), n)

    pred = torch.full((1, Hp, Wp), 20, dtype=torch.int32, device=dev)

    def warp():
        q = block_anchors(pred)
        q_up = q.repeat_interleave(8, 1).repeat_interleave(128, 2)
        pe = torch.minimum(torch.maximum(pred, q_up - D // 2),
                           q_up + D // 2).contiguous()
        return block_shift_gather(Rp, pe, q, D // 2)

    stage("block_shift_warp", warp)
    Rw = warp()
    stage("census_transform_pair_9x9",
          lambda: census_transform_pair(Lp, Rw, 9, 9))
    cl, cr = census_transform_pair(Lp, Rw, 9, 9)
    bpm = -D // 2
    stage("census_cost", lambda: census_cost(cl, cr, D, bpm=bpm, H_real=H,
                                             W_real=W))
    C, _ = census_cost(cl, cr, D, bpm=bpm, H_real=H, W_real=W)
    stage("sgm_sweep_fwd", lambda: sgm_sweep(C, 0, 1, *pen, "i16_new"))
    acc = sgm_sweep(C, 0, 1, *pen, "i16_new")
    scratch = acc.clone()
    stage("sgm_sweep_rev",
          lambda: sgm_sweep(C, 0, -1, *pen, "i16_addf", scratch))
    sgm_sweep(C, 0, -1, *pen, "i16_addf", acc)
    scratch.copy_(acc)
    stage("sgm_sweep_down",
          lambda: sgm_sweep(C, 1, 0, *pen, "i16_addi", scratch))
    sgm_sweep(C, 1, 0, *pen, "i16_addi", acc)
    stage("sgm_sweep_up_wta",
          lambda: sgm_sweep_wta(C, -1, 0, *pen, acc, subpixel=True))
    disp = sgm_sweep_wta(C, -1, 0, *pen, acc, subpixel=True)[:, :H, :W]
    stage("true_backmatch_wta",
          lambda: right_disparity_from_C(C, bpm, W)[0], max(iters // 2, 1))
    disp = disp.contiguous()
    valid = disp > -1e8
    stage("speckle_ds2",
          lambda: speckle_filter(disp, valid, max_size=100, max_diff=0.5,
                                 downsample=2))
    stage("median3x3", lambda: median3x3(disp))
    stage("median3x3_masked", lambda: median3x3_masked(disp, valid))
    cam = CameraModel(W, H, _K, _D, rodrigues([0.004, -0.006, 0.002]), _P)
    rmap = make_rectify_map(cam, interpolation="cubic", device=dev)
    stage("rectify_cubic", lambda: remap(L[0], rmap))
    L8 = L[0].clamp(0, 255).to(torch.uint8)
    stage("rectify_cubic_u8", lambda: remap(L8, rmap))

    def pyramid_resizes():
        a = _downsample2(L)
        b = _downsample2(a)
        c = _downsample2(b)
        d = _upsample2_disp(c, b.shape[1], b.shape[2])
        e = _upsample2_disp(d, a.shape[1], a.shape[2])
        return _upsample2_disp(e, L.shape[1], L.shape[2])

    stage("pyramid_resizes", pyramid_resizes)
    lines = [_line(f"stage_{k}_ms", t.host_s * 1e3, "ms", dev, t, n, size)
             for k, (t, n) in rows.items()]
    ts = [t for t, _ in rows.values()]
    launches = {}
    for t in ts:
        for k, c in t.launches.items():
            launches[k] = launches.get(k, 0) + c
    total = SimpleNamespace(
        ms_events=None if dev.type != "cuda" else sum(t.ms_events
                                                      for t in ts),
        launches=launches)
    lines.append(_line("stages_sum_L0_ms", sum(x["value"] for x in lines),
                       "ms", dev, total, iters, size))
    return lines


BENCHES = {
    "flagship": bench_flagship,
    "e2e_2448": bench_e2e_2448,
    "flagship_flat": bench_flagship_flat,
    "sgbm_1280": bench_sgbm_1280,
    "bm_640": bench_bm_640,
    "pipeline_batch": bench_pipeline_batch,
    "sgm_direct_2448": bench_sgm_direct_2448,
    "stages": bench_stages,
}


def run(config: str = "flagship", device="cuda") -> int:
    """Run ``config`` (a name of :data:`BENCHES`, or ``all``) on
    ``device`` and print its lines. A configuration that raises prints
    its traceback to stderr and no line; the others still run. Returns 0
    when every configuration ran, else 1. A CUDA device that is not
    there raises before anything runs."""
    dev = _build.resolve_device(device)
    names = list(BENCHES) if config == "all" else [config]
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        raise ValueError(f"unknown bench config {unknown[0]!r}: expected "
                         f"one of {', '.join(BENCHES)} or all")
    failed = []
    for name in names:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            lines = BENCHES[name](dev)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            print(f"bench {name}: failed", file=sys.stderr, flush=True)
            failed.append(name)
            continue
        for line in lines:
            print(json.dumps({"config": name, **line}), flush=True)
    return 1 if failed else 0
