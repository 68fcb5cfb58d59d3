#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. It imports nothing of JAX and
nothing of the JAX package. In order, and failing (non-zero exit, no
final result line) on the first thing that is wrong:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds every kernel of the port from ``i3dr_stereo_tpu_torch/csrc``;
3. runs each kernel against its plain torch twin on the card: at every
   level of the flagship pyramid at its own shape (2448x2048, 1224x1024,
   612x512 and 306x256, padded to multiples of 128; D = 32, NW = 3,
   4 paths, P1/P2 = 0.1/0.8, bpm = -16 with the warp gather, and the
   coarsest level unwarped from the minimum disparity; subpixel on level
   0), with each level's radius-17 backmatch gather, and at small ragged
   shapes with bpm > 0 and bpm < 0 and 4 and 8 paths; costs and path
   sums must be bit-equal, valid masks identical, disparities within
   1e-4, gathers bit-equal;
4. drives ``StereoPipeline(device="cuda")`` on a 2448x2048 layered scene
   at the flagship configuration (speckle off, inputs already rectified):
   every kernel must launch during that run, the median error against
   ground truth must be below 0.25 px, and the same matcher through the
   plain twins on the card must agree at 256x320;
5. times the kernel path (CUDA events, median of 10 frames after
   warm-up) and the plain path (once), each with the card's name and
   power limit;
6. profiles five back-to-back frames: device busy time, idle share and
   the device time of the largest kernels, all from that one window.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H_FULL, W_FULL = 2048, 2448
DEVICE = "cuda"
# the flagship input of bench.py:_layered_pair
SCENE = dict(max_disp=200, background_disp=16, layers=6, seed=1)
TOL_DISP = 1e-4          # kernel vs twin, per pixel valid in both
TOL_PATH_DISP = 1e-3     # whole matcher, kernels vs twins
MIN_VALID_AGREE = 0.999
MAX_MEDIAN_ERR = 0.25    # the repo's accuracy gate (px)

SOURCES = {
    "census_cost": ("i3dr_stereo_tpu_torch/csrc/census_cost.cu",
                    "i3dr_stereo_tpu/ops/sgm_fused_t.py:187"),
    "sgm_path": ("i3dr_stereo_tpu_torch/csrc/sgm_path.cu",
                 "i3dr_stereo_tpu/ops/sgm_fused_t.py:187,242,318,423"),
    "sum_wta": ("i3dr_stereo_tpu_torch/csrc/sum_wta.cu",
                "i3dr_stereo_tpu/ops/sgm_fused_t.py:423"),
    "row_gather": ("i3dr_stereo_tpu_torch/csrc/row_gather.cu",
                   "i3dr_stereo_tpu/ops/block_gather.py:109"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median per-call device time of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flagship_cfg(params):
    """``bench.py:_flagship_cfg`` with the speckle filter off (kernel F is
    not ported yet)."""
    return params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM].replace(
        disparity_range=256, max_pyramid_level=4, speckle_size=0,
        speckle_downsample=2, median_filter=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain twins
# ---------------------------------------------------------------------------

def compare_gather(bg, src, idx, q, r, label, stats):
    """row_gather vs its twin, bit-equal."""
    out = bg.block_shift_gather(src, idx, q, r)
    ref = bg.block_shift_gather_plain(src, idx, q, r)
    torch.cuda.synchronize()
    stats["row_gather"]["err"] = max(stats["row_gather"]["err"],
                                     (out - ref).abs().max().item())
    check(torch.equal(out, ref), f"{label}: row_gather differs from its twin")
    return out


def compare_level(sf, bg, cl, cr, *, bpm, H_real, W_real, directions, ur,
                  pens, label, stats, subpixel=True, time_it=False):
    """census_cost, every sgm_path direction and sum_wta vs their twins,
    then the backmatch lookup (row_gather at radius D/2 + 1 around the
    window midpoint) on the level's own right-anchored disparities."""
    D = 32
    C = sf.census_cost(cl, cr, D, bpm=bpm, H_real=H_real, W_real=W_real)
    Cp = sf.census_cost_plain(cl, cr, D, bpm=bpm, H_real=H_real,
                              W_real=W_real)
    torch.cuda.synchronize()
    check(torch.equal(C, Cp), f"{label}: census_cost differs from its twin")
    stats["census_cost"]["err"] = max(
        stats["census_cost"]["err"],
        int((C.int() - Cp.int()).abs().max().item()))

    dirs = (sf.DIRECTIONS_4 if directions == 4 else sf.DIRECTIONS_8)
    down = [d for d in sf._DOWN if d in dirs]
    up = [d for d in sf._UP if d in dirs]
    order = [(0, 1), (0, -1)] + down + up
    pen = dict(zip(dirs, pens))
    parts = []
    for dy, dx in order:
        k = sf.sgm_path(C, dy, dx, *pen[(dy, dx)])
        p = sf.sgm_path_plain(C, dy, dx, *pen[(dy, dx)])
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        stats["sgm_path"]["err"] = max(stats["sgm_path"]["err"], err)
        check(torch.equal(k, p),
              f"{label}: sgm_path {(dy, dx)} differs (max {err})")
        parts.append(k)
    d = sf.sum_wta(C, parts, len(down), len(up), subpixel=subpixel,
                   uniqueness_ratio=ur)
    dp = sf.sum_wta_plain(C, parts, len(down), len(up), subpixel=subpixel,
                          uniqueness_ratio=ur)
    torch.cuda.synchronize()
    v, vp = d > -1e8, dp > -1e8
    check(torch.equal(v, vp), f"{label}: sum_wta valid masks differ "
          f"({(v != vp).sum().item()} px)")
    err = (d - dp)[v].abs().max().item() if v.any() else 0.0
    stats["sum_wta"]["err"] = max(stats["sum_wta"]["err"], err)
    check(err <= TOL_DISP, f"{label}: sum_wta |dd| {err} > {TOL_DISP}")

    # backmatch lookup as matchers/pyramid.py:_backmatch_check_true makes it
    B, Hp, Wp, _ = C.shape
    r_res = torch.where(v, d + float(bpm), 0.0)
    d_r, v_r = sf.right_disparity_from_C(C, bpm, W_real)
    q = torch.full((B, -(-Hp // 8), -(-Wp // 128)), bpm + D // 2,
                   dtype=torch.int32, device=C.device)
    compare_gather(bg, torch.where(v_r, d_r, 1.0e9).contiguous(),
                   torch.round(r_res).to(torch.int32).contiguous(), q,
                   D // 2 + 1, f"{label} backmatch", stats)
    print(f"{label}: census_cost, {len(order)} sgm_path directions, "
          f"sum_wta and the radius-{D // 2 + 1} backmatch gather match their "
          f"twins (valid {v.float().mean().item():.4f}, max |dd| {err})",
          flush=True)

    if time_it:
        kw = dict(bpm=bpm, H_real=H_real, W_real=W_real)
        stats["census_cost"]["ms"] = gpu_ms(
            lambda: sf.census_cost(cl, cr, D, **kw))
        stats["census_cost"]["plain_ms"] = gpu_ms(
            lambda: sf.census_cost_plain(cl, cr, D, **kw), iters=1, warmup=0)
        per_dir = [gpu_ms(lambda o=o: sf.sgm_path(C, *o, *pen[o]))
                   for o in order]
        per_dir_plain = [gpu_ms(lambda o=o: sf.sgm_path_plain(C, *o, *pen[o]),
                                iters=1, warmup=0) for o in order]
        stats["sgm_path"]["ms"] = sum(per_dir) / len(per_dir)
        stats["sgm_path"]["plain_ms"] = sum(per_dir_plain) / len(per_dir)
        print("sgm_path ms per direction " + ", ".join(
            f"{o}: {a:.3f} (plain {b:.1f})"
            for o, a, b in zip(order, per_dir, per_dir_plain)), flush=True)
        wkw = dict(subpixel=subpixel, uniqueness_ratio=ur)
        stats["sum_wta"]["ms"] = gpu_ms(
            lambda: sf.sum_wta(C, parts, len(down), len(up), **wkw))
        stats["sum_wta"]["plain_ms"] = gpu_ms(
            lambda: sf.sum_wta_plain(C, parts, len(down), len(up), **wkw),
            iters=1, warmup=0)


def phase_kernels(stats):
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops import sgm_fused_t as sf
    from i3dr_stereo_tpu_torch.ops.census import census_transform

    dev = torch.device(DEVICE)
    cfg = flagship_cfg(params)

    # E: random indices and anchors that hit both clamps, bit-equal
    rng = np.random.default_rng(0)
    B, H, W = 2, 64, 300
    src = torch.tensor(rng.uniform(0, 255, (B, H, W)), dtype=torch.float32,
                       device=dev)
    idx = torch.tensor(rng.integers(-60, W + 60, (B, H, W)),
                       dtype=torch.int32, device=dev)
    q = torch.tensor(rng.integers(-20, W + 20, (B, H // 8, (W + 127) // 128)),
                     dtype=torch.int32, device=dev)
    compare_gather(bg, src, idx, q, 17, "random idx/q", stats)
    print("row_gather (random idx/q, both clamps): bit-equal", flush=True)

    # every level of the flagship pyramid at its own shape (padded to
    # multiples of 128, ragged W_real/H_real), built as pyramid_sgm_match
    # builds it; the prediction that warps the right view is the
    # downsampled ground truth, clamped to its block anchors
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    l = torch.tensor(sc.left, device=dev)[None]
    r = torch.tensor(sc.right, device=dev)[None]
    gt = torch.tensor(sc.disparity, device=dev)[None]
    n_levels = cfg.max_pyramid_level
    pens = [(cfg.p1, cfg.p2)] * 4
    for level in range(n_levels):
        if level:
            l, r, gt = (pyr._downsample2(l), pyr._downsample2(r),
                        pyr._downsample2(gt))
        _, Hh, Wh = l.shape
        Hp, Wp = -(-Hh // 128) * 128, -(-Wh // 128) * 128
        lp, rp = bg.pad_edge(l, Hp, Wp), bg.pad_edge(r, Hp, Wp)
        if level == n_levels - 1:
            # the coarsest level searches from the minimum disparity
            bpm = int(round(cfg.min_disparity / 2 ** level))
            rw = rp
        else:
            pred = bg.pad_edge(torch.round(gt / 2 ** level).to(torch.int32)
                               .clamp(0, Wh - 1), Hp, Wp)
            q = bg.block_anchors(pred)
            q_up = q.repeat_interleave(8, 1).repeat_interleave(128, 2)
            pred_eff = torch.minimum(torch.maximum(pred, q_up - 16),
                                     q_up + 16).contiguous()
            rp = rp.contiguous()
            rw = compare_gather(bg, rp, pred_eff, q, 16, f"level {level} warp",
                                stats)
            bpm = -16
            if level == 0:
                stats["row_gather"]["ms"] = gpu_ms(
                    lambda: bg.block_shift_gather(rp, pred_eff, q, 16))
                stats["row_gather"]["plain_ms"] = gpu_ms(
                    lambda: bg.block_shift_gather_plain(rp, pred_eff, q, 16),
                    iters=1, warmup=0)
        compare_level(
            sf, bg, census_transform(lp, cfg.census_height, cfg.census_width),
            census_transform(rw, cfg.census_height, cfg.census_width),
            bpm=bpm, H_real=Hh, W_real=Wh, directions=4,
            ur=cfg.uniqueness_ratio, pens=pens,
            label=f"level {level} {Wh}x{Hh} in {Wp}x{Hp} D=32 bpm={bpm}",
            stats=stats, subpixel=(level == 0 and cfg.subpixel),
            time_it=(level == 0))

    # small ragged shapes, both signs of bpm, 4 and 8 paths, uniqueness on
    for bpm, dirs, ur in ((5, 4, 0.0), (-7, 8, 10.0), (0, 8, 0.0)):
        a = torch.tensor(rng.uniform(0, 255, (2, 48, 136)),
                         dtype=torch.float32, device=dev)
        b = torch.roll(a, -3, 2) + torch.tensor(
            rng.normal(0, 4, a.shape), dtype=torch.float32, device=dev)
        pens = [(float(rng.uniform(0.05, 2)), float(rng.uniform(2, 9)))
                for _ in range(dirs)]
        compare_level(sf, bg, census_transform(a, 9, 9),
                      census_transform(b, 9, 9), bpm=bpm, H_real=45,
                      W_real=131, directions=dirs, ur=ur, pens=pens,
                      label=f"ragged 45x131 in 48x136 bpm={bpm} "
                            f"paths={dirs} ur={ur}", stats=stats)


# ---------------------------------------------------------------------------
# phase 4 + 5: the main path at full width
# ---------------------------------------------------------------------------

def phase_main_path(stats, card):
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.core.camera import StereoRig
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    cfg = flagship_cfg(params)
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    rig = StereoRig.synthetic(W_FULL, H_FULL, fx=580.0, baseline_m=0.3)
    # fx*T = 174: a 0.5..100 m window keeps disparities 1.7..348 px, so
    # the depth clamp leaves the scene's 16..200 px whole
    cloud = params.PointCloudConfig(depth_max=100.0, depth_min=0.5)
    pipe = StereoPipeline(rig, cfg, cloud, device=DEVICE, compute_depth=True,
                          compute_points=True, compute_crop=True)
    left = torch.tensor(sc.left, device=DEVICE)
    right = torch.tensor(sc.right, device=DEVICE)

    pipe.process(left, right)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    res = pipe.process(left, right)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"main path launches at {W_FULL}x{H_FULL}: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} did not launch on the main path")
        stats[name]["launches"] = n

    d = res.disparity.cpu().numpy()
    v = res.valid.cpu().numpy()
    check(d.shape == (H_FULL, W_FULL) and v.shape == d.shape,
          f"disparity shape {d.shape}")
    check(bool(np.isfinite(d[v]).all()), "non-finite valid disparities")
    check(res.depth is not None and bool(torch.isfinite(res.depth).all()),
          "non-finite depth")
    check(tuple(res.points["xyz"].shape) == (H_FULL * W_FULL, 3),
          "point cloud shape")
    both = v & sc.valid
    density = float(v.mean())
    med = float(np.median(np.abs(d - sc.disparity)[both]))
    print(f"main path accuracy: density {density:.4f}, GT-valid coverage "
          f"{both.sum() / sc.valid.sum():.4f}, median |d - GT| {med:.4f} px",
          flush=True)
    check(density > 0.5, f"density {density} too low")
    check(med < MAX_MEDIAN_ERR, f"median error {med} >= {MAX_MEDIAN_ERR}")

    # the same matcher through the plain twins on the card, small scene
    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=DEVICE)
    rs = torch.tensor(small.right, device=DEVICE)
    mk = pyramid_sgm_match(ls, rs, cfg)
    mp = pyramid_sgm_match(ls, rs, cfg, plain=True)
    agree = (mk.valid == mp.valid).float().mean().item()
    vb = mk.valid & mp.valid
    dd = (mk.disparity - mp.disparity)[vb].abs().max().item()
    print(f"256x320 kernels vs twins: valid agreement {agree:.6f}, max |dd| "
          f"{dd}", flush=True)
    check(agree >= MIN_VALID_AGREE, f"valid agreement {agree}")
    check(dd <= TOL_PATH_DISP, f"|dd| {dd} > {TOL_PATH_DISP}")

    # timing
    frame_ms = gpu_ms(lambda: pipe.process(left, right), iters=10, warmup=1)
    match_ms = gpu_ms(lambda: pyramid_sgm_match(left, right, cfg), iters=10,
                      warmup=1)
    plain_match_ms = gpu_ms(
        lambda: pyramid_sgm_match(left, right, cfg, plain=True),
        iters=1, warmup=0)
    print(f"timing [{card}]: pipeline {frame_ms:.3f} ms/frame "
          f"({1000 / frame_ms:.2f} FPS), matcher kernels {match_ms:.3f} ms, "
          f"matcher plain twins {plain_match_ms:.1f} ms at "
          f"{W_FULL}x{H_FULL}", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    return pipe, left, right


# ---------------------------------------------------------------------------
# phase 6: where the frame's time goes
# ---------------------------------------------------------------------------

def phase_profile(pipe, left, right, card, frames: int = 5):
    """Device busy time and idle share over one window of ``frames``
    back-to-back frames, both from the same window: busy is the union of
    the device activity spans the profiler records (device activity only,
    so the host runs as unprofiled as the profiler allows), wall is the
    host clock around the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            pipe.process(left, right)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(len(spans) > 0, "the profiler recorded no device activity")
    busy = 0.0
    end = float("-inf")
    per_name: dict[str, list] = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        acc = per_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e - s
    busy /= 1e3                                   # us -> ms
    ours = sum(t for n, (_, t) in per_name.items()
               if any(k + "_kernel" in n for k in SOURCES)) / 1e3
    htod = sum(n for name, (n, _) in per_name.items()
               if name.startswith("Memcpy HtoD"))
    print(f"profile [{card}]: {frames} frames, wall {wall / frames:.3f} "
          f"ms/frame (profiler on), device busy {busy / frames:.3f} ms/frame "
          f"({len(spans) / frames:.0f} device activities per frame, "
          f"{htod / frames:.0f} of them host-to-device copies), idle "
          f"share {1 - busy / wall:.4f}; the port's kernels "
          f"{ours / frames:.3f} ms/frame", flush=True)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, t) in top:
        print(f"  {t / 1e3 / frames:8.3f} ms/frame {n // frames:5d}x  "
              f"{name[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from i3dr_stereo_tpu_torch import _build

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = (lib.parent / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    stats = {k: {"err": 0.0, "ms": None, "plain_ms": None, "launches": 0}
             for k in SOURCES}
    phase_kernels(stats)
    phase_profile(*phase_main_path(stats, card), card)

    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], "launches": s["launches"],
                "max_abs_err": s["err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"]} for k, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
