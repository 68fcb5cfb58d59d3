#!/usr/bin/env python3
"""The flagship SGM stage, the two census-cost kernels and both flagship
frames of one or more checkouts of the PyTorch + CUDA port, measured in
turns on one NVIDIA GPU.

    python3 sgm_stage_bench.py [ROOT ...]

Each ROOT is a directory that holds an ``i3dr_stereo_tpu_torch`` package
(this checkout when none is given). To compare a change with its parent,
unpack the parent beside the change (``git archive <commit> | tar -x -C
DIR``) and name the roots in turns: ``DIR . . DIR``. Every ROOT runs in a
process of its own, builds its own kernels and prints one JSON line; the
scene, the level-0 inputs, the timing and the profile window are
``chip_smoke.py``'s of this checkout, so only the package differs.

Per ROOT, with the card's name and power limit:

- level 0 of the flagship pyramid (2448x2048 padded to 2560x2048, D = 32,
  4 paths): ``census_cost`` alone and ``census_sgm_wta`` whole (CUDA
  events, median of 10), their difference (the SGM stage, whatever
  kernels the checkout runs it in), and the peak memory of one call above
  what was allocated before it;
- level 0 of the lean pyramid (2448x2048, D = 32, base -16):
  ``fused_census_fwd`` with the float32 path costs the lean frame asks
  for (median of 10), and a digest of its C and S;
- the flagship frame and the lean flagship frame (raw uint8 -> rectify ->
  pyramid with speckle -> depth, cloud, crop): ms/frame (median of 10),
  peak memory, and ``chip_smoke.py``'s five-frame profile (device busy,
  idle share, activities a frame, the largest kernels), from which the
  summary takes device busy and the two census kernels' time a frame;
- a digest of each frame's disparity and valid mask; the last line says
  whether all roots gave the same digests.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the census-cost kernels' names in a profile: census_cost, and the fused
# census forward pass in either of its kernels
CENSUS_SYMBOLS = ("census_cost_kernel", "census32_kernel", "CensusCost")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs
    from i3dr_stereo_tpu_torch.ops import sgm_fused_t as sf
    from i3dr_stereo_tpu_torch.ops.census import census_transform

    card = cs.card_line()
    _build.library()
    cfg = cs.flagship_cfg(params)
    sc = layered_scene(cs.H_FULL, cs.W_FULL, **cs.SCENE)
    out = {"root": str(root), "card": card}

    # level 0 as the pyramid builds it
    _, lp, rp, pred, q, bpm, Hh, Wh = next(cs.flagship_levels(cfg, sc))
    rw = bg.block_shift_gather(rp, pred, q, 16)
    cl = census_transform(lp, cfg.census_height, cfg.census_width)
    cr = census_transform(rw, cfg.census_height, cfg.census_width)
    del lp, rp, rw, pred
    kw = dict(bpm=bpm, H_real=Hh, W_real=Wh)
    skw = dict(pens=[(cfg.p1, cfg.p2)] * 4, directions=4, subpixel=True,
               uniqueness_ratio=cfg.uniqueness_ratio, **kw)
    out["census_cost_ms"] = cs.gpu_ms(lambda: sf.census_cost(cl, cr, 32, **kw))
    out["census_sgm_wta_ms"] = cs.gpu_ms(
        lambda: sf.census_sgm_wta(cl, cr, 32, **skw))
    out["stage_ms"] = out["census_sgm_wta_ms"] - out["census_cost_ms"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d, _ = sf.census_sgm_wta(cl, cr, 32, **skw)
    torch.cuda.synchronize()
    out["level0_peak_gib"] = (torch.cuda.max_memory_allocated()
                              - before) / 2**30
    out["level0_digest"] = hashlib.sha256(
        d.cpu().numpy().tobytes()).hexdigest()[:16]
    del d
    del cl, cr
    torch.cuda.empty_cache()

    # level 0 of the lean pyramid
    _, cl, cr, base, _, _ = next(cs.lean_levels(cfg, sc))
    clw, crw = fcs.census_word_planes(cl), fcs.census_word_planes(cr)
    H8 = cl.shape[1]
    del cl, cr
    bases = torch.full((H8 // fcs.row_tile(H8),), base, dtype=torch.int32,
                       device=cs.DEVICE)
    fused = lambda: fcs.fused_census_horizontal(
        clw, crw, bases, 32, cfg.p1, cfg.p2, out_dtype=torch.float32)
    out["fused_census_fwd_ms"] = cs.gpu_ms(fused)
    digest = hashlib.sha256()
    for t in fused():
        digest.update(t.cpu().numpy().tobytes())
    out["lean_level0_digest"] = digest.hexdigest()[:16]
    del clw, crw, t
    torch.cuda.empty_cache()

    # the two flagship frames
    for name, lean in (("frame", False), ("lean_frame", True)):
        pipe, left, right, sc, cfg, _ = cs.flagship_pipe(lean=lean)
        torch.cuda.reset_peak_memory_stats()
        res = cs.drive_frame(pipe, left, right, sc, (),
                             f"{root.name} {name}", {})
        out[f"{name}_launches"] = dict(_build.LAUNCHES)
        out[f"{name}_digest"] = hashlib.sha256(
            res.disparity.cpu().numpy().tobytes()
            + res.valid.cpu().numpy().tobytes()).hexdigest()[:16]
        out[f"{name}_ms"] = cs.gpu_ms(lambda: pipe.process(left, right),
                                      iters=10, warmup=1)
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        prof = cs.phase_profile(pipe, left, right, card,
                                label=f"{root.name} {name}")
        out[f"{name}_busy_ms"] = prof["busy_ms"]
        out[f"{name}_idle_share"] = prof["idle_share"]
        out[f"{name}_census_kernels_ms"] = sum(
            ms for k, ms in prof["kernels_ms"].items()
            if any(sym in k for sym in CENSUS_SYMBOLS))
        del pipe, res
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print("RESULT " + json.dumps(measure(Path(sys.argv[2]).resolve())),
              flush=True)
        return 0
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [HERE]
    results = []
    for root in roots:
        print(f"=== {root}", flush=True)
        run = subprocess.run([sys.executable, __file__, "--one", str(root)],
                             capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], flush=True)
            return 1
        results.append(json.loads(
            [l for l in run.stdout.splitlines()
             if l.startswith("RESULT ")][-1][7:]))
    for r in results:
        print(f"{r['root']} [{r['card']}]: census_cost at level 0 "
              f"{r['census_cost_ms']:.4f} ms, SGM stage "
              f"{r['stage_ms']:.4f} ms by events ({r['census_sgm_wta_ms']:.4f}"
              f" - census_cost), level-0 peak {r['level0_peak_gib']:.3f} GiB;"
              f" fused_census_fwd at lean level 0 "
              f"{r['fused_census_fwd_ms']:.4f} ms", flush=True)
        for name, kernel in (("frame", "census_cost"),
                             ("lean_frame", "fused_census_fwd")):
            print(f"  {name}: {r[name + '_ms']:.3f} ms/frame, device busy "
                  f"{r[name + '_busy_ms']:.3f} ms/frame (idle share "
                  f"{r[name + '_idle_share']:.4f}), {kernel} "
                  f"{r[name + '_census_kernels_ms']:.3f} ms/frame of it, "
                  f"peak {r[name + '_peak_gib']:.2f} GiB", flush=True)
    same = all(len({r[k] for r in results}) == 1
               for k in ("frame_digest", "lean_frame_digest",
                         "level0_digest", "lean_level0_digest"))
    print(f"disparities of both frames and both level-0 outputs of all "
          f"roots bit-equal: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
