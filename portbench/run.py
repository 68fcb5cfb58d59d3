"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload i3drsgm_2448.replay --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout. The cell's configuration, traffic mix and
metric readers are found by name (:mod:`portbench.manifest`). The run
makes its inputs from the seed on the card, launches the
stereo_matcher graph (``bridge/launch.py:launch_stereo_matcher``) with
rectification, depth and the point cloud, warms it up, drives it for
``--seconds`` with the mix's load (:mod:`portbench.load`), then, once the
window has closed and the program is freed, compares what the graph
published for the sampled frames with the plain reference
(:mod:`portbench.check`). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, which are also the
last lines of standard error.

Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BANNED = ("jax", "jaxlib", "flax", "i3dr_stereo_tpu")


def process_age() -> float | None:
    """Seconds since this process started, from the kernel's records
    (so the interpreter's start and the imports count), or None."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_T0 = time.perf_counter()
_AGE0 = process_age()


def since_start() -> float:
    base = _AGE0 if _AGE0 is not None else 0.0
    return base + (time.perf_counter() - _T0)


def process_cpu_s() -> float:
    """CPU seconds this process has used, all its threads."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def set_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own ``_build.py`` keeps its library in its ``_kernels/``)."""
    base = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def program_rig(rig: dict):
    from i3dr_stereo_tpu_torch.core.camera import CameraModel, StereoRig

    from portbench.reference.rectify import cameras

    l, r = cameras(rig)
    cam = lambda c: CameraModel(c["width"], c["height"], c["K"], c["D"],
                                c["R"], c["P"])
    return StereoRig(cam(l), cam(r))


def program_config(block: dict):
    from i3dr_stereo_tpu_torch.config.params import (Algorithm, CostFunction,
                                                     MatcherConfig)

    kw = dict(block, algorithm=Algorithm[block["algorithm"]],
              cost=CostFunction(block["cost"]))
    cfg = MatcherConfig(**kw)
    if cfg.sanitize() != cfg:
        raise ValueError("the configuration file's matcher block is not "
                         "in the form the program runs it (sanitize)")
    return cfg


def launch(config: dict, device):
    from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_matcher
    from i3dr_stereo_tpu_torch.config.params import PointCloudConfig

    cfg = program_config(config["matcher"])
    lg = launch_stereo_matcher(
        program_rig(config["rig"]), stereo_algorithm=cfg.algorithm,
        config=cfg, cloud=PointCloudConfig(**config["cloud"]),
        rectify_inputs=True, device=device)
    return lg, lg.node("generate_disparity").pipeline


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(root: Path, cell, seed: int, seconds: float, trace: bool,
             device="cuda", log=print) -> dict:
    """Everything of one run but the printing: the result's keys, the
    compared numbers and their limits."""
    import torch

    from portbench import check, inputs, load, manifest
    from portbench import trace as tr
    from portbench.reference.pipeline import Reference

    device = torch.device(device)
    cuda = device.type == "cuda"
    mix, config = cell.mix, cell.config
    t = time.perf_counter()
    pool = inputs.make_frames(config, seed, device)
    log(f"inputs: {len(pool.left)} raw pairs in "
        f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    t = time.perf_counter()
    lg, pipe = launch(config, device)
    log(f"graph launched (kernels built or loaded, maps made) in "
        f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    drv = load.GraphLoad(lg.graph, pipe, pool, seed=seed, trace=trace)
    load.warm_up(drv, load.WARMUP_FRAMES)
    if trace:
        drv.start_trace()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = since_start()
    cpu0 = process_cpu_s()
    if mix["loop"] == "closed":
        t0, t_end = load.closed_loop(drv, seconds)
        rate = None
    else:
        rate = float(config["live_rate_fps"])
        t0, t_end = load.open_loop(drv, seconds, rate)
    cpu_ms = (process_cpu_s() - cpu0) * 1e3
    drv.call(lambda: None)           # the spinner has finished its queue
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window = [f for f in drv.frames if f.window]
    failed = [f for f in window if f.error or f.t_done is None]

    traced = syncs = None
    if trace:
        drv.call(drv.stop_trace)
        traced = tr.read(drv.prof, min(drv.traced, drv.trace_frames))
        if cuda:
            import i3dr_stereo_tpu_torch as pkg

            extra = [drv.new_frame(window=False) for _ in range(2)]
            sites = drv.call(lambda: tr.sync_sites(
                lambda: [drv._publish(f) for f in extra],
                Path(pkg.__file__).parent,
                inside=("stereo_pipeline.py", "process")))
            syncs = SimpleNamespace(sites=sites,
                                    per_frame=sum(sites.values()) / 2)
    drv.close()

    ctx = SimpleNamespace(
        cell=cell.name, config=config, mix=mix, frames=window,
        t0=t0, t_end=t_end, seconds=seconds, setup_s=setup_s, rate=rate,
        trace=traced, syncs=syncs, device=device, log=log)
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        value = manifest.reader(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = busy_s = window_s = None
    if traced is not None and traced.device and traced.spans("frame"):
        within = [traced.window]
        busy_s = tr.busy(traced, within) * 1e-6
        window_s = (within[0][1] - within[0][0]) * 1e-6
        breakdown = tr.breakdown(traced, within)
    lateness = [f.t_enq - f.due for f in window if f.due is not None]
    sample = [f for f in drv.sample if f.outputs is not None]

    # free the program before the reference runs on the same card
    del lg, pipe, drv, traced, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = Reference(config, device)
    readings = []
    for f in sample:
        out = ref.frame(pool.left[f.pool], pool.right[f.pool])
        readings.append(check.compare(f.outputs, out))
        med, dens = check.accuracy(f.outputs, pool.gt[f.pool],
                                   pool.gt_valid[f.pool])
        log(f"frame {f.seq} (pool {f.pool}): median |d - GT| {med} px, "
            f"density {dens} (the repo's gate: < 0.25 px, > 0.5)",
            file=sys.stderr)
        del out
    log(f"reference: {len(readings)} frame(s) in "
        f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    limits = config["check_limits"]
    numbers = check.worst(readings) if readings else {}
    correct = bool(readings) and not failed and all(
        numbers[k] <= limits[k] for k in check.NUMBERS)
    return dict(
        correct=correct, attempted=len(window), failed=len(failed),
        metrics=metrics, peak=peak, busy_s=busy_s, window_s=window_s,
        breakdown=breakdown, numbers=numbers, limits=limits,
        compared=len(readings),
        errors=sorted({f.error for f in failed if f.error}),
        syncs=None if syncs is None else syncs.sites,
        late_ms_max=max(lateness) * 1e3 if lateness else None,
        late_ms_mean=(sum(lateness) / len(lateness) * 1e3
                      if lateness else None),
        delivered_in_window=sum(1 for f in window if f.t_done is not None
                                and not f.error and f.t_done <= t_end),
        cpu_ms_per_frame=cpu_ms / max(len(window), 1))


def device_block(res: dict, chips: int) -> dict:
    import torch

    from portbench.card import device_line

    block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": chips, "memory_peak_bytes": int(res["peak"])}
    if res["busy_s"] is not None:
        block["busy_s"] = res["busy_s"]
        block["window_s"] = res["window_s"]
    block["power_limit"] = device_line()
    return block


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()

    from portbench import manifest

    cell = manifest.cell(root, args.workload)
    set_caches(root)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2
    res = run_cell(root, cell, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device_block(res, cell.chips)}
    if res["breakdown"] is not None:
        out["breakdown"] = res["breakdown"]
    out["run"] = {"compared_frames": res["compared"],
                  "delivered_in_window": res["delivered_in_window"],
                  "generator_late_ms_max": res["late_ms_max"],
                  "generator_late_ms_mean": res["late_ms_mean"],
                  "errors": res["errors"], "host_syncs_by_site": res["syncs"],
                  "process_cpu_ms_per_frame": res["cpu_ms_per_frame"]}
    checks = {k: {"value": res["numbers"].get(k), "limit": res["limits"][k]}
              for k in res["limits"]}
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
