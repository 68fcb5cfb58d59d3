"""The knee of a live cell: the highest rate at which the graph's backlog
does not grow. One process launches the cell's graph once and, for each
seed's pool of raw pairs, drives it open loop at each rate for a window;
per seed and rate one JSON line: frames due, delivered in the window,
latency median and 95th percentile, and the median latency of the first
and the last third of the frames (a backlog that grows shows as a last
third far above the first).

    python3 -m portbench.sweep --workload i3drsgm_2448.live \
        --rates 6,7,8,9,10 --seconds 15 --seeds 5,6

The rate a configuration states for live traffic (``live_rate_fps``) is
about four fifths of the knee found here; find it again when the
program's service time changes."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from portbench import inputs, load, manifest
from portbench.run import launch


def sweep(root: Path, workload: str, rates, seconds: float, seeds,
          device="cuda", log=print) -> list:
    cell = manifest.cell(root, workload)
    lg, pipe = launch(cell.config, torch.device(device))
    drv = None
    rows = []
    for seed in seeds:
        pool = inputs.make_frames(cell.config, seed, device)
        if drv is None:
            drv = load.GraphLoad(lg.graph, pipe, pool)
        drv.pool = pool
        load.warm_up(drv, load.WARMUP_FRAMES)
        for rate in rates:
            drv.frames = []
            t0, t_end = load.open_loop(drv, seconds, rate)
            fr = [f for f in drv.frames if f.window and f.t_done is not None]
            lat = [(f.t_done - f.due) * 1e3 for f in fr]
            third = max(1, len(lat) // 3)
            row = {"workload": workload, "seed": seed, "rate": rate,
                   "seconds": seconds, "due": len(drv.frames),
                   "delivered_in_window": sum(f.t_done <= t_end for f in fr),
                   "p50_ms": statistics.median(lat),
                   "p95_ms": statistics.quantiles(lat, n=100,
                                                  method="inclusive")[94],
                   "first_third_ms": statistics.median(lat[:third]),
                   "last_third_ms": statistics.median(lat[-third:]),
                   "late_ms_max": max(f.t_enq - f.due
                                      for f in drv.frames) * 1e3}
            rows.append(row)
            log(json.dumps(row), flush=True)
    drv.close()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", default="5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sweep(Path.cwd(), args.workload,
          [float(r) for r in args.rates.split(",")], args.seconds,
          [int(s) for s in args.seeds.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
