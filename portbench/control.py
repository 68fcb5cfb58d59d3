"""Readings for the limits of the comparison: the control and, with
``--program``, the program's own frames, at a cell's own size on the
card, several seeds in one process.

    python3 -m portbench.control --workload i3drsgm_2448.replay \\
        --seeds 11,12,13 [--program]

For each seed the mix's pool of raw pairs is made as a run makes it, and
one frame drawn from the seed is worked out by the plain reference in
float32. The control is the same reference computed in bfloat16 (the
precision below the float32 the configuration states) put in the
program's place; ``--program`` also pushes the frame through the
launched graph, as the window does, and reads the program against the
reference. Each reading is one JSON line: the four numbers of
:mod:`portbench.check`. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import torch

from portbench import check, inputs, load, manifest
from portbench.reference.pipeline import Reference


def readings(root: Path, workload: str, seeds, program: bool,
             device="cuda", log=print):
    cell = manifest.cell(root, workload)
    dev = torch.device(device)
    ref32 = Reference(cell.config, dev)
    ref16 = Reference(cell.config, dev, torch.bfloat16)
    drv = None
    if program:
        from portbench.run import launch

        lg, pipe = launch(cell.config, dev)
    for seed in seeds:
        t = time.perf_counter()
        pool = inputs.make_frames(cell.config, seed, dev)
        k = random.Random(seed).randrange(len(pool.left))
        out32 = ref32.frame(pool.left[k], pool.right[k])
        row = {"workload": workload, "seed": seed, "frame": k}
        out16 = ref16.frame(pool.left[k], pool.right[k])
        row["control"] = check.compare(check.as_published(out16), out32)
        del out16
        if program:
            if drv is None:
                drv = load.GraphLoad(lg.graph, pipe, pool)
            drv.pool, drv.sample, drv._seen = pool, [], 0
            f = drv.new_frame(window=True, pool=k)
            drv.submit(f)
            f.done.wait(600)
            row["program"] = (check.compare(f.outputs, out32)
                              if f.outputs else {"error": f.error})
        row["seconds"] = time.perf_counter() - t
        log(json.dumps(row), flush=True)
    if drv is not None:
        drv.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    readings(Path.cwd(), args.workload,
             [int(s) for s in args.seeds.split(",")], args.program)
    return 0


if __name__ == "__main__":
    sys.exit(main())
