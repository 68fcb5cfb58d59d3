"""Probe of ``bt_box_cost`` on the GPU: the kernel as it is in ``csrc/``
and variants of it, built with ``nvcc`` alone, each called through its C
entry at the sgbm_1920 cell's shape (1x1080x1920, 480 disparities from
147, window 9; also windows 1, 5 and 11), held to the plain twin
(``box_aggregate(*bt_cost_volume(...))`` on the card) and timed in turns
(calls back to back between two events). Then the kernel as it is alone
at the wider windows: 13-17 (the one pass at r = 6-8) and 19, 21, 41, 255
(the two passes, through a scratch volume).

- ``new``: ``csrc/bt_box_cost.cu`` (rows copied 2 ahead by cp.async, out-of-
  image right columns staged as (0, -inf, +inf));
- ``ahead4``: the copies 4 rows ahead;
- ``tx64``: tiles of 64 columns in blocks of 16 warps, one block an SM;
- ``rows64``: strips of 64 rows at every window (the kernel marches 32
  rows at window 1, 64 at 3 and 128 beyond);
- the yardstick: ``fill_`` of the volume (a write of the same 3.98 GB).

    python3 kernel_probes/probe11.py

from the repository root.
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

BUILD = ROOT / "i3dr_stereo_tpu_torch" / "_kernels" / "probes"
CSRC = ROOT / "i3dr_stereo_tpu_torch" / "csrc"
NEW = (CSRC / "bt_box_cost.cu").read_text()
H, W, D, MIN_D = 1080, 1920, 480, 147


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def variants():
    return {
        "new": NEW,
        "ahead4": edit(NEW, "constexpr int AHEAD = 2;",
                       "constexpr int AHEAD = 4;"),
        "rows64": edit(NEW, "a.rows = radius == 0 ? 32 : (radius == 1 ? 64"
                       " : 128);", "a.rows = 64;"),
        # (half the wide passes' staging, to fit the 512 threads' shared
        # memory; windows over 17 are not timed here)
        "tx64": edit(edit(edit(edit(
            NEW, "constexpr int THREADS = 256;",
            "constexpr int THREADS = 512;"),
            "constexpr int TX = 32; ", "constexpr int TX = 64; "),
            "__launch_bounds__(THREADS, R > 7 ? 1 : 2)",
            "__launch_bounds__(THREADS, 1)"),
            "constexpr int CH = 32; ", "constexpr int CH = 16; "),
    }


def build(vs):
    from i3dr_stereo_tpu_torch import _build

    procs = {}
    for name, text in vs.items():
        d = BUILD / ("p11_" + name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d),
             "-o", str(d / "lib.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            continue
        regs = [l.split(":", 1)[1].strip() for l in log.splitlines()
                if "registers" in l]
        spills = [l.strip() for l in log.splitlines()
                  if "spill" in l and " 0 bytes spill stores" not in l]
        print(f"{name}: {regs}; {spills}", flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p11_" + name) / "lib.so"))
        lib.i3dr_bt_box_cost.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        lib.i3dr_bt_box_cost.restype = ctypes.c_int
        libs[name] = lib
    return libs


def pair():
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops.cost import xsobel_prefilter

    sc = layered_scene(H, W, max_disp=600, background_disp=160, layers=6,
                       seed=5)
    out = []
    for img in (sc.left, sc.right):
        t = torch.tensor(img, dtype=torch.float32, device="cuda")[None]
        t = 0.37 * t + 0.63 * torch.roll(t, 1, -1)
        out.append(xsobel_prefilter(t, 31).contiguous())
    return out


def b2b_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main():
    from i3dr_stereo_tpu_torch.ops import cost

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build(variants())
    lf, rf = pair()
    out = torch.empty((1, H, W, D), device="cuda")
    scratch = torch.empty_like(out)
    stream = torch.cuda.current_stream().cuda_stream
    bound_ms = (2 * H * W * 4 + 4 * H * W * D) / 3.35e12 * 1e3

    def call(name, win):
        return lambda: libs[name].i3dr_bt_box_cost(
            lf.data_ptr(), rf.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            1, H, W, D, MIN_D, win // 2, stream)

    for win in (9, 1, 11, 15, 21):
        ref = cost.box_aggregate(*cost.bt_cost_volume(lf, rf, MIN_D, D), win)
        for name in libs if win <= 11 else ("new",):
            out.fill_(float("nan"))
            assert call(name, win)() == 0
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                print(f"MISMATCH {name} window {win}: max "
                      f"{(out - ref).abs().nan_to_num(1e30).max().item()}",
                      flush=True)
        del ref
        print(f"window {win}: checked", flush=True)

    runs = list(libs)
    for win in (9, 1, 5, 11):
        times = {r: [] for r in runs}
        fill = []
        for order in (runs, runs[::-1], runs, runs[::-1]):
            fill.append(b2b_ms(lambda: out.fill_(1e9)))
            for name in order:
                times[name].append(b2b_ms(call(name, win)))
        print(f"window {win} [{card}]: back to back, median of 4 in turns "
              f"(bound {bound_ms:.4f} ms); fill_ of the volume "
              f"{statistics.median(fill):.4f} ms", flush=True)
        for name, ts in times.items():
            m = statistics.median(ts)
            print(f"  {name:8s}: {m:.4f} ms "
                  f"({min(ts):.4f}-{max(ts):.4f}), {bound_ms / m:.1%} of the "
                  f"bound", flush=True)
    for win in (13, 15, 17, 19, 21, 41, 255):
        ts = [b2b_ms(call("new", win), iters=5 if win > 41 else 20)
              for _ in range(3)]
        print(f"window {win} [{card}]: new {statistics.median(ts):.4f} ms "
              f"({min(ts):.4f}-{max(ts):.4f}), median of 3 back to back",
              flush=True)


if __name__ == "__main__":
    main()
