"""Probe of the row gather's designs on the GPU, each through its C entry
at level 0 of the flagship pyramid: the kept kernel (``csrc/row_gather.cu``),
a source window staged in shared memory (``src/row_gather_staged.cu``)
and the kernel before both (``src/row_gather_parent.cu``), beside
``torch.gather`` on a ready index and the wrapper. Bit-equality against
the twin on seven shapes first; then, in turns, 50 calls back to back
between two events and events around one call.

    python3 kernel_probes/probe3.py      # from the repository root
"""
import ctypes, json, statistics, subprocess, sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))
from i3dr_stereo_tpu_torch import _build  # noqa: E402

BUILD = ROOT / "i3dr_stereo_tpu_torch" / "_kernels" / "probes"
CSRC = ROOT / "i3dr_stereo_tpu_torch" / "csrc"
P, I = ctypes.c_void_p, ctypes.c_int
rd = lambda p: Path(p).read_text()
NEW_HDRS = {f: rd(CSRC / f) for f in ("common.cuh", "error.cu")}
PARENT_HDRS = {f: rd(HERE / "src" / f) for f in ("common.cuh", "error.cu")}
VARIANTS = {
    "e_new": dict(NEW_HDRS, **{"e.cu": rd(CSRC / "row_gather.cu")}),
    "e_staged": dict(NEW_HDRS, **{"e.cu": rd(HERE / "src" / "row_gather_staged.cu")}),
    "e_parent": dict(PARENT_HDRS, **{"e.cu": rd(HERE / "src" / "row_gather_parent.cu")}),
}


def build():
    procs = {}
    for name, files in VARIANTS.items():
        d = BUILD / ("p3_" + name)
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "e.cu"), str(d / "error.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            continue
        print(name, " | ".join(l.strip() for l in log.splitlines()
                               if "registers" in l or "spill" in l), flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p3_" + name) / "lib.so"))
        lib.i3dr_row_gather.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        libs[name] = lib
    return libs


def b2b(fn, iters=50, warm=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def events(fn, n=20, warm=3):
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build()
    import chip_smoke as cs
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    st = torch.cuda.current_stream().cuda_stream
    dev = "cuda"
    cfg = cs.flagship_cfg(params)
    fsc = layered_scene(cs.H_FULL, cs.W_FULL, **cs.SCENE)
    _, lp0, rp0, pred, q, bpm, Hh, Wh = next(cs.flagship_levels(cfg, fsc))

    def entry(name, src, idx, qq, radius, out):
        B, H, W = src.shape
        args = (src.data_ptr(), idx.data_ptr(), qq.data_ptr(), out.data_ptr(), B, H, W,
                qq.shape[1], qq.shape[2], radius, st)
        fn = lambda: libs[name].i3dr_row_gather(*args)
        assert fn() == 0, name
        return fn

    rng = np.random.default_rng(0)
    ecases = [(rp0, pred, q, 16, "level0 warp")]
    for B, H, W, rr in [(1, 8, 131, 63), (2, 16, 256, 0), (2, 64, 300, 17), (1, 8, 131, 200),
                        (2, 24, 640, 17), (2, 16, 512, 100)]:
        src = torch.tensor(rng.uniform(0, 255, (B, H, W)), dtype=torch.float32, device=dev)
        idx = torch.tensor(rng.integers(-60, W + 60, (B, H, W)), dtype=torch.int32, device=dev)
        qq = torch.tensor(rng.integers(-20, W + 20, (B, -(-H // 8), -(-W // 128))),
                          dtype=torch.int32, device=dev)
        ecases.append((src, idx, qq, rr, f"{B}x{H}x{W} r{rr}"))
    for name in libs:
        ok = 0
        for src, idx, qq, rr, label in ecases:
            out = torch.empty_like(src)
            entry(name, src, idx, qq, rr, out)
            good = torch.equal(out, bg.block_shift_gather_plain(src, idx, qq, rr))
            ok += good
            if not good:
                print(f"E {name} {label}: NOT bit-equal", flush=True)
        print(f"E {name}: {ok} of {len(ecases)} bit-equal", flush=True)
    col = (torch.arange(rp0.shape[-1], dtype=torch.int32, device=dev) - pred).clamp(
        0, rp0.shape[-1] - 1).long()
    calls = {n: entry(n, rp0, pred, q, 16, torch.empty_like(rp0)) for n in libs}
    calls["torch_gather_ready"] = lambda: torch.gather(rp0, 2, col)
    calls["wrapper_new"] = lambda: bg.block_shift_gather(rp0, pred, q, 16)
    names = list(calls)
    res = {"card": card}
    for kind, f in (("b2b", b2b), ("events", events)):
        t = {n: [] for n in names}
        for rnd in range(2):
            for n in (names if rnd == 0 else names[::-1]):
                t[n].append(f(calls[n]))
        for n in names:
            res[f"{kind}_{n}"] = t[n]
            print(f"[{card}] E {kind} {n}: " + " ".join(f"{x:.4f}" for x in t[n]),
                  flush=True)
    print("RESULT " + json.dumps(res), flush=True)


main()
