"""Probe of the census transform's kernel on the GPU
(``csrc/census_transform.cu``, the 9x9 instance): variants built with
``nvcc`` alone, each made by editing that source's text: as it is (a
bit set by a predicated OR); with the compare shifted into place and
ORed (the kernel's first form); with 4 output rows a thread (and 8 warps
a block); with 2 warps a block. (Earlier runs of this probe also timed
16 rows a thread, 8 warps a block on the first form, and the neighbours
walked backwards with a predicated OR or a compare mask (PTX ``set``)
funnel-shifted in.) At level 0 of the
flagship pyramid (the left image and the warped right one, 2 x
2048x2560), through each variant's C entry: bit-equality against the
twin there and on ragged shapes, then, in turns, 20 calls back to back
between two events and events around one call.

    python3 kernel_probes/probe5.py      # from the repository root
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
NEW = (CSRC / "census_transform.cu").read_text()
PREDICATED = "if (v[dx] > centre[r]) words[r][i / 32] |= 1u << (i % 32);"
# the first form: the compare shifted into place and ORed
SHIFTED = "words[r][i / 32] |= (unsigned)(v[dx] > centre[r]) << (i % 32);"


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def variant(rows=8, warps=4, shifted=False):
    text = edit(NEW, "constexpr int FIX_ROWS = 8;", f"constexpr int FIX_ROWS = {rows};")
    text = edit(text, "constexpr int FIX_WARPS = 4;", f"constexpr int FIX_WARPS = {warps};")
    return edit(text, PREDICATED, SHIFTED) if shifted else text


VARIANTS = {
    "c_new": NEW,
    "c_shifted": variant(shifted=True),
    "c_rows4": variant(rows=4),
    "c_rows4_warps8": variant(rows=4, warps=8),
    "c_warps2": variant(warps=2),
}


def build():
    procs = {}
    for name, text in VARIANTS.items():
        d = BUILD / ("p5_" + name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "c.cu").write_text(text)
        for f in ("common.cuh", "error.cu"):
            (d / f).write_text((CSRC / f).read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "c.cu"), str(d / "error.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            continue
        print(name, " | ".join(l.strip() for l in log.splitlines()
                               if "registers" in l or "spill" in l), flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p5_" + name) / "lib.so"))
        lib.i3dr_census_transform.argtypes = [P, P, P, P, I, I, I, I, I, P]
        libs[name] = lib
    return libs


def b2b(fn, iters=20, warm=3):
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
    from i3dr_stereo_tpu_torch.ops.census import census_transform_plain
    st = torch.cuda.current_stream().cuda_stream
    cfg = cs.flagship_cfg(params)
    sc = layered_scene(cs.H_FULL, cs.W_FULL, **cs.SCENE)
    _, lp, rp, pred, q, _, _, _ = next(cs.flagship_levels(cfg, sc))
    rw = bg.block_shift_gather_plain(rp, pred, q, 16).contiguous()
    rng = np.random.default_rng(2)
    cases = [(lp, rw)] + [
        tuple(torch.tensor(rng.uniform(0, 255, shape), dtype=torch.float32,
                           device="cuda") for _ in range(2))
        for shape in ((2, 45, 131), (1, 5, 6), (2, 70, 2449))]

    def entry(name, a, b, oa, ob):
        B, H, W = a.shape
        args = (a.data_ptr(), b.data_ptr(), oa.data_ptr(), ob.data_ptr(), B, H, W, 9, 9, st)
        fn = lambda: libs[name].i3dr_census_transform(*args)
        assert fn() == 0, name
        return fn

    calls = {}
    for name in libs:
        ok = 0
        for a, b in cases:
            oa = torch.empty(a.shape + (3,), dtype=torch.int32, device="cuda")
            ob = torch.empty_like(oa)
            fn = entry(name, a, b, oa, ob)
            ok += (torch.equal(oa, census_transform_plain(a, 9, 9))
                   and torch.equal(ob, census_transform_plain(b, 9, 9)))
            if a is lp:
                calls[name] = fn
        print(f"census {name}: {ok} of {len(cases)} bit-equal", flush=True)
    names = list(calls)
    res = {"card": card}
    for kind, f in (("b2b", b2b), ("events", events)):
        t = {n: [] for n in names}
        for rnd in range(2):
            for n in (names if rnd == 0 else names[::-1]):
                t[n].append(f(calls[n]))
        for n in names:
            res[f"{kind}_{n}"] = t[n]
            print(f"[{card}] census {kind} {n}: " + " ".join(f"{x:.4f}" for x in t[n]),
                  flush=True)
    print("RESULT " + json.dumps(res), flush=True)


main()
