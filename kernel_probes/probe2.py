"""Second probe of ``fused_bt_fwd`` and the row gather on the GPU: what
holds the redesigned BT kernel (its costs a constant, its stores cut,
both; int16 and float32 S) and the row gather's designs (the kept
kernel, a source window staged in shared memory ``src/row_gather_staged.cu``,
a streaming variant ``src/row_gather_stream.cu``) beside the one before
them (``src/row_gather_parent.cu``) and ``torch.gather`` / ``torch.add``
/ ``clone`` on the same bytes. CUDA events around one call, in turns;
bit-equality against the twins first. Variants are made by editing the
sources' text (patterns of the sources it was written for: on later
sources an assert stops it).

    python3 kernel_probes/probe2.py      # from the repository root
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
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

PSRC = (HERE / "src" / "fused_cost_sgm.cu").read_text()
COL_START = "    const float* l = left + row;\n    const float* r = right + row;\n"
COL_END = "        out[k] = rintf(__fmul_rn(2.0f, fminf(dl, dr)));\n      }\n    }\n"


def const_cost(s):
    a = s.index(COL_START)
    b = s.index(COL_END) + len(COL_END)
    return s[:a] + "#pragma unroll\n    for (int k = 0; k < K; ++k) out[k] = 3.0f;\n" + s[b:]


def no_store(s):
    s2 = s.replace("bool stored = false;", "bool stored = x0 + u != W - 1;")
    s2 = s2.replace("if (vec) {", "if (vec && !stored) {")
    assert s2 != s
    return s2


def rd(name):
    return (CSRC / name).read_text()


NEW = rd("fused_bt.cu")
BFLY = NEW.replace("i3dr::sgm_step<K, true>", "i3dr::sgm_step<K, false>")
assert BFLY != NEW
TW64 = NEW.replace("constexpr int TW = 32;", "constexpr int TW = 64;")
assert TW64 != NEW
BLK4 = NEW.replace("return K <= 4 ? 8 : (K <= 8 ? 4 : 2);", "return K <= 4 ? 4 : (K <= 8 ? 4 : 2);")
assert BLK4 != NEW
ENEW = rd("row_gather.cu")
PARENT_HDRS = {f: (HERE / "src" / f).read_text() for f in
               ("fused_census32.cu", "fused_census32.cuh", "sgm_step.cuh", "common.cuh",
                "error.cu")}
NEW_HDRS = {f: rd(f) for f in ("sgm_step.cuh", "common.cuh", "error.cu")}
EPARENT = (HERE / "src" / "row_gather_parent.cu").read_text()

KCONST = NEW.replace("const float cost = rintf(__fmul_rn(2.0f, fminf(dl, dr)));",
                     "const float cost = 3.0f;")
assert KCONST != NEW


def k_nostore(s):
    s2 = s.replace("    const long long o = e + (long long)u * a.D;\n",
                   "    const long long o = e + (long long)u * a.D;\n"
                   "    if (a.min_disp != 123456789) continue;\n")
    assert s2 != s
    return s2


ESTAGED = (HERE / "src" / "row_gather_staged.cu").read_text()
ESTREAM = (HERE / "src" / "row_gather_stream.cu").read_text()
VARIANTS = {
    "new_hw": (dict(NEW_HDRS, **{"k.cu": NEW}), ["k.cu", "error.cu"]),
    "new_const": (dict(NEW_HDRS, **{"k.cu": KCONST}), ["k.cu", "error.cu"]),
    "new_nostore": (dict(NEW_HDRS, **{"k.cu": k_nostore(NEW)}), ["k.cu", "error.cu"]),
    "new_const_nostore": (dict(NEW_HDRS, **{"k.cu": k_nostore(KCONST)}),
                          ["k.cu", "error.cu"]),
    "e_parent": (dict(PARENT_HDRS, **{"e.cu": EPARENT}), ["e.cu", "error.cu"]),
    "e_new": (dict(NEW_HDRS, **{"e.cu": ENEW}), ["e.cu", "error.cu"]),
    "e_staged": (dict(NEW_HDRS, **{"e.cu": ESTAGED}), ["e.cu", "error.cu"]),
    "e_stream": (dict(NEW_HDRS, **{"e.cu": ESTREAM}), ["e.cu", "error.cu"]),
}
K_NAMES = ["new_hw", "new_const", "new_nostore", "new_const_nostore"]
E_NAMES = ["e_parent", "e_new", "e_staged", "e_stream"]


def build():
    procs = {}
    for name, (files, srcs) in VARIANTS.items():
        d = BUILD / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I", str(d), "-o",
             str(d / "lib.so"), *[str(d / s) for s in srcs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        (BUILD / name / "build.log").write_text(log)
        if p.returncode:
            print(f"BUILD FAILED {name}\n{log[-5000:]}", flush=True)
            continue
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "Li4ENS_6BtCost" in line or "bt_fwd_kernelILi4ELb1ELb1" in line
                    or "bt_fwd_kernelILi4ELb0ELb1" in line or "row_gather_kernel" in line):
                print(name, line[-60:], " | ".join(x.strip() for x in lines[i + 1:i + 3]),
                      flush=True)
        lib = ctypes.CDLL(str(BUILD / name / "lib.so"))
        if name in K_NAMES:
            lib.i3dr_fused_bt_fwd.argtypes = [P, P, P, I, P, P, I, I, I, I, I, I, F, F, P]
        else:
            lib.i3dr_row_gather.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        libs[name] = lib
    return libs


def events(fn, n=10, warm=3):
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
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops.cost import xsobel_prefilter
    from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    st = lambda: torch.cuda.current_stream().cuda_stream
    dev = "cuda"

    def bt(name, l, r, base, th, D, md, p1, p2, od, C=None, S=None):
        B, H, W = l.shape
        C = torch.empty((B, H, W, D), dtype=torch.uint8, device=dev) if C is None else C
        S = torch.empty((B, H, W, D), dtype=od, device=dev) if S is None else S
        e = libs[name].i3dr_fused_bt_fwd(l.data_ptr(), r.data_ptr(), base.data_ptr(), th,
                                         C.data_ptr(), S.data_ptr(), int(od == torch.int16),
                                         B, H, W, D, md, p1, p2, st())
        assert e == 0, (name, e)
        return C, S

    # K: correctness of the new kernels against the twin
    rng = np.random.default_rng(0)
    sc = layered_scene(1024, 1280, max_disp=120, background_disp=8, layers=5, seed=21)
    u8 = lambda a: torch.tensor(np.clip(np.rint(a), 0, 255).astype(np.uint8), device=dev)
    lp = xsobel_prefilter(u8(sc.left).float()[None], 31).contiguous()
    rp = xsobel_prefilter(u8(sc.right).float()[None], 31).contiguous()
    cases = [(lp, rp, torch.zeros(128, dtype=torch.int32, device=dev), 128, 0, 400.0, 800.0,
              "main 1x1024x1280x128")]
    for (B, H, W, D, md, bk) in [(1, 8, 48, 128, 0, "zero"), (2, 16, 40, 16, 0, (0, 60)),
                                 (1, 4, 67, 128, 0, "zero"), (1, 4, 131, 1, 0, "zero"),
                                 (1, 4, 70, 16, -3, "rand"), (2, 44, 131, 130, -2, "rand"),
                                 (1, 2, 600, 512, 5, "zero"), (2, 8, 1283, 128, 0, "rand"),
                                 (1, 4, 200, 300, -40, "rand")]:
        th = fcs.row_tile(H)
        base = (torch.zeros(H // th, dtype=torch.int32) if bk == "zero" else
                torch.tensor(rng.integers(-30, 30, H // th), dtype=torch.int32)
                if bk == "rand" else torch.tensor(bk, dtype=torch.int32)).to(dev)
        l = torch.tensor(rng.integers(0, 63, (B, H, W)) * 0.5, dtype=torch.float32, device=dev)
        r = torch.roll(l, 3, 2) + torch.tensor(rng.integers(-2, 3, (B, H, W)) * 1.0,
                                              dtype=torch.float32, device=dev)
        cases.append((l, r, base, D, md, 16.0, 64.0, f"{B}x{H}x{W}x{D} md{md} {bk}"))
    twins = {}
    for name in ("new_hw",):
        if name not in libs:
            continue
        n_ok = n_all = 0
        for ci, (l, r, base, D, md, p1, p2, label) in enumerate(cases):
            H = l.shape[1]
            th = fcs.row_tile(H)
            for od in (torch.int16, torch.float32):
                try:
                    C, S = bt(name, l, r, base, th, D, md, p1, p2, od)
                    if (ci, od) not in twins:
                        twins[ci, od] = fcs.fused_bt_horizontal_plain(
                            l, r, base, D, p1, p2, min_disp=md, out_dtype=od)
                    Cp, Sp = twins[ci, od]
                    torch.cuda.synchronize()
                    ok = torch.equal(C, Cp) and torch.equal(S, Sp)
                except Exception as exc:  # report and go on
                    ok = f"error {exc!r}"
                n_all += 1
                n_ok += ok is True
                if ok is not True:
                    print(f"K {name} {label} {od}: bit-equal {ok}", flush=True)
        print(f"K {name}: {n_ok} of {n_all} cases bit-equal", flush=True)
    del twins
    # K timing in turns, both modes
    base = torch.zeros(128, dtype=torch.int32, device=dev)
    res = {"card": card}
    kn = [n for n in K_NAMES if n in libs]
    for od in (torch.int16, torch.float32):
        C = torch.empty((1, 1024, 1280, 128), dtype=torch.uint8, device=dev)
        S = torch.empty((1, 1024, 1280, 128), dtype=od, device=dev)
        times = {n: [] for n in kn}
        for name in kn + kn[::-1]:
            times[name].append(events(lambda: bt(name, lp, rp, base, 8, 128, 0, 400.0, 800.0,
                                                 od, C, S)))
        for n, t in times.items():
            res[f"K_{n}_{str(od)[6:]}"] = t
            print(f"[{card}] K {n} {str(od)[6:]}: {t[0]:.4f} {t[1]:.4f} ms", flush=True)
        del C, S
    # E: correctness and timing at level 0 of the flagship pyramid
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from i3dr_stereo_tpu_torch.config import params
    cfg = cs.flagship_cfg(params)
    fsc = layered_scene(cs.H_FULL, cs.W_FULL, **cs.SCENE)
    _, lp0, rp0, pred, q, bpm, Hh, Wh = next(cs.flagship_levels(cfg, fsc))

    def eg(name, src, idx, qq, radius, out=None):
        B, H, W = src.shape
        out = torch.empty_like(src) if out is None else out
        e = libs[name].i3dr_row_gather(src.data_ptr(), idx.data_ptr(), qq.data_ptr(),
                                       out.data_ptr(), B, H, W, qq.shape[1], qq.shape[2],
                                       radius, st())
        assert e == 0, (name, e)
        return out

    ecases = [(rp0, pred, q, 16, "level0 warp")]
    for B, H, W, rr in [(1, 8, 131, 63), (2, 16, 256, 0), (2, 64, 300, 17), (1, 8, 131, 200),
                        (2, 24, 640, 17), (1, 8, 8, 5)]:
        src = torch.tensor(rng.uniform(0, 255, (B, H, W)), dtype=torch.float32, device=dev)
        idx = torch.tensor(rng.integers(-60, W + 60, (B, H, W)), dtype=torch.int32, device=dev)
        qq = torch.tensor(rng.integers(-20, W + 20, (B, -(-H // 8), -(-W // 128))),
                          dtype=torch.int32, device=dev)
        ecases.append((src, idx, qq, rr, f"{B}x{H}x{W} r{rr}"))
    for name in ("e_new", "e_staged"):
        if name not in libs:
            continue
        for src, idx, qq, rr, label in ecases:
            try:
                out = eg(name, src, idx, qq, rr)
                ref = bg.block_shift_gather_plain(src, idx, qq, rr)
                torch.cuda.synchronize()
                ok = torch.equal(out, ref)
            except Exception as exc:
                ok = f"error {exc!r}"
            print(f"E {name} {label}: bit-equal {ok}", flush=True)
    en = [n for n in E_NAMES if n in libs]
    out = torch.empty_like(rp0)
    xs = torch.arange(rp0.shape[-1], dtype=torch.int32, device=dev)
    col = (xs - pred).clamp(0, rp0.shape[-1] - 1).long()
    lib_calls = {"torch_gather_ready": lambda: torch.gather(rp0, 2, col),
                 "torch_add_12B": lambda: torch.add(rp0, pred),
                 "torch_clone_8B": lambda: rp0.clone()}
    times = {n: [] for n in en + list(lib_calls)}
    for name in en + list(lib_calls) + en[::-1] + list(lib_calls)[::-1]:
        if name in lib_calls:
            times[name].append(events(lib_calls[name], n=20))
        else:
            times[name].append(events(lambda: eg(name, rp0, pred, q, 16, out), n=20))
    for n, t in times.items():
        res[f"E_{n}"] = t
        print(f"[{card}] E {n}: {t[0]:.4f} {t[1]:.4f} ms", flush=True)
    print(json.dumps(res), flush=True)


main()
