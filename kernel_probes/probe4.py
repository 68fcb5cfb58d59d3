"""Probe of the remap (G) on the GPU. Part 1, what holds the kernel
before its redesign (``src/remap_parent.cu``): variants built with
``nvcc`` alone, each made by editing that source's text: as it is; with
its weights constants (no weight loads); with its base given packed as
``(row << 16) | column`` (no division); with its source loads cut.
Part 2 (``--new``), the redesign (``csrc/remap.cu``) beside the parent
and beside its first form (``src/remap_words.cu``: a uint8 stencil row
as two aligned words cut by a byte permute, no cache hints): as it is
(2 pixels a thread, streaming (evict-first) map loads and stores), with
1 and 4 pixels a thread, with a plain store, and with no cache hints;
both cameras in one call of the entry against two single calls; the
wrappers (part 1 times this
checkout's ``remap`` wrapper: the parent's when it was run). At 2448x2048 uint8
cubic on the distorted rig of ``chip_smoke.py``, through each variant's
C entry: bit-equality against the twin where the variant computes the
same function, then, in turns, 50 calls back to back between two events
and events around one call.

    python3 kernel_probes/probe4.py [--new]     # from the repository root
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
PARENT = (HERE / "src" / "remap_parent.cu").read_text()


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


VARIANTS = {
    "parent": PARENT,
    "w_const": edit(PARENT, """    wxs[i] = wx[(long long)pix * TAPS + i];
    wys[i] = wy[(long long)pix * TAPS + i];""", """    wxs[i] = 0.25f * (i + 1);
    wys[i] = 0.125f * (i + 1);"""),
    "no_div": edit(PARENT, """  const int by = f / Wp;
  const int bx = f - by * Wp;""", """  const int by = f >> 16;
  const int bx = f & 0xffff;"""),
    "no_src": edit(PARENT, "load_f(row + cols[i])", "(float)(cols[i] + rows[j])"),
}


NEW = (CSRC / "remap.cu").read_text()


STORE_CS = "__stcs(cam.out + b * n_pix + (long long)y * W + xs[k], acc);"
STORE = "cam.out[b * n_pix + (long long)y * W + xs[k]] = acc;"


def new_variant(px=2, streaming_loads=True, streaming_store=True):
    text = edit(NEW, "constexpr int PX = 2;", f"constexpr int PX = {px};")
    if not streaming_loads:
        text = text.replace("__ldcs(", "__ldg(")
    return text if streaming_store else edit(text, STORE_CS, STORE)


NEW_VARIANTS = {
    "new": NEW,
    # the first redesign: aligned-word source loads, no streaming hints
    "new_words": (HERE / "src" / "remap_words.cu").read_text(),
    "new_px1": new_variant(px=1),
    "new_px4": new_variant(px=4),
    "new_plain_store": new_variant(streaming_store=False),
    "new_no_hints": new_variant(streaming_loads=False, streaming_store=False),
}
NEW_MODE = "--new" in sys.argv[1:]
if NEW_MODE:
    VARIANTS = {"parent": VARIANTS["parent"], **NEW_VARIANTS}


def build():
    procs = {}
    for name, text in VARIANTS.items():
        d = BUILD / ("p4_" + name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "g.cu").write_text(text)
        for f in ("common.cuh", "error.cu"):
            (d / f).write_text((CSRC / f).read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "g.cu"), str(d / "error.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            continue
        print(name, " | ".join(l.strip() for l in log.splitlines()
                               if "registers" in l or "spill" in l), flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p4_" + name) / "lib.so"))
        if name.startswith("new"):
            lib.i3dr_remap.argtypes = [P, P, I, P, P, P, P, P, P, I, I, I, I,
                                       I, I, I, P]
        else:
            lib.i3dr_remap.argtypes = [P, I, P, P, P, P, I, I, I, I, I, I, I, P]
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
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.ops import rectify
    st = torch.cuda.current_stream().cuda_stream
    dev = "cuda"
    rig = cs.distorted_rig(camera)
    m = rectify.make_rectify_map(rig.left, device=dev)
    m2 = rectify.make_rectify_map(rig.right, device=dev)
    flat = m.flat_idx.contiguous()
    wx, wy = m.wx.contiguous(), m.wy.contiguous()
    Wp = m.padded_w
    packed = ((flat // Wp) * 65536 + flat % Wp).to(torch.int32).contiguous()
    H, W = flat.shape
    src = torch.tensor(np.random.default_rng(5).integers(0, 256, (H, W), dtype=np.uint8),
                       device=dev)
    ref = rectify.remap_plain(src, m)

    src2 = torch.tensor(np.random.default_rng(6).integers(0, 256, (H, W), dtype=np.uint8),
                        device=dev)
    ref2 = rectify.remap_plain(src2, m2)
    tail = (1, H, W, m.src_h, m.src_w, m.pad, m.taps, st)

    def entry(name, out):
        if name.startswith("new"):
            args = (src.data_ptr(), None, 1, flat.data_ptr(), None,
                    m.weights.data_ptr(), None, out.data_ptr(), None, *tail)
        else:
            base = packed if name == "no_div" else flat
            args = (src.data_ptr(), 1, base.data_ptr(), wx.data_ptr(), wy.data_ptr(),
                    out.data_ptr(), *tail)
        fn = lambda: libs[name].i3dr_remap(*args)
        assert fn() == 0, name
        return fn

    def pair_entry(name, out, out2):
        args = (src.data_ptr(), src2.data_ptr(), 1, m.flat_idx.data_ptr(),
                m2.flat_idx.data_ptr(), m.weights.data_ptr(), m2.weights.data_ptr(),
                out.data_ptr(), out2.data_ptr(), *tail)
        fn = lambda: libs[name].i3dr_remap(*args)
        assert fn() == 0, name
        return fn

    calls = {}
    for name in libs:
        out = torch.empty((1, H, W), dtype=torch.float32, device=dev)
        calls[name] = entry(name, out)
        torch.cuda.synchronize()
        if name in ("parent", "no_div") or name.startswith("new"):
            print(f"G {name}: bit-equal to the twin: {torch.equal(out[0], ref)}", flush=True)
    if NEW_MODE:
        outs = [torch.empty((1, H, W), dtype=torch.float32, device=dev) for _ in range(4)]
        calls["new_pair"] = pair_entry("new", outs[0], outs[1])
        torch.cuda.synchronize()
        print(f"G new_pair: bit-equal to the twin: "
              f"{torch.equal(outs[0][0], ref) and torch.equal(outs[1][0], ref2)}", flush=True)
        one = entry("new", outs[2])
        other = lambda: libs["new"].i3dr_remap(
            src2.data_ptr(), None, 1, m2.flat_idx.data_ptr(), None,
            m2.weights.data_ptr(), None, outs[3].data_ptr(), None, *tail)
        calls["new_two_singles"] = lambda: (one(), other())
        calls["wrapper_new"] = lambda: rectify.remap(src, m)
        calls["wrapper_new_pair"] = lambda: rectify.rectify_pair(src, src2, m, m2)
    else:
        calls["wrapper"] = lambda: rectify.remap(src, m)
    calls["torch_add_u8_to_f32"] = lambda: torch.add(src, 1.0)
    names = list(calls)
    res = {"card": card}
    for kind, f in (("b2b", b2b), ("events", events)):
        t = {n: [] for n in names}
        for rnd in range(2):
            for n in (names if rnd == 0 else names[::-1]):
                t[n].append(f(calls[n]))
        for n in names:
            res[f"{kind}_{n}"] = t[n]
            print(f"[{card}] G {kind} {n}: " + " ".join(f"{x:.4f}" for x in t[n]),
                  flush=True)
    print("RESULT " + json.dumps(res), flush=True)


main()
