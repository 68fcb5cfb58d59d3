"""Probe of the two post-match kernels on the GPU, variants built with
``nvcc`` alone from edits of their sources' text, each called through its
C entry:

- ``gauss_rays`` (``csrc/gauss_rays.cu``): as it is (a subtree is not
  walked where it cannot win) and its first form (every subtree inside
  the image walked);
- ``wls_lines`` (``csrc/wls_lines.cu``): as it is (each sweep loads the
  next 16 steps' inputs before it runs the current 16), with chunks of 4
  and 8, and its first form (``src/wls_lines_first.cu``: a step's loads
  issued with the step), also with both sweeps unrolled by 4 or by 8 and
  with 64 threads a block.

Inputs: the flagship frame's level-0 disparities and valid mask at
2448x2048 (the holes the Gauss fill sees) and, for the line solve, that
mask, the left image's edge weights and the disparities, both passes.
Every variant is checked against the plain twin (masks and values
bit-equal), then timed in turns, calls back to back between two events.

    python3 kernel_probes/probe7.py      # from the repository root
"""
import ctypes, statistics, subprocess, sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))
from i3dr_stereo_tpu_torch import _build  # noqa: E402

BUILD = ROOT / "i3dr_stereo_tpu_torch" / "_kernels" / "probes"
CSRC = ROOT / "i3dr_stereo_tpu_torch" / "csrc"
GAUSS = (CSRC / "gauss_rays.cu").read_text()
WLS = (CSRC / "wls_lines.cu").read_text()
WLS_FIRST = (HERE / "src" / "wls_lines_first.cu").read_text()
PRUNE = "if ((dy != 0 || dx != 0) && dst > dir.len[L - 1]) {"
FIRST = "if (dy != 0 || dx != 0) {"


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def chunk(k):
    return edit(WLS, "constexpr int CHUNK = 16;",
                f"constexpr int CHUNK = {k};")


def first_unrolled(k):
    text = WLS_FIRST
    for loop in ("  for (int i = 0; i < N; ++i) {",
                 "  for (int i = N - 1; i >= 0; --i) {"):
        text = edit(text, loop, f"#pragma unroll {k}\n{loop}")
    return text


VARIANTS = {
    "g_new": ("gauss", GAUSS),
    "g_first": ("gauss", edit(GAUSS, PRUNE, FIRST)),
    "w_new": ("wls", WLS),
    "w_chunk4": ("wls", chunk(4)),
    "w_chunk8": ("wls", chunk(8)),
    "w_first": ("wls", WLS_FIRST),
    "w_first_unroll4": ("wls", first_unrolled(4)),
    "w_first_unroll8": ("wls", first_unrolled(8)),
    "w_first_64": ("wls", edit(WLS_FIRST, "constexpr int THREADS = 32;",
                               "constexpr int THREADS = 64;")),
}


def build():
    procs = {}
    for name, (_, text) in VARIANTS.items():
        d = BUILD / ("p7_" + name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        for f in ("common.cuh", "error.cu"):
            (d / f).write_text((CSRC / f).read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d),
             "-o", str(d / "lib.so"), str(d / "k.cu"), str(d / "error.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            continue
        print(name, " | ".join(l.strip() for l in log.splitlines()
                               if "registers" in l and "<6>" not in l
                               or "spill" in l and "bytes stack" not in l)[:300],
              flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p7_" + name) / "lib.so"))
        entry = "i3dr_gauss_rays" if name[0] == "g" else "i3dr_wls_lines"
        fn = getattr(lib, entry)
        fn.argtypes = list(_build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def b2b(fn, iters):
    for _ in range(2):
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
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match
    from i3dr_stereo_tpu_torch.ops import gauss_interp as gi
    from i3dr_stereo_tpu_torch.ops import wls

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build()
    cfg = params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM].replace(
        disparity_range=256, max_pyramid_level=4, speckle_size=100,
        speckle_downsample=2)
    sc = layered_scene(2048, 2448, max_disp=200, background_disp=16,
                       layers=6, seed=1)
    l = torch.tensor(sc.left, device="cuda")[None]
    r = torch.tensor(sc.right, device="cuda")[None]
    res = pyramid_sgm_match(l, r, cfg)
    d, v = res.disparity.contiguous(), res.valid.contiguous()
    B, H, W = d.shape
    stream = _build.stream_of(d)

    # gauss_rays
    table = gi._ray_table(32, 64, d.device)
    want_d, want_v = gi.gauss_interpolate(d, v, plain=True)
    out, vout = torch.empty_like(d), torch.empty_like(v)
    inv = 1.0 / 512.0
    gargs = (d.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
             vout.data_ptr(), B, H, W, 32, 6, 64.0, inv, 1.0, stream)
    calls = {}
    for name in [n for n in libs if n[0] == "g"]:
        out.zero_()
        assert libs[name](*gargs) == 0
        torch.cuda.synchronize()
        print(name, "bit-equal", torch.equal(out, want_d)
              and torch.equal(vout, want_v), flush=True)
        calls[name] = (lambda f: lambda: f(*gargs))(libs[name])

    # wls_lines, both passes
    lam = 1.5 * 8000.0 * 16.0 / 63.0
    a = v.float()
    g = wls.div_const(l, 255.0)
    cases = {}
    for vertical in (False, True):
        w = wls._edge_weights(g, 0.15, -2 if vertical else -1).contiguous()
        want = wls.thomas_lines(a, w, d, lam, vertical=vertical, plain=True)
        u, cp = torch.empty_like(d), torch.empty_like(d)
        if vertical:
            L, N, lay = W, H, (H * W, 1, W, (H - 1) * W, 1, W)
        else:
            L, N, lay = H, W, (H * W, W, 1, H * (W - 1), W - 1, 1)
        args = (a.data_ptr(), w.data_ptr(), d.data_ptr(), u.data_ptr(),
                cp.data_ptr(), B, L, N, *lay, lam, stream)
        cases[vertical] = (args, w, u, cp)
        for name in [n for n in libs if n[0] == "w"]:
            u.zero_()
            assert libs[name](*args) == 0
            torch.cuda.synchronize()
            print(name, "vertical" if vertical else "horizontal",
                  "bit-equal", torch.equal(u, want), flush=True)
            calls[f"{name}_{'v' if vertical else 'h'}"] = (
                lambda f, a_: lambda: f(*a_))(libs[name], args)

    times = {k: [] for k in calls}
    order = list(calls)
    for turn in range(4):
        for k in (order if turn % 2 == 0 else order[::-1]):
            times[k].append(b2b(calls[k], 10 if k[0] == "g" else 20))
    for k, ts in times.items():
        print(f"{k}: {statistics.median(ts):.4f} ms a call back to back "
              f"(turns {', '.join(f'{t:.4f}' for t in ts)}) [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
