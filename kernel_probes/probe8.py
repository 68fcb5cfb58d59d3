"""Probe of the post-match kernels' redesigns on the GPU: the kernels
as they are in ``csrc/`` and variants of them, built with ``nvcc`` alone,
each called through its C entry, held to the plain twin and timed in
turns.

- ``gauss_rays``: ``g_new`` (``csrc/gauss_rays.cu``: the doubling's
  recursion walked a hole a thread, its last 2 levels' leaves gathered at
  once, 8x16 blocks); the same gathering 0 (a leaf at a time), 1, 3 or 4
  levels, and 2 levels in 32x8, 16x16, 8x32 and 8x8 blocks; the forms in
  ``src/``: the holes of a tile listed in shared memory with a thread a
  hole (``gauss_rays_lane.cu``) or a warp a hole and a lane a direction
  (``gauss_rays_warp.cu``), and the reference's rounds on a shared-memory
  tile (``gauss_rays_rounds.cu``); the parent's kernel
  (``g_parent``) where a checkout of it is unpacked in ``_parent/``.
- ``wls_lines``: ``w_new`` (``csrc/wls_lines.cu``: 32 segments a line,
  the block's lines staged in shared memory); 1, 2, 4 or 8 lines a block
  forced; ``w_clock``, its phases' cycles a block by ``clock64``; timed
  only (another rounding): three divisions a step in place of the
  reciprocal (``w_div``), 64 segments a line (``w_parts64``) and the
  first partitioned form (``src/wls_lines_twosided.cu``: both ends
  eliminated, c and Q in a scratch buffer, loads 8 steps ahead).

Inputs: the flagship frame's level-0 disparities and valid mask at
2448x2048 and, for the line solve, that mask, the left image's edge
weights and the disparities, both passes (lam of the first pass). Masks
and values are held to the twin (values within 1e-6 relative, reported
bit-equal or not), then every variant is timed in four turns, calls back
to back between two events.

    python3 kernel_probes/probe8.py      # from the repository root
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
from i3dr_stereo_tpu_torch import _build  # noqa: E402

BUILD = ROOT / "i3dr_stereo_tpu_torch" / "_kernels" / "probes"
CSRC = ROOT / "i3dr_stereo_tpu_torch" / "csrc"
GAUSS = (CSRC / "gauss_rays.cu").read_text()
# the parent's kernels, where a checkout of it is unpacked in _parent/
PARENT = ROOT / "_parent" / "i3dr_stereo_tpu_torch" / "csrc"
WARP = (HERE / "src" / "gauss_rays_warp.cu").read_text()
LANE = (HERE / "src" / "gauss_rays_lane.cu").read_text()
ROUNDS = (HERE / "src" / "gauss_rays_rounds.cu").read_text()
WLS = (CSRC / "wls_lines.cu").read_text()
TWOSIDED = (HERE / "src" / "wls_lines_twosided.cu").read_text()


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def batch(levels, tx=8, ty=16):
    text = edit(GAUSS, "constexpr int BL = 2;",
                f"constexpr int BL = {levels};")
    return edit(text, "constexpr int TX = 8, TY = 16;",
                f"constexpr int TX = {tx}, TY = {ty};")


def tile(text, tx, ty):
    return edit(text, "constexpr int TX = 64, TY = 32;",
                f"constexpr int TX = {tx}, TY = {ty};")


def lines_a_block(lb):
    return edit(WLS, "for (int lb : {8, 4, 2, 1})", f"for (int lb : {{{lb}}})")


RCP = """    const float inv =
        __frcp_rn(pivot(__fsub_rn(r.diag, __fmul_rn(r.lower, c))));
    c = __fmul_rn(r.upper, inv);
    P = __fmul_rn(__fsub_rn(r.rhs, __fmul_rn(r.lower, P)), inv);
    Q = __fmul_rn(__fmul_rn(-r.lower, Q), inv);
"""
DIV = """    const float den = pivot(__fsub_rn(r.diag, __fmul_rn(r.lower, c)));
    c = __fdiv_rn(r.upper, den);
    P = __fdiv_rn(__fsub_rn(r.rhs, __fmul_rn(r.lower, P)), den);
    Q = __fdiv_rn(__fmul_rn(-r.lower, Q), den);
"""


def clocked(text):
    """The kernel with clock64() read by thread 0 of each block at its
    start, after each barrier and at its end (``i3dr_probe_clocks``)."""
    head = ("__device__ long long g_clk[65536 * 8];\n"
            "#define CLK(n) if (threadIdx.x == 0 && blockIdx.x < 65536) "
            "g_clk[blockIdx.x * 8 + (n)] = clock64();\n")
    text = edit(text, "namespace {\n", head + "namespace {\n")
    text = edit(text, "  extern __shared__ __align__(16) float smem[];\n",
                "  extern __shared__ __align__(16) float smem[];\n  CLK(0);\n")
    parts = text.split("  __syncthreads();\n")
    assert len(parts) == 6
    text = parts[0] + "".join(f"  __syncthreads();\n  CLK({n});\n" + p
                              for n, p in enumerate(parts[1:], 1))
    text = edit(text, "out[i * lo.step] = sa[i * LB + j];\n  }\n}",
                "out[i * lo.step] = sa[i * LB + j];\n  }\n  CLK(6);\n}")
    return text + """
extern "C" int i3dr_probe_clocks(long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_clk, sizeof(long long) * n);
}
extern "C" int i3dr_probe_clocks_reset() {
  void* p;
  cudaGetSymbolAddress(&p, g_clk);
  return (int)cudaMemset(p, 0, sizeof(g_clk));
}
"""


# name -> (kernel, source, held to the twin); the variants not held to it
# round otherwise (timed only)
VARIANTS = {
    "g_new": ("gauss", GAUSS, True),
    "g_leaf": ("gauss", batch(0, 32, 8), True),
    "g_batch1": ("gauss", batch(1), True),
    "g_batch3": ("gauss", batch(3), True),
    "g_batch4": ("gauss", batch(4), True),
    "g_batch2_32x8": ("gauss", batch(2, 32, 8), True),
    "g_batch2_16x16": ("gauss", batch(2, 16, 16), True),
    "g_batch2_8x32": ("gauss", batch(2, 8, 32), True),
    "g_batch2_8x8": ("gauss", batch(2, 8, 8), True),
    "g_lane": ("gauss", LANE, True),
    "g_lane_32x32": ("gauss", tile(LANE, 32, 32), True),
    "g_warp": ("gauss", WARP, True),
    "g_warp_32x8": ("gauss", tile(WARP, 32, 8), True),
    "g_rounds": ("gauss", ROUNDS, True),
    "w_new": ("wls", WLS, True),
    "w_clock": ("wls", clocked(WLS), True),
    "w_lines1": ("wls", lines_a_block(1), True),
    "w_lines2": ("wls", lines_a_block(2), True),
    "w_lines4": ("wls", lines_a_block(4), True),
    "w_lines8": ("wls", lines_a_block(8), True),
    "w_div": ("wls", edit(WLS, RCP, DIV), False),
    "w_parts64": ("wls", edit(WLS, "constexpr int PARTS = 32;",
                              "constexpr int PARTS = 64;"), False),
    "w_twosided": ("wls", TWOSIDED, False),
}
if PARENT.exists():
    VARIANTS["g_parent"] = ("gauss", (PARENT / "gauss_rays.cu").read_text(),
                            True)
    VARIANTS["w_parent"] = ("wls", (PARENT / "wls_lines.cu").read_text(),
                            False)
# C entries that take a scratch buffer after u (the parent's and the first
# partitioned form's)
SCRATCH = ("w_twosided", "w_parent")


def build():
    procs = {}
    for name, (_, text, _) in VARIANTS.items():
        d = BUILD / ("p8_" + name)
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
                               if "registers" in l or "spill" in l
                               and "bytes stack" not in l)[:400], flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p8_" + name) / "lib.so"))
        entry = "i3dr_gauss_rays" if name[0] == "g" else "i3dr_wls_lines"
        fn = getattr(lib, entry)
        types = list(_build._SIGNATURES[entry])
        if name in SCRATCH:
            types.insert(4, ctypes.c_void_p)
        fn.argtypes = types
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
    ok = True

    # gauss_rays: masks bit-equal, values within 1e-6 relative (expf)
    table = gi._ray_table(32, 64, d.device)
    want_d, want_v = gi.gauss_interpolate(d, v, plain=True)
    out, vout = torch.empty_like(d), torch.empty_like(v)
    inv = 1.0 / 512.0
    gargs = (d.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
             vout.data_ptr(), B, H, W, 32, 6, 64.0, inv, 1.0, stream)
    calls = {}
    for name in [n for n in libs if n[0] == "g"]:
        out.fill_(float("nan"))
        assert libs[name](*gargs) == 0
        torch.cuda.synchronize()
        rel = ((out - want_d).abs() / want_d.abs().clamp(min=1e-30)).max()
        same = torch.equal(vout, want_v) and rel.item() <= 1e-6
        ok &= same or not VARIANTS[name][2]
        print(f"{name} masks bit-equal and values within 1e-6: {same} "
              f"(max relative {rel.item():.3g}, bit-equal "
              f"{torch.equal(out, want_d)})", flush=True)
        calls[name] = (lambda f: lambda: f(*gargs))(libs[name])

    # wls_lines, both passes: bit-equal
    lam = 1.5 * 8000.0 * 16.0 / 63.0
    a = v.float()
    g = wls.div_const(l, 255.0)
    keep = []
    for vertical in (False, True):
        w = wls._edge_weights(g, 0.15, -2 if vertical else -1).contiguous()
        want = wls.thomas_lines(a, w, d, lam, vertical=vertical, plain=True)
        u = torch.empty_like(d)
        if vertical:
            L, N, lay = W, H, (H * W, 1, W, (H - 1) * W, 1, W)
        else:
            L, N, lay = H, W, (H * W, W, 1, H * (W - 1), W - 1, 1)
        args = (a.data_ptr(), w.data_ptr(), d.data_ptr(), u.data_ptr(), B, L,
                N, *lay, lam, stream)
        scratch = torch.empty(2 * -(-B * L // 4) * 4 * N, device="cuda")
        args_scratch = args[:4] + (scratch.data_ptr(),) + args[4:]
        keep.append((w, u, scratch))
        for name in [n for n in libs if n[0] == "w"]:
            u.fill_(float("nan"))
            a_ = args_scratch if name in SCRATCH else args
            err = libs[name](*a_)
            torch.cuda.synchronize()
            if err:
                print(name, "vertical" if vertical else "horizontal",
                      "refused the shape (error", err, ")", flush=True)
                continue
            same = torch.equal(u, want)
            ok &= same or not VARIANTS[name][2]
            print(name, "vertical" if vertical else "horizontal",
                  "bit-equal", same, "max |diff|",
                  (u - want).abs().max().item(), flush=True)
            calls[f"{name}_{'v' if vertical else 'h'}"] = (
                lambda f, a_: lambda: f(*a_))(libs[name], a_)

    times = {k: [] for k in calls}
    order = list(calls)
    for turn in range(4):
        for k in (order if turn % 2 == 0 else order[::-1]):
            times[k].append(b2b(calls[k], 10 if k[0] == "g" else 20))
    for k, ts in times.items():
        print(f"{k}: {statistics.median(ts):.4f} ms a call back to back "
              f"(turns {', '.join(f'{t:.4f}' for t in ts)}) [{card}]",
              flush=True)
    if "w_clock" in libs:
        lib = ctypes.CDLL(str(BUILD / "p8_w_clock" / "lib.so"))
        names = ("stage", "eliminate", "rows", "interfaces", "substitute",
                 "store")
        lib.i3dr_probe_clocks_reset.restype = ctypes.c_int
        for key in ("w_clock_h", "w_clock_v"):
            assert lib.i3dr_probe_clocks_reset() == 0
            calls[key]()
            torch.cuda.synchronize()
            n_blocks = 65536
            buf = (ctypes.c_longlong * (n_blocks * 8))()
            assert lib.i3dr_probe_clocks(buf, n_blocks * 8) == 0
            t = torch.tensor(list(buf), dtype=torch.float64).view(-1, 8)
            t = t[t[:, 6] > 0]
            dt = t[:, 1:7] - t[:, 0:6]
            print(f"{key}: {t.shape[0]} blocks, mean cycles a block "
                  + ", ".join(f"{n} {v:.0f}" for n, v in
                              zip(names, dt.mean(0).tolist()))
                  + f", whole {(t[:, 6] - t[:, 0]).mean().item():.0f} "
                  f"(max {(t[:, 6] - t[:, 0]).max().item():.0f})",
                  flush=True)
    print("all variants agree with the twins:", ok, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
