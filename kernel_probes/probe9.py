"""Probe of the redesigns of ``bp_messages`` and of the census transform on
the GPU: the kernels as they are in ``csrc/`` and variants of them, built
with ``nvcc`` alone, each called through its C entry, held to the plain
twin and timed in turns (calls back to back between two events, and
events around one call).

- ``bp_messages`` at the BP frame's level 0 (1x1024x1280x128, one
  iteration, on that frame's data cost), at level 2 (1x128x256x320, 5
  iterations) and at CSBP's coarsest level (1x16x128x160, 8 iterations):
  ``m_new`` (``csrc/bp_messages.cu``: a block a strip of 32 pixels, the
  four forward scans in shared memory, pass 1's inputs copied by
  cp.async 16 disparities ahead); 8, 24, 32 or 64 ahead; the copies
  issued before the wait (``m_first``); the device-memory-staged kernel
  (``m_staged``, the kernel D > 446 takes); the forms in ``src/``: the first shared-memory form, pass 1's
  loads issued 4, 8, 16 or 32 disparities at a time into registers, or 8
  and 16 with the next batch's loads issued before the current one is
  scanned (``bp_messages_batch.cu``: ``m_batch*``, ``m_pipe*``), the
  staging in device memory run by a persistent grid whose live strips
  fit the L2 (``bp_messages_l2.cu``, 132 and 264 blocks of 128 threads),
  and the scans in registers for D <= 32 (``bp_messages_regs.cu``); the
  parent's kernel (``m_parent``) where a checkout of it is unpacked in
  ``_parent/``.
- the census transform of level 0's two images (2 x 2048x2560, 9x9):
  ``c_new`` (``csrc/census_transform.cu``: the tile copied by cp.async,
  a warp a row and a lane a column); interior tiles copied 16 bytes a
  copy (``c_fill16``); a block walking 1, 2, 4 or 8 tiles along x, each
  copied an element at a time into one of two buffers while the one
  before is computed (``src/census_tiles.cu``, ``c_tiles*``); the words
  staged in shared memory and each row's run stored as 16-byte vectors
  (``src/census_staged.cu``, ``c_staged``), as 4-byte words, with 64-
  column tiles, 16 rows a thread in 2 warps, 2 warps of 8 rows, its tile
  copied by cp.async or its fill loop unrolled; the parent's form
  (``c_parent*``, where ``_parent/`` holds it) as it is, with its tile
  copied by cp.async an element at a time or its fill loop unrolled; and,
  to find what holds a form, the parent's, the staged one and this one
  with the stores cut (``*_nostore``: the words folded into one that is
  never stored) or the tile loads cut (``*_noload``: the tile filled from
  its indices), which are timed only.
- where the strip kernel stops beating the staged one: both through
  ``m_new``'s C entry at 1x1024x1280 and D = 128, 192, 218, 219, 256,
  320, 384 and 446 (an SM holds 3 strip blocks to D = 142, 2 to 218,
  then 1), one iteration on random data, held equal to each other and
  timed in turns.
- the BP frame's plain-torch glue (``chip_smoke.py:bp_pipe``, BP at 128
  disparities, 1280x1024): one frame under ``torch.profiler`` with host
  ops, shapes and Python stacks; the ops whose own device time is
  largest, each with its shapes and its call site in the port, and the
  device kernels of the copies.

    python3 kernel_probes/probe9.py [--only bp,census,cut,glue]

from the repository root; ``--only`` runs some of the four parts.
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

BUILD = ROOT / "i3dr_stereo_tpu_torch" / "_kernels" / "probes"
CSRC = ROOT / "i3dr_stereo_tpu_torch" / "csrc"
# the parent's kernels, where a checkout of it is unpacked in _parent/
PARENT = ROOT / "_parent" / "i3dr_stereo_tpu_torch" / "csrc"
BP = (CSRC / "bp_messages.cu").read_text()
CENSUS = (CSRC / "census_transform.cu").read_text()
STAGED = (HERE / "src" / "census_staged.cu").read_text()
TILED = (HERE / "src" / "census_tiles.cu").read_text()


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


BATCH = (HERE / "src" / "bp_messages_batch.cu").read_text()


def unroll(n):
    return edit(BATCH, "constexpr int UNROLL = 8;",
                f"constexpr int UNROLL = {n};")


def ahead(n):
    return edit(BP, "constexpr int AHEAD = 16; ",
                f"constexpr int AHEAD = {n}; ")


WAIT = """  for (int d = 0; d < D; ++d) {
    __pipeline_wait_prior(AHEAD - 1);
"""
NEXT_COPIES = "    issue(d + AHEAD);   // its ring slot was last read AHEAD steps ago\n"


def issue_first():
    """The next copies issued before the wait, not after the step."""
    text = edit(BP, WAIT, """  for (int d = 0; d < D; ++d) {
    issue(d + AHEAD);
    __pipeline_wait_prior(AHEAD);
""")
    return edit(text, NEXT_COPIES, "")


PASS1 = """  int d = 0;
  for (; d + UNROLL <= D; d += UNROLL) {
    float v[UNROLL], a0[UNROLL], a1[UNROLL], a2[UNROLL], a3[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long o = (long long)(d + u) * hw;
      v[u] = __ldg(in.dat + o);
      a0[u] = in.has0 ? __ldg(in.m0 + o) : 0.f;
      a1[u] = in.has1 ? __ldg(in.m1 + o) : 0.f;
      a2[u] = in.has2 ? __ldg(in.m2 + o) : 0.f;
      a3[u] = in.has3 ? __ldg(in.m3 + o) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
"""
# the next batch's loads issued before the current batch is scanned
PIPE = """#define PROBE_LOAD(D0, V, A0, A1, A2, A3)                      \\
  _Pragma("unroll") for (int u = 0; u < UNROLL; ++u) {       \\
    const long long o = (long long)((D0) + u) * hw;          \\
    V[u] = __ldg(in.dat + o);                                \\
    A0[u] = in.has0 ? __ldg(in.m0 + o) : 0.f;                \\
    A1[u] = in.has1 ? __ldg(in.m1 + o) : 0.f;                \\
    A2[u] = in.has2 ? __ldg(in.m2 + o) : 0.f;                \\
    A3[u] = in.has3 ? __ldg(in.m3 + o) : 0.f;                \\
  }
  int d = 0;
  const int full = D - D % UNROLL;
  float v[UNROLL], a0[UNROLL], a1[UNROLL], a2[UNROLL], a3[UNROLL];
  if (full > 0) {
    PROBE_LOAD(0, v, a0, a1, a2, a3)
  }
  for (; d < full; d += UNROLL) {
    float w[UNROLL], b0[UNROLL], b1[UNROLL], b2[UNROLL], b3[UNROLL];
    if (d + UNROLL < full) {
      PROBE_LOAD(d + UNROLL, w, b0, b1, b2, b3)
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
"""
PIPE_END = """      q[3 * STRIP] = sc.f3;
    }
  }
  for (; d < D; ++d) {"""
PIPE_END_NEW = """      q[3 * STRIP] = sc.f3;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      v[u] = w[u]; a0[u] = b0[u]; a1[u] = b1[u]; a2[u] = b2[u]; a3[u] = b3[u];
    }
  }
  for (; d < D; ++d) {"""


def pipelined(n):
    return edit(edit(unroll(n), PASS1, PIPE), PIPE_END, PIPE_END_NEW)


TILE_LOAD = """    tile[r][c] = __ldg(img + (long long)clampi(y0 - PH + r, H - 1) * W +
                       clampi(x0 - PW + c, W - 1));"""
NO_LOAD = "    tile[r][c] = (float)((r * 131 + c * 71 + x0 + y0 + z) & 255);"
MAGIC = "(unsigned)B * 2654435761u + 12345u"
PARENT_STORE = "for (int k = 0; k < NW; ++k) o[k] = (int)words[r][k];"
PARENT_NO_STORE = ("{ unsigned acc = 0u; for (int k = 0; k < NW; ++k) acc ^= "
                   f"words[r][k]; if (acc == {MAGIC}) o[0] = (int)acc; }}")
NEW_FILL = """  for (int r = threadIdx.y; r < TH; r += FIX_WARPS) {
    const float* row = img + (long long)clampi(y0 - PH + r, H - 1) * W;
    __pipeline_memcpy_async(&tile[r][tx], row + c0, 4);
    if (tx + COLS < TW)
      __pipeline_memcpy_async(&tile[r][tx + COLS], row + c1, 4);
  }
"""
NEW_NO_LOAD = """  for (int r = threadIdx.y; r < TH; r += FIX_WARPS) {
    tile[r][tx] = (float)((r * 131 + c0 + y0 + z) & 255);
    if (tx + COLS < TW) tile[r][tx + COLS] = (float)((r * 71 + c1) & 255);
  }
"""
# interior tiles of rows 16-byte aligned copied 16 bytes a copy
NEW_FILL16 = """  if (W % 4 == 0 && x0 - PW >= 0 && x0 - PW + TW <= W &&
      (uintptr_t)img % 16 == 0) {
    for (int i = threadIdx.y * COLS + tx; i < TH * (TW / 4);
         i += COLS * FIX_WARPS) {
      const int r = i / (TW / 4), q = i - r * (TW / 4);
      __pipeline_memcpy_async(
          &tile[r][4 * q],
          img + (long long)clampi(y0 - PH + r, H - 1) * W + x0 - PW + 4 * q,
          16);
    }
  } else {
""" + NEW_FILL + "  }\n"
NEW_STAGE = "  // each row's words staged"
NEW_NO_STORE = f"""  {{
    unsigned acc = 0u;
#pragma unroll
    for (int r = 0; r < FIX_ROWS; ++r)
#pragma unroll
      for (int k = 0; k < NW; ++k) acc ^= words[r][k];
    if (acc == {MAGIC}) out[tid] = (int)acc;
    return;
  }}
""" + NEW_STAGE


TILE_AFTER = """  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y * FIX_ROWS;"""


def tile_async(text):
    """The tile and halo copied by cp.async, all of a thread's copies in
    flight at once."""
    text = edit(text, TILE_LOAD, TILE_LOAD.replace(
        "tile[r][c] = __ldg(", "__pipeline_memcpy_async(&tile[r][c], ")
        .replace("W - 1));", "W - 1), 4);"))
    text = edit(text, TILE_AFTER, TILE_AFTER.replace(
        "  __syncthreads();", "  __pipeline_commit();\n"
        "  __pipeline_wait_prior(0);\n  __syncthreads();"))
    return "#include <cuda_pipeline.h>\n" + text


def tile_unrolled(text, head):
    """The tile loop with a constant trip count, unrolled: every load of a
    thread issued before the first store to the tile."""
    text = edit(text, head, """#pragma unroll
  for (int k = 0; k < (TH * TW + COLS * FIX_WARPS - 1) / (COLS * FIX_WARPS);
       ++k) {
    const int i = threadIdx.y * COLS + threadIdx.x + k * COLS * FIX_WARPS;
    if (i >= TH * TW) break;""")
    return text


PARENT_HEAD = """  for (int i = threadIdx.y * COLS + threadIdx.x; i < TH * TW;
       i += COLS * FIX_WARPS) {"""
NEW_HEAD = "  for (int i = tid; i < TH * TW; i += COLS * FIX_WARPS) {"


def census_shape(rows, warps):
    text = edit(STAGED, "constexpr int FIX_ROWS = 8;",
                f"constexpr int FIX_ROWS = {rows};")
    return edit(text, "constexpr int FIX_WARPS = 4;",
                f"constexpr int FIX_WARPS = {warps};")


def tiles(n):
    return edit(TILED, "constexpr int TILES = 4; ",
                f"constexpr int TILES = {n}; ")


def strip_bytes(ahead_by):
    """The C entry's shared-memory argument of a 32-pixel strip block
    whose copies run ``ahead_by`` disparities ahead, as a function of D."""
    return lambda D: 4 * (4 * D + 2 * ahead_by) * 32


def fixed(n):
    return lambda D: n


def variants():
    """name -> (kernel, source text, the C entry's last int argument as a
    function of D, or "none" where the entry has none, held to the
    twin). ``csrc``'s entry takes a strip block's shared memory (0: the
    staged kernel); the forms in ``src/`` take a strip (32) or a grid."""
    v = {
        "m_new": ("bp", BP, strip_bytes(16), True),
        "m_ahead8": ("bp", ahead(8), strip_bytes(8), True),
        "m_ahead24": ("bp", ahead(24), strip_bytes(24), True),
        "m_ahead32": ("bp", ahead(32), strip_bytes(32), True),
        "m_ahead64": ("bp", ahead(64), strip_bytes(64), True),
        "m_first": ("bp", issue_first(), strip_bytes(16), True),
        "m_staged": ("bp", BP, fixed(0), True),
        "m_batch": ("bp", BATCH, fixed(32), True),
        "m_batch4": ("bp", unroll(4), fixed(32), True),
        "m_batch16": ("bp", unroll(16), fixed(32), True),
        "m_batch32": ("bp", unroll(32), fixed(32), True),
        "m_pipe": ("bp", pipelined(8), fixed(32), True),
        "m_pipe16": ("bp", pipelined(16), fixed(32), True),
        "m_l2_132": ("bp", (HERE / "src" / "bp_messages_l2.cu").read_text(),
                     fixed(132), True),
        "m_l2_264": ("bp", (HERE / "src" / "bp_messages_l2.cu").read_text(),
                     fixed(264), True),
        "m_regs": ("bp", (HERE / "src" / "bp_messages_regs.cu").read_text(),
                   fixed(0), True),
        "c_new": ("census", CENSUS, None, True),
        "c_fill16": ("census", edit(edit(
            CENSUS, NEW_FILL, NEW_FILL16), "  __shared__ float tile[TH][TW];",
            "  __shared__ __align__(16) float tile[TH][TW];"), None, True),
        "c_tiles1": ("census", tiles(1), None, True),
        "c_tiles2": ("census", tiles(2), None, True),
        "c_tiles4": ("census", TILED, None, True),
        "c_tiles8": ("census", tiles(8), None, True),
        "c_new_nostore": ("census",
                          edit(CENSUS, PARENT_STORE, PARENT_NO_STORE), None,
                          False),
        "c_new_noload": ("census", edit(CENSUS, NEW_FILL, NEW_NO_LOAD), None,
                         False),
        "c_staged": ("census", STAGED, None, True),
        "c_staged_scalar": ("census",
                            edit(STAGED, "const bool vec = W % 4 == 0 &&",
                                 "const bool vec = false && W % 4 == 0 &&"),
                            None, True),
        "c_staged_wide": ("census", edit(STAGED, "constexpr int COLS = 32;",
                                         "constexpr int COLS = 64;"), None,
                          True),
        "c_staged_rows16": ("census", census_shape(16, 2), None, True),
        "c_staged_warps2": ("census", census_shape(8, 2), None, True),
        "c_staged_async": ("census", tile_async(STAGED), None, True),
        "c_staged_unroll": ("census", tile_unrolled(STAGED, NEW_HEAD), None,
                            True),
        "c_staged_nostore": ("census", edit(STAGED, NEW_STAGE, NEW_NO_STORE),
                             None, False),
        "c_staged_noload": ("census", edit(STAGED, TILE_LOAD, NO_LOAD), None,
                            False),
    }
    if PARENT.exists():
        pbp = (PARENT / "bp_messages.cu").read_text()
        pc = (PARENT / "census_transform.cu").read_text()
        v["m_parent"] = ("bp", pbp, "none", True)
        v["c_parent"] = ("census", pc, None, True)
        v["c_parent_nostore"] = ("census",
                                 edit(pc, PARENT_STORE, PARENT_NO_STORE),
                                 None, False)
        v["c_parent_noload"] = ("census", edit(pc, TILE_LOAD, NO_LOAD), None,
                                False)
        v["c_parent_async"] = ("census", tile_async(pc), None, True)
        v["c_parent_unroll"] = ("census", tile_unrolled(pc, PARENT_HEAD),
                                None, True)
    return v


def build(vs):
    from i3dr_stereo_tpu_torch import _build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    procs = {}
    for name, (_, text, _, _) in vs.items():
        d = BUILD / ("p9_" + name)
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
                               or "smem" in l), flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p9_" + name) / "lib.so"))
        kernel, _, arg, _ = vs[name]
        if kernel == "bp":
            lib.i3dr_bp_messages.argtypes = (
                [P, P, P, I, I, I, I, F, F, F, P] if arg == "none"
                else [P, P, P, I, I, I, I, F, F, F, I, P])
        else:
            lib.i3dr_census_transform.argtypes = [P, P, P, P, I, I, I, I, I,
                                                  P]
        libs[name] = lib
    return libs


def b2b(fn, iters, warm=2):
    import torch

    for _ in range(warm):
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


def events(fn, n, warm=2):
    import torch

    for _ in range(warm):
        fn()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def in_turns(label, calls, card, iters, rounds=2):
    """b2b and events of every call, in turns: forwards, then backwards."""
    names = list(calls)
    for kind, f, n in (("b2b", b2b, iters), ("events", events, 5)):
        t = {k: [] for k in names}
        for rnd in range(rounds):
            for k in (names if rnd % 2 == 0 else names[::-1]):
                t[k].append(f(calls[k], n))
        for k in names:
            print(f"[{card}] {label} {kind} {k}: "
                  + " ".join(f"{x:.4f}" for x in t[k]), flush=True)


def bp_glue(card):
    """Which host ops issue the BP frame's device time: one profiled frame
    after two warm-up frames (one of them profiled, so that the
    profiler's first records are not the ones read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from i3dr_stereo_tpu_torch.config import params

    pipe, left, right, _, _ = cs.bp_pipe(params.Algorithm.BP_GPU)
    pipe.process(left, right)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=acts, record_shapes=True,
                     with_stack=True) as prof:
            pipe.process(left, right)
            torch.cuda.synchronize()
    dev_self = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    # each op's device time, by the op, its top-level aten op, its shapes
    # and the first call site in the port above it
    sites = {}
    for e in prof.events():
        t = dev_self(e)
        if not t or not e.name.startswith("aten::"):
            continue
        top, site, p = e.name, "?", e.cpu_parent
        for f in e.stack or []:
            if "i3dr_stereo_tpu_torch/" in f:
                site = f.split("i3dr_stereo_tpu_torch/")[-1]
                break
        while p is not None:
            if p.name.startswith("aten::"):
                top = p.name
            elif "i3dr_stereo_tpu_torch/" in p.name and site == "?":
                site = p.name.split("i3dr_stereo_tpu_torch/")[-1]
            p = p.cpu_parent
        key = (e.name, top, str(e.input_shapes)[:80], site)
        acc = sites.setdefault(key, [0, 0.0])
        acc[0] += 1
        acc[1] += t
    total = sum(t for _, t in sites.values())
    print(f"[{card}] BP frame, device time under host ops {total / 1e3:.3f} "
          f"ms; the largest by op, top-level op, shapes and call site:",
          flush=True)
    for (name, top, shapes, site), (n, t) in sorted(
            sites.items(), key=lambda kv: -kv[1][1])[:20]:
        print(f"  {t / 1e3:8.3f} ms {n:4d}x {name} under {top} {shapes} "
              f"at {site}", flush=True)
    kern = sorted(((k.key, dev_self(k), k.count) for k in prof.key_averages()
                   if dev_self(k) > 0 and not k.key.startswith("aten::")),
                  key=lambda x: -x[1])
    for name, t, n in kern[:12]:
        print(f"  kernel {t / 1e3:8.3f} ms {n:4d}x {name[:110]}", flush=True)


def bp_variants(cs, vs, libs, card, st):
    """Every bp_messages variant held to the twin at three shapes, each
    shape's variants then timed in turns."""
    import numpy as np
    import torch

    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers import bp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    sc = layered_scene(cs.H_SGBM, cs.W_SGBM, **cs.SGBM_SCENE)
    l = torch.tensor(sc.left, device=dev)[None]
    r = torch.tensor(sc.right, device=dev)[None]
    data0 = bp.data_cost(l, r, 0, 128)
    data2 = bp._pool2(bp._pool2(data0))
    datac = bp.data_cost(*(bp._downsample2(bp._downsample2(bp._downsample2(
        x))) for x in (l, r)), 0, 16)
    shapes = {"level0": (data0, 1), "level2": (data2, 5),
              "csbp_coarsest": (datac, 8)}

    def bp_call(name, data, msgs, outs, iters):
        B, D, H, W = data.shape
        arg = vs[name][2]
        inv = float(np.float32(1) / np.float32(D))
        fn = libs[name].i3dr_bp_messages
        pre = (B, D, H, W, 1.0, 1.7, inv)
        tail = (st,) if arg == "none" else (arg(D), st)

        def call():
            src = msgs
            for i in range(iters):
                dst = outs[i % 2]
                err = fn(data.data_ptr(), src.data_ptr(), dst.data_ptr(),
                         *pre, *tail)
                assert err == 0, (name, err)
                src = dst
            return src
        return call

    for label, (data, iters) in shapes.items():
        msgs = 0.3 * torch.randn((4,) + data.shape, device=dev, generator=gen)
        want = bp.bp_iterate(data, msgs, iters, 1.0, 1.7, plain=True)
        outs = [torch.empty_like(msgs), torch.empty_like(msgs)]
        calls = {}
        for name in libs:
            if vs[name][0] != "bp":
                continue
            if name == "m_regs" and data.shape[1] > 32:
                continue
            call = bp_call(name, data, msgs, outs, iters)
            got = call()
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"bp_messages {label} {tuple(data.shape)} x{iters} {name}: "
                  f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
            calls[name] = call
        in_turns(f"bp_messages {label}", calls, card,
                 iters=10 if label == "level0" else 20)
        del msgs, want, outs
        torch.cuda.empty_cache()


def strip_cut(libs, card, st):
    """The strip kernel and the staged one through ``m_new``'s C entry at
    1x1024x1280 and each D, one iteration on random data: held equal to
    each other (each is held to the twin at D = 446 / 447 by
    chip_smoke.py), then timed in turns."""
    import numpy as np
    import torch

    fn = libs["m_new"].i3dr_bp_messages
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    for D in (128, 192, 218, 219, 256, 320, 384, 446):
        data = torch.rand((1, D, 1024, 1280), device=dev, generator=gen)
        msgs = 0.3 * torch.randn((4,) + data.shape, device=dev,
                                 generator=gen)
        outs = {k: torch.empty_like(msgs) for k in ("strip", "staged")}
        pre = (*data.shape, 1.0, 1.7, float(np.float32(1) / np.float32(D)))
        calls = {}
        for k, shared in (("strip", strip_bytes(16)(D)), ("staged", 0)):
            args = (data.data_ptr(), msgs.data_ptr(), outs[k].data_ptr(),
                    *pre, shared, st)
            calls[k] = (lambda args: lambda: fn(*args))(args)
            assert calls[k]() == 0, (k, D)
        torch.cuda.synchronize()
        same = torch.equal(outs["strip"], outs["staged"])
        print(f"bp_messages 1x1024x1280x{D} strip ({strip_bytes(16)(D)} "
              f"bytes a block) against staged: "
              f"{'equal' if same else 'DIFFER'}", flush=True)
        in_turns(f"bp_messages cut D={D}", calls, card, iters=5)
        del data, msgs, outs, calls
        torch.cuda.empty_cache()


def main():
    import torch

    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    parts = (sys.argv[sys.argv.index("--only") + 1].split(",")
             if "--only" in sys.argv else ("bp", "census", "cut", "glue"))
    vs = {k: v for k, v in variants().items()
          if {"m": "bp", "c": "census"}[k[0]] in parts
          or (k == "m_new" and "cut" in parts)}
    libs = build(vs)
    st = torch.cuda.current_stream().cuda_stream
    if "bp" in parts:
        bp_variants(cs, vs, libs, card, st)
    if "cut" in parts:
        strip_cut(libs, card, st)
    if "census" in parts:
        census_variants(cs, vs, libs, card, st)
    if "glue" in parts:
        bp_glue(card)


def census_variants(cs, vs, libs, card, st):
    """Every census variant held to the twin (or timed only), then timed
    in turns at level 0."""
    import numpy as np
    import torch

    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops.census import census_transform_plain

    dev = torch.device("cuda")
    cfg = cs.flagship_cfg(params)
    fsc = layered_scene(cs.H_FULL, cs.W_FULL, **cs.SCENE)
    _, lp, rp, pred, q, _, _, _ = next(cs.flagship_levels(cfg, fsc))
    rw = bg.block_shift_gather_plain(rp, pred, q, 16).contiguous()
    rng = np.random.default_rng(2)
    cases = [(lp, rw)] + [
        tuple(torch.tensor(rng.uniform(0, 255, shape), dtype=torch.float32,
                           device=dev) for _ in range(2))
        for shape in ((2, 45, 131), (1, 5, 6), (2, 70, 2449), (1, 1, 64),
                      (2, 33, 1), (1, 40, 200))]
    calls, keep = {}, []
    for name in libs:
        if vs[name][0] != "census":
            continue
        held = vs[name][3]
        ok = 0
        for a, b in cases:
            B, H, W = a.shape
            oa = torch.empty(a.shape + (3,), dtype=torch.int32, device=dev)
            ob = torch.empty_like(oa)
            keep.append((oa, ob))
            args = (a.data_ptr(), b.data_ptr(), oa.data_ptr(), ob.data_ptr(),
                    B, H, W, 9, 9, st)
            fn = (lambda lib, args: lambda: lib.i3dr_census_transform(*args))(
                libs[name], args)
            assert fn() == 0, name
            torch.cuda.synchronize()
            ok += (torch.equal(oa, census_transform_plain(a, 9, 9))
                   and torch.equal(ob, census_transform_plain(b, 9, 9)))
            if a is lp:
                calls[name] = fn
        print(f"census {name}: {ok} of {len(cases)} bit-equal"
              + ("" if held else " (timed only)"), flush=True)
    in_turns("census level 0", calls, card, iters=20)


if __name__ == "__main__":
    main()
