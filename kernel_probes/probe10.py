"""Probe of the redesign of ``icp_step`` on the GPU: the parent's kernel
(two launches a step) and the one-launch track, with variants of each,
built with ``nvcc`` alone, each called through its C entry, held to the
plain twin and timed in turns.

Inputs: frames 0 and 1 of ``chip_smoke.py``'s moving rig (2448x2048, its
room and trajectory), packed by this checkout's ``pack_maps`` into the
3-level pyramid the tracker runs; the parent's kernels read the record's
two halves as the two (H, W, 4) maps they took, or the record itself
where a variant reads it.

Variants (``p_*`` from the parent's ``csrc/icp_step.cu``, where a
checkout of it is unpacked in ``_parent/``; ``n_*`` from this one's):

- ``p``: the parent as it is: ``icp_terms_kernel`` (a pixel at a time,
  the normal gathered, tested, then the vertex) and ``icp_solve_kernel``
  (one block adds the partials, one thread solves);
- ``p_terms``: the parent without its solve launch (the sums alone), so
  ``p - p_terms`` is what the serial solve and its launch cost a step;
- ``p_together``: the parent with both gathers issued before the ok test;
- ``p_record``: the parent gathering from the 32-byte record (both halves
  in one sector); ``p_record_together``: both changes;
- ``n``: ``csrc/icp_step.cu`` (one cooperative launch a track, PIX = 4
  pixels in flight a thread, at least 2 blocks an SM, every block adding
  the partials and solving);
- ``n_pix1``, ``n_pix2``, ``n_pix8``: 1, 2 or 8 pixels in flight;
- ``n_b1``, ``n_b3``, ``n_b4``, ``n_pix2_b3``, ``n_pix2_b4``: the register
  budget from ``__launch_bounds__(256, B)``;
- ``n_block0``: one block adds the partials and solves, and a second grid
  barrier publishes T (the other form of the choice);
- ``n_first``: the first form of the one-launch kernel (a warp a sum
  reading the blocks' partials strided; the solve's pivot swapped by
  index, the system in local memory); ``n_first_reduce`` and
  ``n_first_solve``: one of the two alone;
- ``n_lines``: the partials read as chip call 2 read them, a warp a
  block's line (a lane a sum), where today a thread reads 16 bytes and
  issues all its loads together;
- ``n_tx512``: blocks of 512 threads, one an SM (half the partials to
  read, half the barrier's arrivals);
- ``n_empty``: every step without its pixels (the sums stay 0): what a
  step's barrier, reduction and solve cost alone; ``n_empty_lines`` with
  ``n_lines``' reduction; ``n_empty_nosolve``, ``_nosync`` (a block
  barrier in place of the grid's: racy) and ``_nocross`` (no reading of
  the partials) without one part each (all timed only);
- ``n_spin``: the grid barrier hand-rolled (one atomic a block, a
  generation word spun on) in place of cooperative groups' ``grid.sync``.

For each: ptxas's registers, the grid (blocks an SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), a step at each level
by events (median of 10) and back to back (50 calls between two events),
a whole track (4 / 7 / 10 steps at levels 0 / 1 / 2; the parent's 21
entry calls) by events and back to back (20 tracks), the host's time to
issue one entry call, and the checks: a step at level 0 from the identity
against the twin (the same pixels: sum w equal; A within 1e-4 of its
scale), the track against the twins' (1e-4 m, 5e-3 deg), and for the
one-launch kernels 5 reruns bit-identical. Every variant is timed twice,
in the order given and then reversed.

    python3 kernel_probes/probe10.py [--only pack | --only VARIANT,...]

from the repository root (the card's name and power limit head the
output). ``--only pack`` times instead ``pack_maps`` at 2448x2048 with
its maps built from the vertex, normal and flags four ways (held equal),
and the parent's two maps, in turns.
"""
import ctypes
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from i3dr_stereo_tpu_torch import _build  # noqa: E402
from i3dr_stereo_tpu_torch.mapping import odometry as odo  # noqa: E402
from i3dr_stereo_tpu_torch.mapping import render_plane_depth  # noqa: E402

BUILD = ROOT / "i3dr_stereo_tpu_torch" / "_kernels" / "probes"
NEW = (ROOT / "i3dr_stereo_tpu_torch" / "csrc" / "icp_step.cu").read_text()
PARENT_SRC = (ROOT / "_parent" / "i3dr_stereo_tpu_torch" / "csrc"
              / "icp_step.cu")
ITERS = (4, 7, 10)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


# the parent's source: the solve launch, the gathers
P_SOLVE = """  icp_solve_kernel<<<1, 1024, 0, s>>>((const float*)partials, blocks,
                                      (float*)state, inv_hw);
  return (int)cudaGetLastError();"""
P_GATHER = """    const float4 nq = __ldg(prev_n + j);
    if (!(nq.w > 0.f)) continue;
    const float4 q = __ldg(prev_v + j);"""
P_TOGETHER = """    const float4 nq = __ldg(prev_n + j);
    const float4 q = __ldg(prev_v + j);
    if (!(nq.w > 0.f)) continue;"""
P_OCCUPANCY = """
extern "C" int probe_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, icp_terms_kernel, TX, 0);
}
"""


def p_record(text):
    text = edit(text, "__ldg(prev_n + j)", "__ldg(prev_n + 2 * j)")
    return edit(text, "__ldg(prev_v + j)", "__ldg(prev_v + 2 * j)")


# this checkout's source: the reduction and solve after the barrier
N_SOLVE = """      grid.sync();
      // every block: all blocks' partials in one fixed order, through L2;
      // thread t adds quarter t % 8 (16 bytes) of the lines of blocks
      // t / 8, t / 8 + 32, ..., its loads issued together; then lanes 8
      // and 16 apart, then the 8 warps in order
      {
        const int q = threadIdx.x & 7;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int b = threadIdx.x >> 3; b < (int)gridDim.x; b += TX / 8) {
          const float4 w =
              __ldcg((const float4*)(part + (size_t)b * SLOT) + q);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
#pragma unroll
        for (int o = 8; o < 32; o <<= 1) {
          v.x += __shfl_xor_sync(FULL, v.x, o);
          v.y += __shfl_xor_sync(FULL, v.y, o);
          v.z += __shfl_xor_sync(FULL, v.z, o);
          v.w += __shfl_xor_sync(FULL, v.w, o);
        }
        if (lane < 8) {
          red[warp][4 * q] = v.x;
          red[warp][4 * q + 1] = v.y;
          red[warp][4 * q + 2] = v.z;
          red[warp][4 * q + 3] = v.w;
        }
        __syncthreads();
        if (threadIdx.x < NT) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) t += red[w][threadIdx.x];
          tot[threadIdx.x] = t;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) solve_update(tot, L.inv_hw, T, out);
      __syncthreads();"""
# the form of chip call 2: a warp reads a block's line (a lane a sum)
N_LINES = """      grid.sync();
      // every block: all blocks' partials in one fixed order, through L2;
      // warp w reads blocks w, w + 8, ... (a block's slot is one line, a
      // lane a sum), then the 8 warps' totals are added in order
      {
        float s = 0.f;
        if (lane < NT) {
#pragma unroll 8
          for (int b = warp; b < (int)gridDim.x; b += WARPS)
            s += __ldcg(part + (size_t)b * SLOT + lane);
          red[warp][lane] = s;
        }
        __syncthreads();
        if (threadIdx.x < NT) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) t += red[w][threadIdx.x];
          tot[threadIdx.x] = t;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) solve_update(tot, L.inv_hw, T, out);
      __syncthreads();"""
# block 0 alone adds the partials (as today) and solves; a second barrier
# publishes T through the scratch after the two partial buffers
_REDUCE = N_SOLVE[len("      grid.sync();\n"):N_SOLVE.index(
    "      __syncthreads();\n      if (threadIdx.x == 0) solve_update")]
N_BLOCK0 = ("      grid.sync();\n"
            "      float* tpub = partials + (size_t)2 * gridDim.x * SLOT;\n"
            "      if (blockIdx.x == 0) {\n" + _REDUCE + """      __syncthreads();
        if (threadIdx.x == 0) {
          solve_update(tot, L.inv_hw, T, out);
          for (int k = 0; k < 16; ++k) tpub[k] = T[k];
        }
      }
      grid.sync();
      if (threadIdx.x < 16) T[threadIdx.x] = __ldcg(tpub + threadIdx.x);
      __syncthreads();""")
# the first form of the one-launch kernel (chip call 1): a warp a sum
# reading the blocks' partials strided, and the solve with the pivot's row
# swap by index (the system in local memory)
N_FIRST_REDUCE = """      grid.sync();
      for (int k = warp; k < NT; k += WARPS) {
        float s = 0.f;
        for (int b = lane; b < (int)gridDim.x; b += 32)
          s += __ldcg(part + (size_t)b * SLOT + k);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        if (lane == 0) tot[k] = s;
      }
      __syncthreads();
      if (threadIdx.x == 0) solve_update(tot, L.inv_hw, T, out);
      __syncthreads();"""
N_FIRST_SOLVE = """__device__ void solve_update(const float tot[NT], float inv_hw, float T[16],
                             float out[2]) {
  float A[36], x[6];
  int a = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) A[6 * i + j] = A[6 * j + i] = tot[a++];
  for (int i = 0; i < 6; ++i) x[i] = -tot[21 + i];
  for (int i = 0; i < 6; ++i) A[7 * i] += 1e-6f;
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[6 * i + k]) > fabsf(A[6 * piv + k])) piv = i;
    if (piv != k) {
      for (int j = 0; j < 6; ++j) {
        const float s = A[6 * k + j];
        A[6 * k + j] = A[6 * piv + j];
        A[6 * piv + j] = s;
      }
      const float s = x[k];
      x[k] = x[piv];
      x[piv] = s;
    }
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[6 * i + k] / A[7 * k];
      for (int j = k + 1; j < 6; ++j) A[6 * i + j] -= l * A[6 * k + j];
      x[i] -= l * x[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    float s = x[k];
    for (int j = k + 1; j < 6; ++j) s -= A[6 * k + j] * x[j];
    x[k] = s / A[7 * k];
  }
  float Tl[16];
  for (int k = 0; k < 16; ++k) Tl[k] = T[k];
  se3_update(x, Tl);
  for (int k = 0; k < 16; ++k) T[k] = Tl[k];
  const float nw = fmaxf(tot[NT - 1], 1.f);
  out[0] = sqrtf(tot[NT - 2] / nw);
  out[1] = nw * inv_hw;
}

"""


def empty(text):
    return edit(text, "      accumulate(L, tr.thr2, T, acc);\n", "")


def first_tail(text, reduce=True, solve=True):
    """The first form's reduction and / or solve in place of today's."""
    if reduce:
        text = edit(text, N_SOLVE, N_FIRST_REDUCE)
    if solve:
        a = text.index("__device__ __forceinline__ void solve_update(")
        b = text.index("__global__ void __launch_bounds__(TX, MIN_BLOCKS)")
        text = text[:a] + N_FIRST_SOLVE + text[b:]
    return text


# a barrier of one atomic a block and a generation word, in the scratch
# after the partials and T (zeroed once; the last block to arrive resets
# the count), in place of cooperative groups' grid.sync()
SPIN = """__device__ __forceinline__ void spin_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(TX, MIN_BLOCKS)"""


def n_variant(pix=4, blocks=2, block0=False, spin=False):
    text = edit(NEW, "constexpr int PIX = 4;", f"constexpr int PIX = {pix};")
    text = edit(text, "constexpr int MIN_BLOCKS = 2;",
                f"constexpr int MIN_BLOCKS = {blocks};")
    if block0:
        text = edit(text, N_SOLVE, N_BLOCK0)
    if spin:
        text = edit(text, "__global__ void __launch_bounds__(TX, MIN_BLOCKS)",
                    SPIN)
        text = edit(text, "  cg::grid_group grid = cg::this_grid();\n",
                    "  unsigned* bar = (unsigned*)(partials + (size_t)2 * "
                    "gridDim.x * SLOT + 16);\n")
        text = edit(text, "      grid.sync();\n", "      spin_sync(bar);\n")
    return text


def variants():
    vs = {}
    if PARENT_SRC.exists():
        parent = PARENT_SRC.read_text() + P_OCCUPANCY
        vs["p"] = ("p", parent, "two")
        vs["p_terms"] = ("p", edit(parent, P_SOLVE,
                                   "  return (int)cudaSuccess;"), "two")
        vs["p_together"] = ("p", edit(parent, P_GATHER, P_TOGETHER), "two")
        vs["p_record"] = ("p", p_record(parent), "record")
        vs["p_record_together"] = (
            "p", p_record(edit(parent, P_GATHER, P_TOGETHER)), "record")
    else:
        print(f"no parent at {PARENT_SRC}: its variants are skipped",
              flush=True)
    vs["n"] = ("n", NEW, "record")
    for pix in (1, 2, 8):
        vs[f"n_pix{pix}"] = ("n", n_variant(pix=pix), "record")
    for b in (1, 3, 4):
        vs[f"n_b{b}"] = ("n", n_variant(blocks=b), "record")
    for b in (3, 4):
        vs[f"n_pix2_b{b}"] = ("n", n_variant(pix=2, blocks=b), "record")
    vs["n_block0"] = ("n", n_variant(block0=True), "record")
    vs["n_lines"] = ("n", edit(NEW, N_SOLVE, N_LINES), "record")
    vs["n_tx512"] = ("n", edit(n_variant(blocks=1), "constexpr int TX = 256;",
                               "constexpr int TX = 512;"), "record")
    vs["n_empty"] = ("n", empty(NEW), "record")
    vs["n_empty_lines"] = ("n", empty(edit(NEW, N_SOLVE, N_LINES)), "record")
    vs["n_empty_nosolve"] = ("n", edit(
        empty(NEW), "      if (threadIdx.x == 0) solve_update(tot, L.inv_hw, "
        "T, out);\n", ""), "record")
    vs["n_empty_nosync"] = ("n", edit(empty(NEW), "      grid.sync();\n",
                                      "      __syncthreads();\n"), "record")
    vs["n_empty_nocross"] = ("n", edit(empty(NEW), N_SOLVE, """      grid.sync();
      __syncthreads();
      if (threadIdx.x == 0) solve_update(tot, L.inv_hw, T, out);
      __syncthreads();"""), "record")
    vs["n_first"] = ("n", first_tail(NEW), "record")
    vs["n_first_reduce"] = ("n", first_tail(NEW, solve=False), "record")
    vs["n_first_solve"] = ("n", first_tail(NEW, reduce=False), "record")
    vs["n_spin"] = ("n", n_variant(spin=True), "record")
    return vs


def build(vs):
    procs = {}
    for name, (_, text, _) in vs.items():
        d = BUILD / ("p10_" + name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"BUILD FAILED {name}\n{log[-4000:]}", flush=True)
            continue
        print(f"{name}: " + " | ".join(
            l.strip() for l in log.splitlines()
            if "registers" in l or ("spill" in l and " 0 bytes spill" not in l))
            [:600], flush=True)
        lib = ctypes.CDLL(str(BUILD / ("p10_" + name) / "lib.so"))
        if vs[name][0] == "p":
            lib.i3dr_icp_step.argtypes = [_P] * 5 + [_I, _I] + [_F] * 6 + [_P]
            lib.i3dr_icp_step.restype = _I
            lib.probe_occupancy.argtypes = [_P]
        else:
            lib.i3dr_icp_track.argtypes = list(
                _build._SIGNATURES["i3dr_icp_track"])
            lib.i3dr_icp_track.restype = _I
            lib.i3dr_icp_grid.argtypes = [_L, _P]
        libs[name] = lib
    return libs


def events_ms(fn, n=10, warm=2):
    for _ in range(warm):
        fn()
    t = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        t.append(a.elapsed_time(b))
    return statistics.median(t)


def b2b_ms(fn, iters, warm=3):
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


def host_us(fn, n=200):
    """The host's time to issue one call (no sync inside the n calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


class Runner:
    """The calls of one variant on the rig's pyramids."""

    def __init__(self, name, kind, layout, lib, prev, cur, K):
        self.name, self.kind, self.lib = name, kind, lib
        self.state = torch.zeros(odo.STATE, device="cuda")
        self.stream = _build.stream_of(self.state)
        self.levels = odo.track_levels(prev, cur, K, ITERS)
        n0 = cur[0][0].shape[0] * cur[0][0].shape[1]
        if kind == "p":
            blocks = ctypes.c_int(0)
            check_err(lib.probe_occupancy(ctypes.addressof(blocks)), name)
            self.per_sm = blocks.value
            self.partials = torch.empty(1024 * 32, device="cuda")
            self.keep = []
            if layout == "record":
                halves = [(rec.data_ptr(), rec.data_ptr() + 16)
                          for _, rec, _, _ in self.levels]
            else:
                pairs = [(rec[..., :4].contiguous(), rec[..., 4:].contiguous())
                         for _, rec, _, _ in self.levels]
                self.keep.append(pairs)
                halves = [(v.data_ptr(), n.data_ptr()) for v, n in pairs]
            self.args = []
            for (c, _, cam, _), (pv, pn) in zip(self.levels, halves):
                h, w = c.shape[:2]
                thr2, inv_hw = odo._step_scalars(0.5, h, w)
                self.args.append((c.data_ptr(), pv, pn,
                                  self.partials.data_ptr(),
                                  self.state.data_ptr(), h, w,
                                  *(float(x) for x in cam), float(thr2),
                                  float(inv_hw), self.stream))
        else:
            blocks = ctypes.c_int(0)
            check_err(lib.i3dr_icp_grid(n0, ctypes.addressof(blocks)), name)
            self.blocks = blocks.value
            self.partials = torch.zeros(2 * self.blocks * 32 + 32,
                                        device="cuda")
            self.tables = [odo.launch_table([(c, r, cam, 1)], 0.5)
                           for c, r, cam, _ in self.levels]
            self.track_table = odo.launch_table(self.levels, 0.5)

    def reset(self):
        self.state.zero_()
        self.state[:16] = torch.eye(4, device="cuda").reshape(-1)

    def _launch(self, table, n):
        maps, dims, cams, thr2 = table
        err = self.lib.i3dr_icp_track(n, maps.ctypes.data, dims.ctypes.data,
                                      cams.ctypes.data, float(thr2),
                                      self.partials.data_ptr(),
                                      self.state.data_ptr(), self.blocks,
                                      self.stream)
        check_err(err, self.name)

    def step_fn(self, li):
        """One step at pyramid level li (0 = finest)."""
        i = len(self.levels) - 1 - li
        if self.kind == "p":
            args = self.args[i]
            return lambda: check_err(self.lib.i3dr_icp_step(*args), self.name)
        return lambda: self._launch(self.tables[i], 1)

    def track(self):
        if self.kind == "p":
            for args, (_, _, _, steps) in zip(self.args, self.levels):
                self.state[16:18] = 0.0
                for _ in range(steps):
                    check_err(self.lib.i3dr_icp_step(*args), self.name)
        else:
            self._launch(self.track_table, len(self.levels))


def check_err(err, name):
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def rig_pyramids():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    poses = cs.map_trajectory()[:2]
    depths = [render_plane_depth(cs.MAP_K, T, cs.MAP_SCENE, cs.H_FULL,
                                 cs.W_FULL) for T in poses]
    return ([odo.pack_maps(torch.tensor(d, device="cuda"), cs.MAP_K, 3)
             for d in depths], cs)


def check_variant(r, prev, cur, K, cs):
    """A step at level 0 against the twin; the track against the twins'
    (``p_terms`` and ``n_empty`` are timed only)."""
    if r.name == "p_terms" or r.name.startswith("n_empty"):
        return "not checked (timed only)"
    c, rec, cam, _ = r.levels[-1]
    r.reset()
    twin = odo.icp_step_plain(c, rec, cam, r.state.clone(), 0.5)
    r.step_fn(0)()
    torch.cuda.synchronize()
    err = cs.icp_compare(r.state.clone(), twin, f"{r.name} level 0")
    r.reset()
    r.track()
    tk = r.state.clone()
    tp = odo._track(prev, cur, K, torch.eye(4, device="cuda"), ITERS,
                    plain=True)
    dt, dr = cs.twin_track_compare(tk, tp, f"{r.name} track")
    reruns = "-"
    if r.kind == "n":
        same = 0
        for _ in range(5):
            r.reset()
            r.track()
            same += torch.equal(r.state, tk)
        reruns = f"{same}/5 bit-identical"
        cs.check(same == 5, f"{r.name}: reruns differ")
    return (f"A {err['A']:.2e} b {err['b']:.2e} sum_wr2 {err['sum_wr2']:.2e}"
            f" (sum w equal); track {dt:.2e} m {dr:.2e} deg; reruns {reruns}")


def pack_forms(depth, K):
    """pack_maps over 3 levels with its last step (the maps from the
    vertex, normal and flags) done four ways, by events (median of 10),
    in turns; the parent's two (H, W, 4) maps for reference."""

    def pack(build):
        maps, d = [], depth
        for li in range(3):
            if li:
                d = odo._downsample_depth(d)
            Kl = torch.tensor(odo.level_intrinsics(K, li), device="cuda")
            valid = d > 0
            V = odo._backproject(d, Kl)
            N, ok = odo._normals(V, valid)
            maps.append(build(V, valid[..., None].to(V.dtype), N,
                              (ok & valid)[..., None].to(N.dtype)))
        return maps

    def slices(V, v1, N, o1):
        rec = torch.empty(*V.shape[:2], 8, device="cuda")
        rec[..., :3] = V
        rec[..., 3:4] = v1
        rec[..., 4:7] = N
        rec[..., 7:] = o1
        return torch.cat([V, v1], -1), rec

    def planes(V, v1, N, o1):
        x, y, z = V.unbind(-1)
        v = v1[..., 0]
        return (torch.stack([x, y, z, v], -1),
                torch.stack([x, y, z, v, *N.unbind(-1), o1[..., 0]], -1))

    forms = {
        "parent (cur, nrm)": lambda V, v1, N, o1: (
            torch.cat([V, v1], -1), torch.cat([N, o1], -1)),
        "cat(cur, N, ok)": lambda V, v1, N, o1: (
            (c := torch.cat([V, v1], -1)), torch.cat([c, N, o1], -1)),
        "stack(cur, nrm)": lambda V, v1, N, o1: (
            (c := torch.cat([V, v1], -1)),
            torch.stack([c, torch.cat([N, o1], -1)], -2).reshape(
                *V.shape[:2], 8)),
        "empty + slices": slices,
        "stack of planes": planes,
    }
    ref = pack(forms["cat(cur, N, ok)"])
    for name, build in forms.items():
        if name.startswith("parent"):
            continue
        got = pack(build)
        assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(got, ref)), name
    out = {}
    for name, build in list(forms.items()) + list(reversed(forms.items())):
        out.setdefault(name, []).append(events_ms(lambda: pack(build)))
    for name, t in out.items():
        print(f"pack_maps, 3 levels, {name}: "
              f"{', '.join(f'{x:.4f}' for x in t)} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    card = card_line()
    print(card, flush=True)
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    if only == "pack":
        cs = rig_pyramids()[1]
        depth = torch.tensor(render_plane_depth(
            cs.MAP_K, np.eye(4, dtype=np.float32), cs.MAP_SCENE, cs.H_FULL,
            cs.W_FULL), device="cuda")
        pack_forms(depth, cs.MAP_K)
        return 0
    vs = variants()
    if only:
        vs = {k: v for k, v in vs.items() if k in only.split(",")}
    t0 = time.perf_counter()
    libs = build(vs)
    print(f"built {len(libs)} of {len(vs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    (prev, cur), cs = rig_pyramids()
    K = cs.MAP_K
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runners = {n: Runner(n, vs[n][0], vs[n][2], lib, prev, cur, K)
               for n, lib in libs.items()}
    for n, r in runners.items():
        grid = (f"1024 blocks, {r.per_sm} an SM: "
                f"{1024 / (r.per_sm * sms):.2f} waves on {sms} SMs"
                if r.kind == "p" else f"{r.blocks} blocks")
        print(f"{n}: {grid}; {check_variant(r, prev, cur, K, cs)}",
              flush=True)
    order = list(runners) + list(reversed(runners))
    res = {n: {} for n in runners}
    for n in order:
        r = runners[n]
        row = res[n]
        for li in range(3):
            r.reset()
            fn = r.step_fn(li)
            row.setdefault(f"step{li}_ms", []).append(events_ms(fn))
            r.reset()
            row.setdefault(f"step{li}_b2b", []).append(b2b_ms(fn, 50))
        r.reset()
        row.setdefault("track_ms", []).append(events_ms(r.track))
        r.reset()
        row.setdefault("track_b2b", []).append(b2b_ms(r.track, 20))
        r.reset()
        row.setdefault("host_us", []).append(host_us(r.step_fn(2)))
    n0 = cur[0][0].shape[0] * cur[0][0].shape[1]
    npix = [cur[li][0].shape[0] * cur[li][0].shape[1] for li in range(3)]
    bound0 = cs.ICP_BYTES_PER_PIXEL * n0 / cs.PEAK_BYTES_S * 1e3
    bound_t = cs.ICP_BYTES_PER_PIXEL * sum(
        n * k for n, k in zip(npix, ITERS)) / cs.PEAK_BYTES_S * 1e3
    print(f"[{card}] in turns (first, reversed); bounds: a level-0 step "
          f"{bound0:.4f} ms, a track {bound_t:.4f} ms", flush=True)
    for n, row in res.items():
        print(f"{n}: " + "; ".join(
            f"{k} " + ", ".join(f"{x:.4f}" for x in v) for k, v in row.items()),
            flush=True)
    if "p" in res and "p_terms" in res:
        p, t = res["p"], res["p_terms"]
        print("causes, on the parent (means of the two turns):", flush=True)
        mean = lambda v: sum(v) / len(v)
        for li in range(3):
            step, sums = mean(p[f"step{li}_b2b"]), mean(t[f"step{li}_b2b"])
            bound = cs.ICP_BYTES_PER_PIXEL * npix[li] / cs.PEAK_BYTES_S * 1e3
            print(f"  level {li}: a step {step:.4f} ms back to back, the sums "
                  f"alone {sums:.4f} (the solve launch {step - sums:.4f}); "
                  f"bound {bound:.4f}", flush=True)
        print(f"  the host issues a step's entry call in "
              f"{mean(p['host_us']):.1f} us (two launches)", flush=True)
        for k in ("p_together", "p_record", "p_record_together"):
            if k in res:
                print(f"  {k}: level 0 b2b {mean(res[k]['step0_b2b']):.4f} "
                      f"against the parent's {mean(p['step0_b2b']):.4f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
