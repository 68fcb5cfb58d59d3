// wls_lines — the tridiagonal line solve of the WLS filter, every line of
// one pass in one launch.
//
// Replaces no Pallas kernel: the reference's solver is two lax.scans
// (i3dr_stereo_tpu/ops/wls.py · _thomas_rows, :32-68), which the plain
// torch twin (ops/wls.py · thomas_lines_plain) runs as a Python loop over
// the line, ~8 launches a step.
//
// What it computes, for each line (data weights a, edge weights w between
// neighbours, data d, all float32; lam rounded to float32 on the host):
//   wl_i = w_{i-1} (0 at i = 0), wr_i = w_i (0 at i = N-1)
//   diag = a + lam * (wl + wr) + 1e-8, lower = -lam * wl,
//   upper = -lam * wr, rhs = a * d
//   forward:  denom = diag - lower * cp', cp = upper / denom,
//             dp = (rhs - lower * dp') / denom      (cp' = dp' = 0 at i = 0)
//   back:     u = dp - cp * u'                      (u' = 0 at i = N-1)
// with the twin's op order, __fmul_rn / __fadd_rn / __fsub_rn (no FMA)
// and IEEE division. A zero pivot takes 1e-8, the diagonal's own
// regularisation, which float32 loses next to lam * w: on a line whose
// data weights are zero to its end (a column of holes) the reference
// divides 0 by 0, and the NaN spreads over the image in the next pass.
//
// Design: a thread a line, one launch a pass. The forward sweep keeps cp
// in a scratch plane and dp in the output; the back sweep overwrites the
// output in place. Each sweep loads the next 16 steps' inputs before it
// runs the current 16: the loads do not depend on the chain, and issued
// a step at a time (the first form, kernel_probes/src/wls_lines_first.cu)
// every step waited on device memory. kernel_probes/probe7.py, 20 calls
// back to back at 2448x2048 (NVIDIA H100 80GB HBM3, 700 W): horizontal
// 1.652 (first form) -> 0.826 / 0.567 / 0.492 ms with chunks of 4 / 8 /
// 16, vertical 1.952 -> 0.866 / 0.689 / 0.656 ms; unrolling the first
// form by 4 or 8, or 64 threads a block, gained nothing. 126 registers,
// no spills. The kernel takes the element stride and the line
// stride, so the vertical pass walks columns of the (B, H, W) planes with
// no transposed copy (a thread a column: neighbouring threads read
// neighbouring addresses). The horizontal pass (a thread a row, stride 1)
// is not coalesced: each lane walks its own cache lines, which stay in L1
// for the next 31 steps.
//
// What bounds it on the card: a, w, d read and u written once, 16 bytes an
// element (0.080 GB a pass at 2448x2048, 0.024 ms at 3.35 TB/s), or the
// chain: N dependent steps of two divisions each, with 2048-2448 lines,
// well under a warp an SM, to hide them: one line of 2448 alone takes
// 0.43 ms.
#include "common.cuh"

namespace {

constexpr int THREADS = 32;  // a warp a block: the lines spread over the most SMs
constexpr int CHUNK = 16;    // steps whose loads are issued together

struct Layout {        // element (line j of batch b, position i):
  long long plane;     //   b * plane + j * line + i * step
  long long line;
  long long step;
};

__global__ void __launch_bounds__(THREADS)
    wls_lines_kernel(const float* __restrict__ a, const float* __restrict__ w,
                     const float* __restrict__ d, float* __restrict__ u,
                     float* __restrict__ cp_buf, int B, int L, int N,
                     Layout lo, Layout wlo, float lam) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= B * L) return;
  const int b = t / L, j = t - b * L;
  const long long base = b * lo.plane + j * lo.line;
  const long long wbase = b * wlo.plane + j * wlo.line;
  const float nlam = -lam;

  // forward: the next chunk's a, w, d are loaded before this chunk's
  // steps run, so their latency hides behind the chain
  float ca[CHUNK], cw[CHUNK], cd[CHUNK], na[CHUNK], nw[CHUNK], nd[CHUNK];
  auto load = [&](int i0, float* ra, float* rw, float* rd) {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int i = i0 + k;
      const long long e = base + i * lo.step;
      ra[k] = i < N ? __ldg(a + e) : 0.f;
      rd[k] = i < N ? __ldg(d + e) : 0.f;
      rw[k] = i < N - 1 ? __ldg(w + wbase + i * wlo.step) : 0.f;
    }
  };
  load(0, ca, cw, cd);
  float cp = 0.f, dp = 0.f, wl = 0.f;
  for (int i0 = 0; i0 < N; i0 += CHUNK) {
    load(i0 + CHUNK, na, nw, nd);
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int i = i0 + k;
      if (i >= N) break;
      const float wr = cw[k], ai = ca[k];
      const float diag =
          __fadd_rn(__fadd_rn(ai, __fmul_rn(lam, __fadd_rn(wl, wr))), 1e-8f);
      const float lower = __fmul_rn(nlam, wl);
      const float upper = __fmul_rn(nlam, wr);
      const float rhs = __fmul_rn(ai, cd[k]);
      float denom = __fsub_rn(diag, __fmul_rn(lower, cp));
      if (denom == 0.f) denom = 1e-8f;  // the twin's zero-pivot repair
      cp = __fdiv_rn(upper, denom);
      dp = __fdiv_rn(__fsub_rn(rhs, __fmul_rn(lower, dp)), denom);
      const long long e = base + i * lo.step;
      cp_buf[e] = cp;
      u[e] = dp;
      wl = wr;
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      ca[k] = na[k];
      cw[k] = nw[k];
      cd[k] = nd[k];
    }
  }
  // back: the same, a chunk of (cp, dp) ahead, walking down from N - 1
  float ccp[CHUNK], cdp[CHUNK], ncp[CHUNK], ndp[CHUNK];
  auto load_back = [&](int i0, float* rc, float* rd) {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int i = i0 - k;
      const long long e = base + i * lo.step;
      rc[k] = i >= 0 ? cp_buf[e] : 0.f;
      rd[k] = i >= 0 ? u[e] : 0.f;
    }
  };
  load_back(N - 1, ccp, cdp);
  float un = 0.f;
  for (int i0 = N - 1; i0 >= 0; i0 -= CHUNK) {
    load_back(i0 - CHUNK, ncp, ndp);
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int i = i0 - k;
      if (i < 0) break;
      un = __fsub_rn(cdp[k], __fmul_rn(ccp[k], un));
      u[base + i * lo.step] = un;
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      ccp[k] = ncp[k];
      cdp[k] = ndp[k];
    }
  }
}

}  // namespace

// a, d, u, cp_buf share layout lo (B x L lines of N elements); w has N - 1
// elements a line, layout wlo. u may not alias a, w or d.
extern "C" int i3dr_wls_lines(const void* a, const void* w, const void* d,
                              void* u, void* cp_buf, int B, int L, int N,
                              long long plane, long long line,
                              long long step, long long wplane,
                              long long wline, long long wstep, float lam,
                              void* stream) {
  const long long lines = (long long)B * L;
  if (lines * N == 0) return 0;
  if (lines > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((lines + THREADS - 1) / THREADS);
  wls_lines_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)w, (const float*)d, (float*)u,
      (float*)cp_buf, B, L, N, Layout{plane, line, step},
      Layout{wplane, wline, wstep}, lam);
  return (int)cudaGetLastError();
}
