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
// output in place. The kernel takes the element stride and the line
// stride, so the vertical pass walks columns of the (B, H, W) planes with
// no transposed copy (a thread a column: neighbouring threads read
// neighbouring addresses). The horizontal pass (a thread a row, stride 1)
// is not coalesced: each lane walks its own cache lines, which stay in L1
// for the next 31 steps.
//
// What bounds it on the card: a, w, d read and u written once, 16 bytes an
// element (0.080 GB a pass at 2448x2048, 0.024 ms at 3.35 TB/s), or the
// chain: N dependent steps of two divisions each, with 2048-2448 lines,
// well under a warp an SM, to hide them.
#include "common.cuh"

namespace {

constexpr int THREADS = 32;  // a warp a block: the lines spread over the most SMs

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

  float cp = 0.f, dp = 0.f, wl = 0.f;
  for (int i = 0; i < N; ++i) {
    const long long e = base + i * lo.step;
    const float wr = i < N - 1 ? __ldg(w + wbase + i * wlo.step) : 0.f;
    const float ai = __ldg(a + e);
    const float diag =
        __fadd_rn(__fadd_rn(ai, __fmul_rn(lam, __fadd_rn(wl, wr))), 1e-8f);
    const float lower = __fmul_rn(nlam, wl);
    const float upper = __fmul_rn(nlam, wr);
    const float rhs = __fmul_rn(ai, __ldg(d + e));
    float denom = __fsub_rn(diag, __fmul_rn(lower, cp));
    if (denom == 0.f) denom = 1e-8f;  // the twin's zero-pivot repair
    cp = __fdiv_rn(upper, denom);
    dp = __fdiv_rn(__fsub_rn(rhs, __fmul_rn(lower, dp)), denom);
    cp_buf[e] = cp;
    u[e] = dp;
    wl = wr;
  }
  float un = 0.f;
  for (int i = N - 1; i >= 0; --i) {
    const long long e = base + i * lo.step;
    un = __fsub_rn(u[e], __fmul_rn(cp_buf[e], un));
    u[e] = un;
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
