// wls_lines — the tridiagonal line solve of the WLS filter, every line of
// one pass in one launch, each line cut into segments solved side by side.
//
// Replaces no Pallas kernel: the reference's solver is two lax.scans
// (i3dr_stereo_tpu/ops/wls.py · _thomas_rows, :32-68), Thomas's algorithm
// along the line. The port solves the same system by a partition method,
// and its plain torch twin (ops/wls.py · thomas_lines_plain) is the same
// algorithm with the same operations in the same order.
//
// The system of a line (data weights a, edge weights w between
// neighbours, data d, all float32; lam rounded to float32 on the host):
//   wl_i = w_{i-1} (0 at i = 0), wr_i = w_i (0 at i = N-1)
//   diag = a + lam * (wl + wr) + 1e-8, lower = -lam * wl,
//   upper = -lam * wr, rhs = a * d
//   lower_i u_{i-1} + diag_i u_i + upper_i u_{i+1} = rhs_i
//
// The partition. S = ceil(N / 32); segment k holds [k S, min(k S + S, N)),
// its last element b_k is an interface, the others its interior; the
// interior of k lies between X_{k-1} = u(b_{k-1}) (0 for k = 0) and
// X_k = u(b_k). A thread a segment:
//  1. eliminates its interior from the left: (c, P, Q) from (0, 0, 1), a
//     step r = 1 / (diag - lower c), c = upper r, P = (rhs - lower P) r,
//     Q = (-lower Q) r, so that u_i = P_i - c_i u_{i+1} +
//     Q_i X_{k-1}; then, walking back over the stored (P, c, Q) from
//     (alpha, beta, gamma) = (0, 0, 1), alpha = P - c alpha, beta = Q -
//     c beta, gamma = -(c gamma): its first element is alpha + beta
//     X_{k-1} + gamma X_k.
//  2. The interface rows: the equation at b_k with u(b_k - 1) from the
//     elimination of k (its last c, P, Q) and u(b_k + 1) from step 1's
//     alpha, beta, gamma of k + 1 ((0, 0, 0) past the last segment):
//        A = lower Q, D = (diag - lower c) + upper beta',
//        C = upper gamma', R = (rhs - lower P) - upper alpha',
//     a tridiagonal system of <= 32 unknowns a line, solved by Thomas's
//     algorithm (a step r = 1 / (D - A c), c = C r, x = (R - A x) r).
//  3. Back substitution of the interior: u_i = (P_i - c_i u_{i+1}) +
//     Q_i X_{k-1}, walking down from u(b_k) = X_k.
// A line of N <= 32 has no interior: step 2 is Thomas's algorithm on the
// line itself. Every pivot that is exactly 0 takes 1e-8, the diagonal's
// own regularisation, which float32 loses next to lam * w: on a line whose
// data weights are zero to its end (a column of holes) the reference
// divides 0 by 0, and the NaN spreads over the image in the next pass.
// Every op is __fmul_rn / __fadd_rn / __fsub_rn / __frcp_rn (no FMA), the
// twin's; a reciprocal of each pivot and products in place of divisions.
//
// Why: the reference's chain is N dependent steps of two divisions; one
// line of 2448 alone takes 0.437 ms on an NVIDIA H100 80GB HBM3 at 700 W,
// and 2048-2448 lines a pass are too few to hide it (a whole horizontal
// pass took 0.494 ms back to back with a thread a line). Here a line's
// chain is S elimination steps, S multiply-subtracts back, <= 2 x 32
// steps of the interface rows and S of the back substitution.
//
// Layout: a block holds LB lines x 32 segments (thread = segment * LB +
// line). Its lines come into shared memory by cp.async in one go, 16
// bytes a copy where the rows allow it: a line a row in the horizontal
// pass (its elements are adjacent), a position a row of the LB lines in
// the vertical one (LB neighbouring columns); S is odd and the rows'
// stride chosen so that the segments of a warp's lines fall on 32
// different banks. The elimination writes P, c and Q over the inputs,
// the back substitution u over P, and u leaves as it came in. LB (8, 4,
// 2 or 1) is the one that keeps the most lines on an SM at once.
//   kernel_probes/probe8.py at commit 1dd326f timed it and the forms below
// (in its src/) on both passes of the WLS fill's first round at 2448x2048,
// and read clock64 at each barrier for its phases (PERF.md has the
// figures). Slower or no better: the elimination from both ends with c and
// Q in a global scratch buffer and each thread's loads 8 steps ahead in
// registers (src/wls_lines_twosided.cu: 175 registers); three divisions a
// step in place of the reciprocal; 64 segments a line (another rounding).
//   What bounds it on the card: a, w, d read and u written once, 16 bytes
// an element (0.080 GB a pass at 2448x2048, 0.024 ms at 3.35 TB/s).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int PARTS = 32;   // segments a line

struct Layout {        // element (line j of batch b, position i):
  long long plane;     //   b * plane + j * line + i * step
  long long line;
  long long step;
};

struct Row {           // element i: the four coefficients of its equation
  float diag, lower, upper, rhs;
};

// element i's row from a_i, d_i, w_{i-1} (0 at 0) and w_i (0 at N - 1)
__device__ __forceinline__ void row(float ai, float di, float wl, float wr,
                                    float lam, float nlam, Row& r) {
  r.diag = __fadd_rn(__fadd_rn(ai, __fmul_rn(lam, __fadd_rn(wl, wr))),
                     1e-8f);
  r.lower = __fmul_rn(nlam, wl);
  r.upper = __fmul_rn(nlam, wr);
  r.rhs = __fmul_rn(ai, di);
}

__device__ __forceinline__ float pivot(float den) {
  return den == 0.f ? 1e-8f : den;   // the zero-pivot repair
}

template <int LB>
__global__ void __launch_bounds__(LB* PARTS)
    wls_lines_kernel(const float* __restrict__ a, const float* __restrict__ w,
                     const float* __restrict__ d, float* __restrict__ u, int B,
                     int L, int N, int S, int K, int LP, int AS, Layout lo,
                     Layout wlo, float lam, bool wide) {
  constexpr int T = LB * PARTS;
  extern __shared__ __align__(16) float smem[];
  // element i of the block's line j at j * js + i * is: a line a row of LP
  // where a line's elements are adjacent in memory (the horizontal pass),
  // else a position a row of the LB lines (the vertical one)
  const bool along = lo.step == 1;
  const int js = along ? LP : 1, is = along ? 1 : LB;
  float* sa = smem;                           // [AS]: a, then P, then u
  float* sd = sa + AS;                        // [AS]: d, then c
  float* sw = sd + AS;                        // [AS]: w_i, then Q
  float* ends = sw + AS;                      // [3][PARTS][LB]: al be ga
  float* rows = ends + 3 * PARTS * LB;        // [4][PARTS][LB]: A D C R
  float* xs = rows + 4 * PARTS * LB;          // [PARTS][LB]: X_k
  const int j = threadIdx.x % LB, k = threadIdx.x / LB;
  const int first = (int)blockIdx.x * LB;     // the block's first line
  const int lines = min(LB, B * L - first);
  const bool live = j < lines && k < K;
  const float nlam = -lam;
  auto base = [&](int jl, const Layout& l) {
    const int t = first + jl, b = t / L;
    return b * l.plane + (t - b * L) * l.line;
  };
  // the vertical pass in 16-byte pieces: LB neighbouring columns of one
  // plane, the first on a 16-byte boundary
  const bool across16 = !along && wide && LB % 4 == 0 && lines == LB &&
                        first / L == (first + LB - 1) / L && first % L % 4 == 0;

  // the block's lines in by cp.async, 16 bytes a copy where the rows allow
  // it: a line at a time along it (horizontal), or a position at a time
  // across the LB lines (vertical: neighbouring columns of one plane)
  if (along) {
    for (int jl = 0; jl < lines; ++jl) {
      const long long g = base(jl, lo), gw = base(jl, wlo);
      float* ra = sa + jl * LP;
      float* rd = sd + jl * LP;
      float* rw = sw + jl * LP;
      if (wide) {
        for (int i = 4 * threadIdx.x; i < N; i += 4 * T) {
          __pipeline_memcpy_async(ra + i, a + g + i, 16);
          __pipeline_memcpy_async(rd + i, d + g + i, 16);
        }
      } else {
        for (int i = threadIdx.x; i < N; i += T) {
          __pipeline_memcpy_async(ra + i, a + g + i, 4);
          __pipeline_memcpy_async(rd + i, d + g + i, 4);
        }
      }
      for (int i = threadIdx.x; i < N - 1; i += T)
        __pipeline_memcpy_async(rw + i, w + gw + i, 4);
      if (threadIdx.x == 0) rw[N - 1] = 0.f;
    }
  } else if (across16) {
    const long long g = base(0, lo), gw = base(0, wlo);
    constexpr int Q4 = LB >= 4 ? LB / 4 : 1;   // 16-byte pieces a position
    for (int e = threadIdx.x; e < N * Q4; e += T) {
      const int i = e / Q4, q = 4 * (e % Q4);
      __pipeline_memcpy_async(sa + i * LB + q, a + g + i * lo.step + q, 16);
      __pipeline_memcpy_async(sd + i * LB + q, d + g + i * lo.step + q, 16);
      if (i < N - 1)
        __pipeline_memcpy_async(sw + i * LB + q, w + gw + i * wlo.step + q,
                                16);
    }
    if (threadIdx.x < LB) sw[(N - 1) * LB + threadIdx.x] = 0.f;
  } else if (j < lines) {
    const long long g = base(j, lo), gw = base(j, wlo);
    for (int i = k; i < N; i += PARTS) {
      __pipeline_memcpy_async(sa + i * LB + j, a + g + i * lo.step, 4);
      __pipeline_memcpy_async(sd + i * LB + j, d + g + i * lo.step, 4);
      if (i < N - 1)
        __pipeline_memcpy_async(sw + i * LB + j, w + gw + i * wlo.step, 4);
      else
        sw[i * LB + j] = 0.f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 1. the interior eliminated from the left (P, c, Q in place of a, d,
  // w), then its first element in terms of X_{k-1} and X_k by
  // substituting back over them
  const int s = k * S;
  const int m = live ? min(S, N - s) - 1 : 0;   // interior length
  float* ra = sa + j * js + s * is;
  float* rd = sd + j * js + s * is;
  float* rw = sw + j * js + s * is;
  float wl = live && k > 0 ? rw[-is] : 0.f;      // w_{s-1}
  float c = 0.f, P = 0.f, Q = 1.f;
#pragma unroll 4
  for (int i = 0; i < m; ++i) {
    const float wr = rw[i * is];
    Row r;
    row(ra[i * is], rd[i * is], wl, wr, lam, nlam, r);
    const float inv =
        __frcp_rn(pivot(__fsub_rn(r.diag, __fmul_rn(r.lower, c))));
    c = __fmul_rn(r.upper, inv);
    P = __fmul_rn(__fsub_rn(r.rhs, __fmul_rn(r.lower, P)), inv);
    Q = __fmul_rn(__fmul_rn(-r.lower, Q), inv);
    ra[i * is] = P;
    rd[i * is] = c;
    rw[i * is] = Q;
    wl = wr;
  }
  float al = 0.f, be = 0.f, ga = 1.f;
#pragma unroll 4
  for (int i = m - 1; i >= 0; --i) {
    const float ci = rd[i * is];
    al = __fsub_rn(ra[i * is], __fmul_rn(ci, al));
    be = __fsub_rn(rw[i * is], __fmul_rn(ci, be));
    ga = -__fmul_rn(ci, ga);
  }
  if (live) {
    ends[(0 * PARTS + k) * LB + j] = al;
    ends[(1 * PARTS + k) * LB + j] = be;
    ends[(2 * PARTS + k) * LB + j] = ga;
  }
  __syncthreads();

  // 2. the interface rows, then Thomas's algorithm on them
  if (live) {
    Row e;
    row(ra[m * is], rd[m * is], wl, rw[m * is], lam, nlam, e);
    float an = 0.f, bn = 0.f, gn = 0.f;   // 0 past the last segment
    if (k + 1 < K) {
      an = ends[(0 * PARTS + k + 1) * LB + j];
      bn = ends[(1 * PARTS + k + 1) * LB + j];
      gn = ends[(2 * PARTS + k + 1) * LB + j];
    }
    rows[(0 * PARTS + k) * LB + j] = __fmul_rn(e.lower, Q);
    rows[(1 * PARTS + k) * LB + j] = __fadd_rn(
        __fsub_rn(e.diag, __fmul_rn(e.lower, c)), __fmul_rn(e.upper, bn));
    rows[(2 * PARTS + k) * LB + j] = __fmul_rn(e.upper, gn);
    rows[(3 * PARTS + k) * LB + j] = __fsub_rn(
        __fsub_rn(e.rhs, __fmul_rn(e.lower, P)), __fmul_rn(e.upper, an));
  }
  __syncthreads();
  if (live && k == 0) {
    float cr = 0.f, dr = 0.f;
#pragma unroll 4
    for (int q = 0; q < K; ++q) {
      const float A = rows[(0 * PARTS + q) * LB + j];
      const float D = rows[(1 * PARTS + q) * LB + j];
      const float C = rows[(2 * PARTS + q) * LB + j];
      const float R = rows[(3 * PARTS + q) * LB + j];
      const float inv = __frcp_rn(pivot(__fsub_rn(D, __fmul_rn(A, cr))));
      cr = __fmul_rn(C, inv);
      dr = __fmul_rn(__fsub_rn(R, __fmul_rn(A, dr)), inv);
      rows[(2 * PARTS + q) * LB + j] = cr;
      rows[(3 * PARTS + q) * LB + j] = dr;
    }
    float x = dr;
    xs[(K - 1) * LB + j] = x;
#pragma unroll 4
    for (int q = K - 2; q >= 0; --q) {
      x = __fsub_rn(rows[(3 * PARTS + q) * LB + j],
                    __fmul_rn(rows[(2 * PARTS + q) * LB + j], x));
      xs[q * LB + j] = x;
    }
  }
  __syncthreads();

  // 3. back substitution of the interior, u in place of P
  if (live) {
    const float xl = k > 0 ? xs[(k - 1) * LB + j] : 0.f;
    float x = xs[k * LB + j];
    ra[m * is] = x;
#pragma unroll 4
    for (int i = m - 1; i >= 0; --i) {
      x = __fadd_rn(__fsub_rn(ra[i * is], __fmul_rn(rd[i * is], x)),
                    __fmul_rn(rw[i * is], xl));
      ra[i * is] = x;
    }
  }
  __syncthreads();

  // the block's lines out, as they came in
  if (along) {
    for (int jl = 0; jl < lines; ++jl) {
      float* out = u + base(jl, lo);
      const float* ru = sa + jl * LP;
      if (wide) {
        for (int i = 4 * threadIdx.x; i < N; i += 4 * T)
          *reinterpret_cast<float4*>(out + i) =
              *reinterpret_cast<const float4*>(ru + i);
      } else {
        for (int i = threadIdx.x; i < N; i += T) out[i] = ru[i];
      }
    }
  } else if (across16) {
    float* out = u + base(0, lo);
    constexpr int Q4 = LB >= 4 ? LB / 4 : 1;
    for (int e = threadIdx.x; e < N * Q4; e += T) {
      const int i = e / Q4, q = 4 * (e % Q4);
      *reinterpret_cast<float4*>(out + i * lo.step + q) =
          *reinterpret_cast<const float4*>(sa + i * LB + q);
    }
  } else if (j < lines) {
    float* out = u + base(j, lo);
    for (int i = k; i < N; i += PARTS) out[i * lo.step] = sa[i * LB + j];
  }
}

// the partition of a line of N and its shared memory for LB lines
struct Plan {
  int S, K;
  int LP(int LB) const {   // a line's row: >= N, and the segments of the
                           // lines of a warp on 32 different banks
    const int want = (PARTS / LB) * S % 32;
    return K * S + ((want - K * S) % 32 + 32) % 32;
  }
  int AS(int LB, bool along) const {   // one array's floats
    return along ? LB * LP(LB) : LB * K * S;
  }
  size_t bytes(int LB, bool along) const {
    return sizeof(float) * ((size_t)3 * AS(LB, along) + 8 * PARTS * LB);
  }
};

Plan plan(int N) {
  Plan p;
  p.S = (N + PARTS - 1) / PARTS | 1;   // odd: a row's segments on
                                       // different banks
  p.K = (N + p.S - 1) / p.S;
  return p;
}

constexpr size_t SMEM_SM = 228 * 1024, SMEM_BLOCK = 227 * 1024;

// lines resident on an SM with LB lines a block (0: a block does not fit)
int lines_per_sm(const Plan& p, int LB, bool along) {
  const size_t bytes = p.bytes(LB, along);
  if (bytes > SMEM_BLOCK) return 0;
  const size_t by_threads = 2048 / (LB * PARTS),
               by_smem = SMEM_SM / (bytes + 1024);   // + the runtime's
                                                      // reserve a block
  return LB * (int)(by_threads < by_smem ? by_threads : by_smem);
}

template <int LB>
int launch(const float* a, const float* w, const float* d, float* u, int B,
           int L, int N, const Plan& p, Layout lo, Layout wlo, float lam,
           cudaStream_t stream) {
  const bool along = lo.step == 1;
  // rows of a, d and u in 16-byte pieces where they allow it
  auto at16 = [](const void* q) { return (uintptr_t)q % 16 == 0; };
  const bool wide =
      at16(a) && at16(d) && at16(u) && lo.plane % 4 == 0 &&
      (along ? N % 4 == 0 && lo.line % 4 == 0
             : lo.step % 4 == 0 && at16(w) && wlo.plane % 4 == 0 &&
                   wlo.step % 4 == 0);
  const size_t bytes = p.bytes(LB, along);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wls_lines_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long lines = (long long)B * L;
  const unsigned blocks = (unsigned)((lines + LB - 1) / LB);
  wls_lines_kernel<LB><<<blocks, LB * PARTS, bytes, stream>>>(
      a, w, d, u, B, L, N, p.S, p.K, p.LP(LB), p.AS(LB, along), lo, wlo, lam,
      wide);
  return (int)cudaGetLastError();
}

}  // namespace

// a, d, u share layout lo (B x L lines of N elements); w has N - 1 elements
// a line, layout wlo. u may not alias a, w or d. A line holds at most
// ~19k elements (its three rows in shared memory).
extern "C" int i3dr_wls_lines(const void* a, const void* w, const void* d,
                              void* u, int B, int L, int N, long long plane,
                              long long line, long long step,
                              long long wplane, long long wline,
                              long long wstep, float lam, void* stream) {
  const long long lines = (long long)B * L;
  if (lines * N == 0) return 0;
  if (lines > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Layout lo{plane, line, step}, wlo{wplane, wline, wstep};
  auto* A = (const float*)a;
  auto* W = (const float*)w;
  auto* D = (const float*)d;
  auto* U = (float*)u;
  auto* st = (cudaStream_t)stream;
  const Plan p = plan(N);
  // the most lines an SM holds at once; the wider block where two tie
  // (neighbouring columns share a sector in the vertical pass)
  int best = 0, LB = 0;
  for (int lb : {8, 4, 2, 1}) {
    const int n = lines_per_sm(p, lb, step == 1);
    if (n > best) best = n, LB = lb;
  }
  switch (LB) {
    case 8: return launch<8>(A, W, D, U, B, L, N, p, lo, wlo, lam, st);
    case 4: return launch<4>(A, W, D, U, B, L, N, p, lo, wlo, lam, st);
    case 2: return launch<2>(A, W, D, U, B, L, N, p, lo, wlo, lam, st);
    case 1: return launch<1>(A, W, D, U, B, L, N, p, lo, wlo, lam, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
