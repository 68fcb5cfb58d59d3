// wls_lines, the first partitioned form (kernel_probes/probe8.py): each
// segment eliminated from both ends at once, c and Q of every interior
// element in a global scratch buffer, the loads of the next 8 steps
// issued ahead in registers. Its C entry takes the scratch buffer (2 *
// ceil(B * L / 4) * 4 * N floats) after u. It rounds as csrc/wls_lines.cu
// did when it was written (two-sided elimination, three divisions a
// step), not as the twin does now: the probe times it, it does not hold
// it to the twin.
//
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
//  1. eliminates its interior from both ends at once. From the left
//     (c, P, Q from (0, 0, 1); a step den = diag - lower c, c = upper /
//     den, P = (rhs - lower P) / den, Q = (-lower Q) / den) it gets
//     u_i = P_i - c_i u_{i+1} + Q_i X_{k-1}; from the right (the same with
//     lower and upper exchanged) the first interior element in terms of
//     X_{k-1} and X_k. Its P_i go to shared memory, c_i and Q_i to a
//     scratch buffer.
//  2. The interface rows: the equation at b_k with u(b_k - 1) from the
//     left elimination of k and u(b_k + 1) from the right one of k + 1,
//        A = lower Qf, D = (diag - lower cf) - upper cb',
//        C = upper Qb', R = (rhs - lower Pf) - upper Pb'
//     ((cb', Pb', Qb') = (0, 0, 0) past the last segment), a tridiagonal
//     system of <= 32 unknowns a line, solved by Thomas's algorithm.
//  3. Back substitution of the interior: u_i = (P_i - c_i u_{i+1}) +
//     Q_i X_{k-1}, walking down from u(b_k) = X_k.
// A line of N <= 32 has no interior: step 2 is Thomas's algorithm on the
// line itself. Every pivot that is exactly 0 takes 1e-8, the diagonal's
// own regularisation, which float32 loses next to lam * w: on a line whose
// data weights are zero to its end (a column of holes) the reference
// divides 0 by 0, and the NaN spreads over the image in the next pass.
// Every op is __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (no FMA), the
// twin's.
//
// Why: the reference's chain is N dependent steps of two divisions; one
// line of 2448 alone takes 0.437 ms on an NVIDIA H100 80GB HBM3 at 700 W,
// and 2048-2448 lines a pass are too few to hide it (a whole horizontal
// pass took 0.494 ms back to back with a thread a line). Here the chain
// is ~S steps of the two eliminations side by side, <= 2 x 32 steps of
// the interface rows and S steps of the back substitution: ~300 at
// N = 2448, with 32 threads a line.
//
// Layout: a block holds LB lines x 32 segments (thread = segment * LB +
// line), so the lanes of a warp read LB neighbouring lines: neighbouring
// addresses in the vertical pass (lines are columns), a stream each
// through L1 in the horizontal one. The block's u (and P before it) sit in
// shared memory, a line a padded row, and leave in one coalesced store.
// What bounds it on the card: a, w, d read and u written once, 16 bytes an
// element (0.080 GB a pass at 2448x2048, 0.024 ms at 3.35 TB/s); c and Q
// go through the scratch buffer (8 more bytes an element each way, mostly
// in L2).
#include "common.cuh"

namespace {

constexpr int PARTS = 32;   // segments a line
constexpr int CHUNK = 8;    // steps whose loads are issued together

struct Layout {        // element (line j of batch b, position i):
  long long plane;     //   b * plane + j * line + i * step
  long long line;
  long long step;
};

struct Row {           // element i: the four coefficients of its equation
  float diag, lower, upper, rhs;
};

// the inputs of element i of a line: a_i, d_i, w_{i-1} (0 at 0), w_i (0 at
// N - 1)
struct In {
  float a, d, wl, wr;
};

__device__ __forceinline__ In load(const float* __restrict__ a,
                                   const float* __restrict__ w,
                                   const float* __restrict__ d,
                                   long long base, long long wbase,
                                   const Layout& lo, const Layout& wlo, int N,
                                   int i) {
  In x;
  const long long e = base + i * lo.step;
  x.a = __ldg(a + e);
  x.d = __ldg(d + e);
  x.wl = i > 0 ? __ldg(w + wbase + (i - 1) * wlo.step) : 0.f;
  x.wr = i < N - 1 ? __ldg(w + wbase + i * wlo.step) : 0.f;
  return x;
}

__device__ __forceinline__ Row row(const In& x, float lam, float nlam) {
  Row r;
  r.diag = __fadd_rn(__fadd_rn(x.a, __fmul_rn(lam, __fadd_rn(x.wl, x.wr))),
                     1e-8f);
  r.lower = __fmul_rn(nlam, x.wl);
  r.upper = __fmul_rn(nlam, x.wr);
  r.rhs = __fmul_rn(x.a, x.d);
  return r;
}

__device__ __forceinline__ float pivot(float den) {
  return den == 0.f ? 1e-8f : den;   // the zero-pivot repair
}

// one elimination step: (c, P, Q) of the element before it (on the side
// it comes from), `near` its coefficient towards that side, `far` the
// other one
__device__ __forceinline__ void eliminate(const Row& r, float near, float far,
                                          float& c, float& P, float& Q) {
  const float den = pivot(__fsub_rn(r.diag, __fmul_rn(near, c)));
  c = __fdiv_rn(far, den);
  P = __fdiv_rn(__fsub_rn(r.rhs, __fmul_rn(near, P)), den);
  Q = __fdiv_rn(__fmul_rn(-near, Q), den);
}

template <int LB>
__global__ void __launch_bounds__(LB* PARTS)
    wls_lines_kernel(const float* __restrict__ a, const float* __restrict__ w,
                     const float* __restrict__ d, float* __restrict__ u,
                     float* __restrict__ scratch, int B, int L, int N, int S,
                     int K, Layout lo, Layout wlo, float lam) {
  extern __shared__ __align__(16) float smem[];
  const int NP = N + 1;                       // a line's padded row
  float* us = smem;                           // [LB][NP]: P, then u
  float* ends = us + LB * NP;                 // [3][PARTS][LB]: right ends
  float* rows = ends + 3 * PARTS * LB;        // [4][PARTS][LB]: A D C R
  float* xs = rows + 4 * PARTS * LB;          // [PARTS][LB]: X_k
  const int j = threadIdx.x % LB, k = threadIdx.x / LB;
  const int first = (int)blockIdx.x * LB;     // the block's first line
  const int t = first + j;                    // this thread's line
  const bool live = t < B * L && k < K;
  const int b = t / L, jj = t - b * L;
  const long long base = b * lo.plane + jj * lo.line;
  const long long wbase = b * wlo.plane + jj * wlo.line;
  const float nlam = -lam;
  const int s = k * S;
  const int m = live ? min(S, N - s) - 1 : 0;  // interior length
  const int bk = s + m;                        // the interface
  float* cs = scratch + (size_t)blockIdx.x * LB * N;   // [N][LB]: c
  float* qs = cs + (size_t)gridDim.x * LB * N;         // [N][LB]: Q
  float* ur = us + j * NP;

  // 1. both eliminations of the interior, a chunk of steps' loads ahead
  float cf = 0.f, Pf = 0.f, Qf = 1.f, cb = 0.f, Pb = 0.f, Qb = 1.f;
  In fw[CHUNK], bw[CHUNK], nf[CHUNK], nb[CHUNK];
  auto fetch = [&](int i0, In* f, In* g) {
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      if (i0 + q < m) {
        f[q] = load(a, w, d, base, wbase, lo, wlo, N, s + i0 + q);
        g[q] = load(a, w, d, base, wbase, lo, wlo, N, bk - 1 - i0 - q);
      }
    }
  };
  fetch(0, fw, bw);
  for (int i0 = 0; i0 < m; i0 += CHUNK) {
    fetch(i0 + CHUNK, nf, nb);
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      const int i = i0 + q;
      if (i >= m) break;
      const Row rf = row(fw[q], lam, nlam);
      eliminate(rf, rf.lower, rf.upper, cf, Pf, Qf);
      ur[s + i] = Pf;
      cs[(size_t)(s + i) * LB + j] = cf;
      qs[(size_t)(s + i) * LB + j] = Qf;
      const Row rb = row(bw[q], lam, nlam);
      eliminate(rb, rb.upper, rb.lower, cb, Pb, Qb);
    }
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      fw[q] = nf[q];
      bw[q] = nb[q];
    }
  }
  if (live) {
    ends[(0 * PARTS + k) * LB + j] = cb;
    ends[(1 * PARTS + k) * LB + j] = Pb;
    ends[(2 * PARTS + k) * LB + j] = Qb;
  }
  __syncthreads();

  // 2. the interface rows, then Thomas's algorithm on them
  if (live) {
    const Row e = row(load(a, w, d, base, wbase, lo, wlo, N, bk), lam, nlam);
    float cn = 0.f, Pn = 0.f, Qn = 0.f;
    if (k + 1 < K) {
      cn = ends[(0 * PARTS + k + 1) * LB + j];
      Pn = ends[(1 * PARTS + k + 1) * LB + j];
      Qn = ends[(2 * PARTS + k + 1) * LB + j];
    }
    rows[(0 * PARTS + k) * LB + j] = __fmul_rn(e.lower, Qf);
    rows[(1 * PARTS + k) * LB + j] =
        __fsub_rn(__fsub_rn(e.diag, __fmul_rn(e.lower, cf)),
                  __fmul_rn(e.upper, cn));
    rows[(2 * PARTS + k) * LB + j] = __fmul_rn(e.upper, Qn);
    rows[(3 * PARTS + k) * LB + j] =
        __fsub_rn(__fsub_rn(e.rhs, __fmul_rn(e.lower, Pf)),
                  __fmul_rn(e.upper, Pn));
  }
  __syncthreads();
  if (live && k == 0) {
    float cr = 0.f, dr = 0.f;
    for (int q = 0; q < K; ++q) {
      const float A = rows[(0 * PARTS + q) * LB + j];
      const float den = pivot(__fsub_rn(rows[(1 * PARTS + q) * LB + j],
                                        __fmul_rn(A, cr)));
      cr = __fdiv_rn(rows[(2 * PARTS + q) * LB + j], den);
      dr = __fdiv_rn(__fsub_rn(rows[(3 * PARTS + q) * LB + j],
                               __fmul_rn(A, dr)), den);
      rows[(2 * PARTS + q) * LB + j] = cr;
      rows[(3 * PARTS + q) * LB + j] = dr;
    }
    float x = dr;
    xs[(K - 1) * LB + j] = x;
    for (int q = K - 2; q >= 0; --q) {
      x = __fsub_rn(rows[(3 * PARTS + q) * LB + j],
                    __fmul_rn(rows[(2 * PARTS + q) * LB + j], x));
      xs[q * LB + j] = x;
    }
  }
  __syncthreads();

  // 3. back substitution of the interior, a chunk of (c, Q) ahead
  if (live) {
    const float xl = k > 0 ? xs[(k - 1) * LB + j] : 0.f;
    float x = xs[k * LB + j];
    ur[bk] = x;
    float cc[CHUNK], cq[CHUNK], nc[CHUNK], nq[CHUNK];
    auto fetch_back = [&](int i0, float* rc, float* rq) {
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        const int i = i0 - q;
        if (i >= 0) {
          rc[q] = cs[(size_t)(s + i) * LB + j];
          rq[q] = qs[(size_t)(s + i) * LB + j];
        }
      }
    };
    fetch_back(m - 1, cc, cq);
    for (int i0 = m - 1; i0 >= 0; i0 -= CHUNK) {
      fetch_back(i0 - CHUNK, nc, nq);
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        const int i = i0 - q;
        if (i < 0) break;
        x = __fadd_rn(__fsub_rn(ur[s + i], __fmul_rn(cc[q], x)),
                      __fmul_rn(cq[q], xl));
        ur[s + i] = x;
      }
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        cc[q] = nc[q];
        cq[q] = nq[q];
      }
    }
  }
  __syncthreads();

  // the block's lines out: along a line where its elements are adjacent,
  // across lines where the lines are
  const int lines = min(LB, B * L - first);
  const int n_out = lines * N;
  for (int e = threadIdx.x; e < n_out; e += LB * PARTS) {
    int jl, i;
    if (lo.step == 1) {
      jl = e / N;
      i = e - jl * N;
    } else {
      i = e / lines;
      jl = e - i * lines;
    }
    const int tl = first + jl;
    const int bl = tl / L;
    u[bl * lo.plane + (tl - bl * L) * lo.line + i * lo.step] = us[jl * NP + i];
  }
}

template <int LB>
size_t smem_bytes(int N) {
  return sizeof(float) * ((size_t)LB * (N + 1) + 8 * PARTS * LB);
}

template <int LB>
int launch(const float* a, const float* w, const float* d, float* u,
           float* scratch, int B, int L, int N, Layout lo, Layout wlo,
           float lam, cudaStream_t stream) {
  const size_t bytes = smem_bytes<LB>(N);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wls_lines_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int S = (N + PARTS - 1) / PARTS;
  const int K = (N + S - 1) / S;
  const long long lines = (long long)B * L;
  const unsigned blocks = (unsigned)((lines + LB - 1) / LB);
  wls_lines_kernel<LB><<<blocks, LB * PARTS, bytes, stream>>>(
      a, w, d, u, scratch, B, L, N, S, K, lo, wlo, lam);
  return (int)cudaGetLastError();
}

}  // namespace

// a, d, u share layout lo (B x L lines of N elements); w has N - 1 elements
// a line, layout wlo. scratch: 2 * ceil(B * L / 4) * 4 * N floats. u may
// not alias a, w or d.
extern "C" int i3dr_wls_lines(const void* a, const void* w, const void* d,
                              void* u, void* scratch, int B, int L, int N,
                              long long plane, long long line,
                              long long step, long long wplane,
                              long long wline, long long wstep, float lam,
                              void* stream) {
  const long long lines = (long long)B * L;
  if (lines * N == 0) return 0;
  if (lines > 0x7fffffffLL || lines * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Layout lo{plane, line, step}, wlo{wplane, wline, wstep};
  auto* A = (const float*)a;
  auto* W = (const float*)w;
  auto* D = (const float*)d;
  auto* U = (float*)u;
  auto* T = (float*)scratch;
  auto* st = (cudaStream_t)stream;
  // four lines a block while a line's row fits beside three more in
  // shared memory, else one
  if (smem_bytes<4>(N) <= 227 * 1024)
    return launch<4>(A, W, D, U, T, B, L, N, lo, wlo, lam, st);
  if (smem_bytes<1>(N) <= 227 * 1024)
    return launch<1>(A, W, D, U, T, B, L, N, lo, wlo, lam, st);
  return (int)cudaErrorInvalidValue;
}
