// bt_box_cost — the Birchfield-Tomasi pixel cost and its box sum over the
// correlation window in one pass (two for windows of 19 and wider): the
// aggregated (B, H, W, D) float32 volume of SGBM's BT cost, written once.
//
// Replaces no TPU kernel: the reference computes it in XLA
// (i3dr_stereo_tpu/ops/cost.py · bt_cost_volume, box_aggregate). Its plain
// twin is ops/cost.py's box_aggregate(*bt_cost_volume(...)), and the
// kernel is bit-equal to it:
//   lo/hi = min/max of v, 0.5 * (v + v[x-1]), 0.5 * (v + v[x+1]) (columns
//           edge-replicated), on both prefiltered images;
//   c(y, x, d) = min(max(L - hiR, loR - L, 0), max(R - hiL, loL - R, 0)),
//           R the right pixel at x' = x - min_disp - d, where 0 <= x' < W
//           (valid), else 0;
//   T(y, x, d) = c(y-r) + c(y-r+1) + ... + c(y+r), rows clamped, added in
//           that order;
//   S(y, x, d) = T(x-r) + T(x-r+1) + ... + T(x+r), columns clamped, in that
//           order, where (x, d) is valid, else 1e9.
// A running (sliding) sum would round otherwise on fractional images, so
// every sum is the 2r + 1 terms added in order (r = window / 2, any r:
// 0-8 in one pass, wider windows in two, below).
//
// What bounds it: bytes. At 1x1080x1920x480 the volume is 3.98 GB out
// (1.19 ms at 3.35 TB/s) against 8.3 MB of images in; its ~2r adds a pass
// an element are ~0.3 ms at the float32 rate. The plain route moved ~450
// GB through three gathered volumes, the elementwise passes over them and a
// copy a tap of the box sum.
//
// Design (bt_box_cost_kernel): a block of 8 warps owns a tile of TX = 32
// columns and DC = 32 disparities (a lane each, so every store is a
// 128-byte line with D innermost) and marches down a strip of rows:
// - The left pixels of the tile and its r-column halo, and the right pixels
//   those pairings reach (TX + 2r + DC - 1 columns), are copied AHEAD = 2
//   rows ahead by cp.async (a thread a column, its two neighbours with it)
//   and staged as (v, lo, hi) in shared memory, bounds computed once a
//   row. A right column outside the image stages (0, -inf, +inf), which
//   makes its pairings' cost exactly 0 with no test.
// - Each warp owns halo columns j = warp + 8 k: a lane computes its
//   pairing's cost from the staged row and keeps the last 2r + 1 of its
//   column's costs in registers (a ring indexed at compile time: the row
//   loop is unrolled by 2r + 1), then the column's ordered sum T goes to a
//   shared plane.
// - Each warp then sums 4 consecutive output columns from that plane,
//   2r + 4 loads for 4 sums, and stores them.
// - One barrier a row: the staging of row s + 1, the costs of row s and the
//   row sums of row s - 1 use separate halves of double-buffered planes.
// - A tile with no valid pairing (x' < 0 everywhere: the left band that
//   min_disp and D leave unmatched) writes 1e9 and computes nothing.
// - A block marches 32 rows at window 1, 64 at 3 and 128 beyond (at
//   window 9: 128 rows 2.69 ms, 64 rows 2.81).
// Measured at 1x1080x1920x480 from 147, back to back, in turns
// (kernel_probes/probe11.py; NVIDIA H100 80GB HBM3, 700 W): window 9
// 2.687 ms, 44 % of the bound; window 1 1.570 (76 %), 5 2.817, 11 3.276;
// a fill_ of the same volume 1.211. What stands: the march's instructions
// and shared-memory loads (16 ordered adds, 9 operations of the cost and
// ~4 loads an element), not bytes.
//
// Windows of 13 to 17 (r = 6-8) run the same kernel: 4.29, 5.02 and 5.33
// ms at 13, 15 and 17 (r = 6, 7 spill a little at two blocks an SM, and
// are faster so than at one without spills: 5.23, 5.64). Wider windows,
// up to the 255 that the node's reconfigure allows, outgrow the register
// ring (a ring of up to r = 12 was 11.0-12.8 ms at 19-25, against the
// 12.3-13.8 below, for twice the build time), and take two passes through
// a scratch volume of the output's shape, each sum still the 2r + 1 terms
// in order:
// - bt_box_cost_kernel_cols: T, a thread a (column, disparity) and 32
//   output rows. It computes the costs of its column CH rows at a time
//   into its own column of shared memory (read by no other thread: no
//   barrier), then adds to each of the 32 sums the terms of those rows its
//   window holds, in order. An invalid pairing's T is 0.
// - bt_box_cost_kernel_rows: S, a warp 32 output columns of a row, a lane
//   a disparity, staging CH columns of T at a time the same way; 1e9 where
//   (x, d) is invalid.
// At 1x1080x1920x480: 12.3 ms at window 19, 12.8 at 21, 18.7 at 41, 81.1
// at 255; of window 21's, T 7.8 and S 5.0. T's time is the costs' (each
// thread recomputes its pixels' bounds: 4.4 ms with a plain load in their
// place) and the sums' runtime-bounded loops, not its stores (7.6 ms
// without them).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / i3dr::WARP;
constexpr int TX = 32;           // output columns a tile
constexpr int DC = i3dr::WARP;   // disparities a tile, a lane each
constexpr int OPW = TX / WARPS;  // output columns a warp sums
constexpr int MAX_R = 8;         // one pass for windows up to 17
constexpr int RV = 32;           // wide: output rows a thread sums (cols)
constexpr int CH = 32;           // wide: rows or columns staged at once
constexpr int AHEAD = 2;         // rows whose copies fly ahead of the march

struct BoxArgs {
  const float* left;  // (B, H, W) prefiltered images
  const float* right;
  float* out;         // (B, H, W, D)
  int H, W, D, min_disp, rows, strips;
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// (v, lo, hi) of a pixel from it and its two neighbours, as the twin
// orders it: the half-samples 0.5 * (v + n), then min(min(-, +), v)
__device__ __forceinline__ float4 bounds(float vm, float v, float vp) {
  const float minus = __fmul_rn(0.5f, __fadd_rn(v, vm));
  const float plus = __fmul_rn(0.5f, __fadd_rn(v, vp));
  return make_float4(v, fminf(fminf(minus, plus), v),
                     fmaxf(fmaxf(minus, plus), v), 0.f);
}

// the BT cost of a left and a right pixel's (v, lo, hi), in the twin's
// order: min(max(L - hiR, loR - L, 0), max(R - hiL, loL - R, 0))
__device__ __forceinline__ float bt_cost(float4 l, float4 r) {
  const float cl = fmaxf(fmaxf(__fsub_rn(l.x, r.z), __fsub_rn(r.y, l.x)), 0.f);
  const float cr = fmaxf(fmaxf(__fsub_rn(r.x, l.z), __fsub_rn(l.y, r.x)), 0.f);
  return fminf(cl, cr);
}

// two blocks an SM up to r = 7 (spilling a little from r = 4), one at 8
template <int R>
__global__ void __launch_bounds__(THREADS, R > 7 ? 1 : 2)
    bt_box_cost_kernel(BoxArgs a) {
  constexpr int TAPS = 2 * R + 1;
  constexpr int NC = TX + 2 * R;              // halo columns
  constexpr int NR = NC + DC - 1;             // right columns they reach
  constexpr int CPW = (NC + WARPS - 1) / WARPS;
  constexpr int NT = OPW + 2 * R;             // sums a warp's columns read
  static_assert(NC + NR <= THREADS, "one thread a staged column");
  __shared__ float4 s_l[2][NC];               // (v, lo, hi) left
  __shared__ float4 s_r[2][NR];               // (v, lo, hi) right
  __shared__ float s_t[2][NC][DC];            // column sums T
  __shared__ float4 s_raw[AHEAD][NC + NR];    // a stager's 3 pixels a row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * TX, d0 = blockIdx.y * DC;
  const int b = blockIdx.z / a.strips;
  const int y0 = (blockIdx.z % a.strips) * a.rows;
  const int ny = min(a.rows, a.H - y0);
  const int W = a.W, D = a.D, last = W - 1;
  const int d = d0 + lane;
  const long long plane = (long long)a.H * W;
  float* out = a.out + (((long long)b * a.H + y0) * W + x0) * D + d;
  const long long row_step = (long long)W * D;

  // no valid pairing in the tile: 1e9 everywhere, nothing computed
  const int xl = min(x0 + TX, W) - 1, dl = min(d0 + DC, D) - 1;
  if (xl - a.min_disp - d0 < 0 || x0 - a.min_disp - dl > last) {
    for (int h = 0; h < ny; ++h) {
#pragma unroll
      for (int q = 0; q < OPW; ++q) {
        const int t = warp * OPW + q;
        if (x0 + t < W && d < D)
          out[h * row_step + (long long)t * D] = i3dr::BIG;
      }
    }
    return;
  }

  // the right columns of the staged span start at xbase
  const int xbase = x0 - R - a.min_disp - d0 - (DC - 1);
  // each halo column's pairing: its staged right column
  int ir[CPW];
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int j = warp + WARPS * k;
    const int xr = clampi(x0 - R + j, last) - a.min_disp - d;
    ir[k] = min(xr - xbase, NR - 1);
  }
  bool okq[OPW];
#pragma unroll
  for (int q = 0; q < OPW; ++q) {
    const int x = x0 + warp * OPW + q;
    const int xr = x - a.min_disp - d;
    okq[q] = xr >= 0 && xr <= last;
  }

  // the staging thread's column: a left column of the halo, a right
  // column of the span, or none. A right column outside the image stages
  // (0, -inf, +inf), whose pairings cost exactly 0 (max(L - inf, -inf - L,
  // 0) = 0): the twin's invalid taps, with no test.
  const bool stager = tid < NC + NR;
  const float* src = nullptr;
  int col = 0;
  if (tid < NC) {
    src = a.left + b * plane;
    col = clampi(x0 - R + tid, last);
  } else if (stager) {
    col = xbase + (tid - NC);
    if (col >= 0 && col <= last) src = a.right + b * plane;
  }
  const int cm = max(col - 1, 0), cp = min(col + 1, last);
  // its slot in the first half of s_l or s_r; the second half is NC or
  // NR further on
  float4* stage = tid < NC ? &s_l[0][tid] : &s_r[0][tid - NC];
  const int half = tid < NC ? NC : NR;
  const int steps = ny + 2 * R;
  // the row of step s copied into the thread's slot s % AHEAD; every
  // thread commits one group a step, empty or not
  auto issue = [&](int s) {
    if (src && s < steps) {
      const float* row = src + (long long)clampi(y0 - R + s, a.H - 1) * W;
      float* dst = reinterpret_cast<float*>(&s_raw[s % AHEAD][tid]);
      __pipeline_memcpy_async(dst, row + cm, 4);
      __pipeline_memcpy_async(dst + 1, row + col, 4);
      __pipeline_memcpy_async(dst + 2, row + cp, 4);
    }
    __pipeline_commit();
  };
  // the (v, lo, hi) of step s's row into half s & 1, once its copies landed
  auto put = [&](int s) {
    if (!stager) return;
    float4 v = make_float4(0.f, -INFINITY, INFINITY, 0.f);
    if (src) {
      const float4 r = s_raw[s % AHEAD][tid];
      v = bounds(r.x, r.y, r.z);
    }
    stage[(s & 1) * half] = v;
  };

  float ring[CPW][TAPS];
  // the row sums of output row h - y0 = s - 2R - 1 from the plane of
  // step s - 1
  auto row_sums = [&](int s) {
    const int buf = (s - 1) & 1;
    const int t0 = warp * OPW;
    float c[NT];
#pragma unroll
    for (int o = 0; o < NT; ++o) c[o] = s_t[buf][t0 + o][lane];
    float* o_row = out + (long long)(s - 1 - 2 * R) * row_step;
#pragma unroll
    for (int q = 0; q < OPW; ++q) {
      float sum = c[q];
#pragma unroll
      for (int o = 1; o < TAPS; ++o) sum = __fadd_rn(sum, c[q + o]);
      if (x0 + t0 + q < W && d < D)
        o_row[(long long)(t0 + q) * D] = okq[q] ? sum : i3dr::BIG;
    }
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) issue(s);
  __pipeline_wait_prior(AHEAD - 1);
  put(0);
  __syncthreads();
  for (int s0 = 0; s0 < steps; s0 += TAPS) {
#pragma unroll
    for (int u = 0; u < TAPS; ++u) {
      const int s = s0 + u;
      if (s >= steps) break;
      const int buf = s & 1;
      // row s + AHEAD into the slot row s left (put in the step before)
      issue(s + AHEAD);
      // this row's costs into the ring (slot u), then each column's sum
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const int j = warp + WARPS * k;
        if (CPW * WARPS > NC && j >= NC) continue;
        ring[k][u] = bt_cost(s_l[buf][j], s_r[buf][ir[k]]);
        if (s >= 2 * R) {
          float sum = ring[k][(u + 1) % TAPS];
#pragma unroll
          for (int i = 1; i < TAPS; ++i)
            sum = __fadd_rn(sum, ring[k][(u + 1 + i) % TAPS]);
          s_t[buf][j][lane] = sum;
        }
      }
      if (s >= 2 * R + 1) row_sums(s);
      // row s + 1 landed: the copies of rows s + 2 .. s + AHEAD may fly
      __pipeline_wait_prior(AHEAD - 1);
      if (s + 1 < steps) put(s + 1);
      __syncthreads();
    }
  }
  row_sums(steps);
}

// (v, lo, hi) of pixel x of a row, its neighbours edge-replicated
__device__ __forceinline__ float4 pixel(const float* row, int x, int last) {
  return bounds(row[max(x - 1, 0)], row[x], row[min(x + 1, last)]);
}

// wide windows, pass 1: T(y, x, d) = c(y - r) + ... + c(y + r), rows
// clamped, into t. A warp a column, a lane a disparity, RV output rows a
// thread. The costs of CH rows at a time go to the thread's own column of
// shared memory (no other thread reads it: no barrier), and each sum then
// adds the terms of those rows its window holds, in order.
__global__ void __launch_bounds__(THREADS)
    bt_box_cost_kernel_cols(BoxArgs a, int r, float* t) {
  __shared__ float s_c[CH][THREADS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x = blockIdx.x * WARPS + warp, d = blockIdx.y * DC + lane;
  const int b = blockIdx.z / a.strips;
  const int y0 = (blockIdx.z % a.strips) * RV;
  if (x >= a.W || d >= a.D) return;
  const int W = a.W, D = a.D, last = W - 1;
  const int ny = min(RV, a.H - y0);
  const long long plane = (long long)a.H * W;
  const long long row_step = (long long)W * D;
  float* o = t + (((long long)b * a.H + y0) * W + x) * D + d;
  const int xr = x - a.min_disp - d;
  if (xr < 0 || xr > last) {  // an invalid pairing's taps add 0
    for (int k = 0; k < ny; ++k) o[k * row_step] = 0.f;
    return;
  }
  const float* left = a.left + b * plane;
  const float* right = a.right + b * plane;
  float acc[RV];
#pragma unroll
  for (int k = 0; k < RV; ++k) acc[k] = 0.f;
  const int end = y0 + ny + r;
  for (int c0 = y0 - r; c0 < end; c0 += CH) {
    const int n = min(CH, end - c0);
#pragma unroll 4
    for (int i = 0; i < CH; ++i) {
      if (i < n) {
        const long long row = (long long)clampi(c0 + i, a.H - 1) * W;
        s_c[i][tid] = bt_cost(pixel(left + row, x, last),
                              pixel(right + row, xr, last));
      }
    }
    // output row y0 + k's terms are rows y0 + k - r .. y0 + k + r
#pragma unroll
    for (int k = 0; k < RV; ++k) {
      const int hi = min(n, y0 + k + r + 1 - c0);
      float sum = acc[k];
      for (int i = max(0, y0 + k - r - c0); i < hi; ++i)
        sum = __fadd_rn(sum, s_c[i][tid]);
      acc[k] = sum;
    }
  }
#pragma unroll
  for (int k = 0; k < RV; ++k)
    if (k < ny) o[k * row_step] = acc[k];
}

// wide windows, pass 2: S(y, x, d) = T(x - r) + ... + T(x + r), columns
// clamped, 1e9 where (x, d) is invalid. A warp TX output columns of a row,
// a lane a disparity; CH columns of T at a time staged in the thread's own
// column of shared memory, as in pass 1.
__global__ void __launch_bounds__(THREADS)
    bt_box_cost_kernel_rows(BoxArgs a, int r, const float* t) {
  __shared__ float s_t[CH][THREADS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * TX, d = blockIdx.y * DC + lane;
  const int rows = (a.H + WARPS - 1) / WARPS;
  const int b = blockIdx.z / rows;
  const int y = (blockIdx.z % rows) * WARPS + warp;
  if (y >= a.H || d >= a.D) return;
  const int W = a.W, D = a.D, last = W - 1;
  const long long base = ((long long)b * a.H + y) * W;
  const float* t_row = t + base * D + d;
  float* o = a.out + (base + x0) * D + d;
  // no valid pairing in the warp's columns: 1e9 everywhere
  if (min(x0 + TX, W) - 1 - a.min_disp - d < 0 || x0 - a.min_disp - d > last) {
    for (int q = 0; q < TX && x0 + q < W; ++q) o[(long long)q * D] = i3dr::BIG;
    return;
  }
  float acc[TX];
#pragma unroll
  for (int q = 0; q < TX; ++q) acc[q] = 0.f;
  const int end = x0 + TX + r;
  for (int c0 = x0 - r; c0 < end; c0 += CH) {
    const int n = min(CH, end - c0);
#pragma unroll 8
    for (int i = 0; i < CH; ++i)
      if (i < n) s_t[i][tid] = t_row[(long long)clampi(c0 + i, last) * D];
    // output column x0 + q's terms are columns x0 + q - r .. x0 + q + r
#pragma unroll
    for (int q = 0; q < TX; ++q) {
      const int hi = min(n, x0 + q + r + 1 - c0);
      float sum = acc[q];
      for (int i = max(0, x0 + q - r - c0); i < hi; ++i)
        sum = __fadd_rn(sum, s_t[i][tid]);
      acc[q] = sum;
    }
  }
#pragma unroll
  for (int q = 0; q < TX; ++q) {
    const int x = x0 + q, xr = x - a.min_disp - d;
    if (x < W) o[(long long)q * D] = xr >= 0 && xr <= last ? acc[q] : i3dr::BIG;
  }
}

template <int R>
int launch(const BoxArgs& a, int B, cudaStream_t st) {
  const dim3 grid((a.W + TX - 1) / TX, (a.D + DC - 1) / DC, B * a.strips);
  bt_box_cost_kernel<R><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: a float32 volume of the output's shape, used only where
// radius > MAX_R (the two passes); may be null otherwise
extern "C" int i3dr_bt_box_cost(const void* left, const void* right,
                                void* out, void* scratch, int B, int H,
                                int W, int D, int min_disp, int radius,
                                void* stream) {
  if (radius < 0 || (radius > MAX_R && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W * D == 0) return 0;
  BoxArgs a;
  a.left = (const float*)left, a.right = (const float*)right;
  a.out = (float*)out;
  a.H = H, a.W = W, a.D = D, a.min_disp = min_disp;
  auto* st = (cudaStream_t)stream;
  const int dz = (D + DC - 1) / DC;
  if (radius > MAX_R) {
    a.rows = RV;
    a.strips = (H + RV - 1) / RV;
    const int row_blocks = (H + WARPS - 1) / WARPS;
    if ((long long)B * max(a.strips, row_blocks) > 65535 || dz > 65535)
      return (int)cudaErrorInvalidValue;
    float* t = (float*)scratch;
    bt_box_cost_kernel_cols<<<dim3((W + WARPS - 1) / WARPS, dz,
                                   B * a.strips), THREADS, 0, st>>>(a, radius,
                                                                    t);
    bt_box_cost_kernel_rows<<<dim3((W + TX - 1) / TX, dz, B * row_blocks),
                              THREADS, 0, st>>>(a, radius, t);
    return (int)cudaGetLastError();
  }
  // rows a block marches: more for a wider window, whose first 2r rows
  // only fill the ring
  a.rows = radius == 0 ? 32 : (radius == 1 ? 64 : 128);
  a.strips = (H + a.rows - 1) / a.rows;
  if ((long long)B * a.strips > 65535 || dz > 65535)
    return (int)cudaErrorInvalidValue;
  switch (radius) {
    case 0: return launch<0>(a, B, st);
    case 1: return launch<1>(a, B, st);
    case 2: return launch<2>(a, B, st);
    case 3: return launch<3>(a, B, st);
    case 4: return launch<4>(a, B, st);
    case 5: return launch<5>(a, B, st);
    case 6: return launch<6>(a, B, st);
    case 7: return launch<7>(a, B, st);
    default: return launch<8>(a, B, st);
  }
}
