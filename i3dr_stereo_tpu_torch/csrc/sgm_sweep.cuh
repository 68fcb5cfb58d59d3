// sgm_sweep — the SGM stage of the flagship matcher as one family of
// accumulating sweeps over the uint8 cost volume C (B, H, W, 32).
//
// Replaces the scanline recurrences, the int16 running sums and the WTA
// of the four flagship TPU kernels in i3dr_stereo_tpu/ops/sgm_fused_t.py:
//   _fwd_kernel     (pallas_call :187)  — A's sweep   STORE_I16
//   _rev_kernel     (pallas_call :242)  — B           ADDF_I16
//   _vdown_kernel   (pallas_call :318)  — C           ADDI_I16 / the F32 ops
//   _vup_wta_kernel (pallas_call :423)  — D           WTA_I16 / WTA_F32
//
// One launch walks every scanline of one direction (dy, dx):
//   L(p, d) = (c(p, d) + min(L(p-r, d), L(p-r, d±1) + P1, m + P2)) - m
//   m = min_k L(p-r, k),  c = 1e9 for an invalid cost,  t = min(L, 10000)
// with a zero carry where a path enters the image (and at the entering
// column of a diagonal, the TPU's zeroed column). What a sweep does with t
// is its op. No per-direction volume is written: each sweep folds t into
// the running sum that the TPU's kernels hand from one to the next, with
// the TPU's truncation points, and the last one ends in the WTA:
//   STORE_I16  S16 = int(t)                               (0, 1)
//   ADDF_I16   S16 = int(t + float(S16))                  (0, -1)
//   ADDI_I16   S16 = S16 + int(t)                         (1, 0), 4 paths
//   WTA_I16    S = float(S16) + t, then the WTA           (-1, 0), 4 paths
// 8 paths sum three directions in float32 before one truncation, and add
// the three up directions in float32, so a float32 plane F accumulates:
//   STORE_F32  F = t                                      first down
//   ADD_F32    F = F + t                    second down, first two ups
//   FIN_F32    F = float(S16 + int(F + t))                third down
//   WTA_F32    S = F + t, then the WTA                    third up
// S16 + S_down reaches 50000 there; it is kept in F (float32 holds it
// exactly), so 8 paths need no wider integer plane.
// A lane reads and writes only its own elements of S16 / F at its own
// step, so both are updated in place.
//
// The WTA (per pixel; first minimum, never a packed key):
//   m = min_d S, db = first d with S == m
//   valid = m < 9999 and min_d C < 255 [and the uniqueness margin:
//           min over |d - db| > 1 of S, times (100 - ur), >= 100 m]
//   disp = db + clip((Sm - Sp) / (2 (Sm + Sp - 2m)), ±0.5) for 0 < db < 31
// float32 disparity, -1e9 where invalid. Every float operation is rounded
// on its own (__fadd_rn ...) in the reference's order, so each sweep
// equals its torch twin bit for bit.
//
// What bounds it on the card: its loads. A 4-path level moves 516 bytes a
// pixel (2.7 GB at 2560x2048, 0.81 ms at 3.35 TB/s) where per-direction
// float32 volumes and a separate sum kernel moved 1184. A sweep is a few
// thousand scanlines, each a chain of W (or H) dependent steps, reading
// and writing its sum in place in accesses of 32 to 128 bytes. With its
// loads taken out a plain sweep takes 0.20-0.24 ms (the chains), with the
// recurrence taken out and the loads kept 0.38-0.43 ms, as long as the
// whole sweep: about 2 TB/s, which no lane layout, prefetch depth or L2
// prefetch moved (NVIDIA H100 80GB HBM3, 700 W). The sweep that ends in
// the WTA is held by both (0.39 ms without either, 0.47-0.53 whole).
//
// Design.
// - Lane layout: DPL = 4 consecutive disparities a lane, LANES = 8 lanes a
//   scanline, 4 scanlines a warp. Against one disparity a lane that is a
//   3-step butterfly for min_d instead of 5, d±1 neighbours mostly in
//   registers, wider loads and stores (C as 4 bytes, int16 sums as 8, the
//   float32 plane as 16 a lane) and a quarter of the instructions a pixel,
//   at the price of a quarter of the warps. 1, 2 and 4 disparities a lane
//   measured within 4 % of each other for the stage and 8 a third slower
//   (too few warps); 4 was the fastest.
// - The loads of a step (C and the running sum) do not depend on the
//   carry: the next U steps' loads fly while the current U are walked (two
//   register buffers).
// - The steps every scanline of a warp has are walked in blocks of U with
//   no test and no branch between them, so the compiler lays a step's
//   conversions and stores over the next steps' chains; the few steps left
//   over (a length that is no multiple of U, a diagonal's uneven ends) go
//   one by one with every access tested. A diagonal's scanlines are
//   numbered so that neighbours differ by one step in length.
// - The WTA does not run in the sweep's lane layout: butterflies over a
//   scanline's lanes for m, db and the margin cost more than the sweep
//   itself where a scheduler holds one warp. A block's sums go through a
//   tile of shared memory and each lane scans one pixel's 32 sums in
//   registers (see WtaTile).
#pragma once

#include <climits>

#include "common.cuh"

namespace i3dr {

enum SweepOp {
  STORE_I16 = 0,
  ADDF_I16 = 1,
  ADDI_I16 = 2,
  STORE_F32 = 3,
  ADD_F32 = 4,
  FIN_F32 = 5,
  WTA_I16 = 6,
  WTA_F32 = 7,
};

constexpr int SWEEP_THREADS = 128;
constexpr int DPL = 4;             // consecutive disparities a lane
constexpr int LANES = WARP / DPL;  // lanes a scanline

// BYTES (4, 8 or 16) consecutive bytes of one lane, moved as one vector
// access and unpacked with shifts
template <int BYTES>
struct Raw {
  static constexpr int NW = (BYTES + 3) / 4;
  uint32_t w[NW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
  }
  // RO: through the read-only path (the buffer is not written by this
  // launch)
  template <bool RO>
  __device__ __forceinline__ void load(const void* p) {
    if constexpr (BYTES == 4) {
      w[0] = RO ? __ldg((const uint32_t*)p) : *(const uint32_t*)p;
    } else if constexpr (BYTES == 8) {
      const uint2 t = RO ? __ldg((const uint2*)p) : *(const uint2*)p;
      w[0] = t.x, w[1] = t.y;
    } else {
      static_assert(BYTES == 16, "unsupported width");
      const uint4 t = RO ? __ldg((const uint4*)p) : *(const uint4*)p;
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    }
  }
  __device__ __forceinline__ void store(void* p) const {
    if constexpr (BYTES == 4) {
      *(uint32_t*)p = w[0];
    } else if constexpr (BYTES == 8) {
      *(uint2*)p = make_uint2(w[0], w[1]);
    } else {
      *(uint4*)p = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __device__ __forceinline__ int u8(int i) const {
    return (int)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
  }
  __device__ __forceinline__ int i16(int i) const {
    return (int)(int16_t)(uint16_t)(w[i >> 1] >> (16 * (i & 1)));
  }
  __device__ __forceinline__ float f32(int i) const {
    return __uint_as_float(w[i]);
  }
  // set_i16 is called for i = 0, 1, 2, ... in order
  __device__ __forceinline__ void set_i16(int i, int v) {
    const uint32_t h = (uint32_t)v & 0xffffu;
    if ((i & 1) == 0)
      w[i >> 1] = h;
    else
      w[i >> 1] |= h << 16;
  }
  __device__ __forceinline__ void set_f32(int i, float v) {
    w[i] = __float_as_uint(v);
  }
};

// cost of disparity k of a lane's raw costs: uint8 C (255 = invalid) or
// census_cost's int16 unclamped plane (negative = invalid)
template <typename CostT, int BYTES>
__device__ __forceinline__ float sweep_cost(const Raw<BYTES>& r, int k) {
  if constexpr (sizeof(CostT) == 1) {
    const int c = r.u8(k);
    return c == SENTINEL ? BIG : (float)c;
  } else {
    const int c = r.i16(k);
    return c < 0 ? BIG : (float)c;
  }
}

// One step of the recurrence for a scanline held by LANES lanes, DPL
// consecutive disparities each (d = sl * DPL + k); the reference's float32
// sequence, rounded per operation.
__device__ __forceinline__ void sweep_step(const float (&prev)[DPL],
                                           const float (&c)[DPL],
                                           float (&L)[DPL], int sl, float p1,
                                           float p2) {
  float lm = prev[0];
#pragma unroll
  for (int k = 1; k < DPL; ++k) lm = fminf(lm, prev[k]);
  const float m = lanes_min<LANES>(lm);
  float up = __shfl_up_sync(FULL, prev[DPL - 1], 1, LANES);  // L(d-1)
  float dn = __shfl_down_sync(FULL, prev[0], 1, LANES);      // L(d+1)
  if (sl == 0) up = BIG;
  if (sl == LANES - 1) dn = BIG;
  const float mp2 = __fadd_rn(m, p2);
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const float lo = k == 0 ? up : prev[k - 1];
    const float hi = k == DPL - 1 ? dn : prev[k + 1];
    const float best = fminf(fminf(prev[k], mp2),
                             fminf(__fadd_rn(lo, p1), __fadd_rn(hi, p1)));
    L[k] = __fsub_rn(__fadd_rn(c[k], best), m);
  }
}

// The WTA runs one pixel a lane. A block of N steps leaves a warp with
// DPL * N <= 32 pixels' sums spread over its lanes; they go through a
// padded tile of shared memory (row = pixel, 33 floats, so that a lane
// reading its own row meets no bank conflict), and each lane then scans
// the 32 sums of one pixel in registers: no shuffle, far fewer
// instructions a pixel than butterflies over a scanline's lanes, and one
// division a lane instead of one a step. The tile belongs to the warp: __syncwarp is the only
// barrier.
constexpr int WTA_ROW = WARP + 1;

struct WtaTile {
  float S[WARP * WTA_ROW];  // [pixel][disparity], padded
  int any_cost[WARP];       // min_d C < 255
};

__device__ __forceinline__ WtaTile& wta_tile() {
  __shared__ WtaTile tiles[SWEEP_THREADS / WARP];
  return tiles[threadIdx.x / WARP];
}

// min of row[0..31] and its first index, as four interleaved scans
__device__ __forceinline__ void wta_row_min(const float* row, float& m,
                                            int& db) {
  float v[4];
  int i[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = row[8 * c], i[c] = 8 * c;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const float x = row[8 * c + j];
      if (x < v[c]) v[c] = x, i[c] = 8 * c + j;
    }
  }
  m = v[0], db = i[0];
#pragma unroll
  for (int c = 1; c < 4; ++c)
    if (v[c] < m) m = v[c], db = i[c];
}

// One pixel's WTA from its row of the tile (which it may overwrite).
__device__ __forceinline__ float wta_pixel(float* row, bool any_cost,
                                           int subpixel, float ur) {
  float m;
  int db;
  wta_row_min(row, m, db);
  const float Sm = row[db > 0 ? db - 1 : 0];
  const float Sp = row[db < WARP - 1 ? db + 1 : db];
  bool valid = (m < 9999.0f) && any_cost;
  if (ur > 0.0f) {  // uniqueness margin against |d - db| > 1; uniform
    if (db > 0) row[db - 1] = BIG;
    row[db] = BIG;
    if (db < WARP - 1) row[db + 1] = BIG;
    float far;
    int unused;
    wta_row_min(row, far, unused);
    valid = valid &&
            (__fmul_rn(far, __fsub_rn(100.0f, ur)) >= __fmul_rn(m, 100.0f));
  }
  float d = (float)db;
  if (subpixel) {
    const float denom = __fsub_rn(__fadd_rn(Sm, Sp), __fmul_rn(2.0f, m));
    float off = denom > 1e-9f
                    ? __fdiv_rn(__fsub_rn(Sm, Sp), __fmul_rn(2.0f, denom))
                    : 0.0f;
    off = fminf(fmaxf(off, -0.5f), 0.5f);
    if (db > 0 && db < WARP - 1) d = __fadd_rn(d, off);
  }
  return valid ? d : NODATA;
}

// floor to a power of two of min(8, 32 / words): the steps whose loads
// are kept in flight, sized so the two buffers stay within ~64 registers
__host__ __device__ constexpr int sweep_unroll(int words) {
  int u = 8;
  while (u > 1 && u * words > 32) u >>= 1;
  return u;
}

__host__ __device__ constexpr bool sweep_reads_s16(int op) {
  return op == ADDF_I16 || op == ADDI_I16 || op == FIN_F32 || op == WTA_I16;
}
__host__ __device__ constexpr bool sweep_reads_f32(int op) {
  return op == ADD_F32 || op == FIN_F32 || op == WTA_F32;
}

// what one lane loads for one step: its costs and its elements of the
// running sums (a member that the op does not read stays zero)
template <typename CostT>
struct SweepIn {
  Raw<DPL * (int)sizeof(CostT)> c;
  Raw<DPL * 2> s;
  Raw<DPL * 4> f;
};

// the buffers of one launch and the constants of its direction
template <typename CostT>
struct SweepArgs {
  const CostT* C;
  int16_t* S16;
  float* F32;
  float* disp;
  long long estride;  // elements from one step to the next
  float p1, p2, ur;
  int subpixel;
};

// start the loads of N steps from the lane's element offset `e`; with
// GUARD only those of steps below `len` (the others read as zero)
template <int OP, bool GUARD, typename CostT, int N>
__device__ __forceinline__ void sweep_load(SweepIn<CostT> (&buf)[N],
                                           const SweepArgs<CostT>& a,
                                           long long e, int s0, int len) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long o = e + u * a.estride;
    buf[u].c.zero();
    buf[u].s.zero();
    buf[u].f.zero();
    if (!GUARD || s0 + u < len) {
      buf[u].c.template load<true>(a.C + o);
      if constexpr (sweep_reads_s16(OP))
        buf[u].s.template load<false>(a.S16 + o);
      if constexpr (sweep_reads_f32(OP))
        buf[u].f.template load<false>(a.F32 + o);
    }
  }
}

// N steps of one scanline group from loaded inputs: the recurrence, the
// op, the stores. Without GUARD the N steps are one straight run of
// instructions — no branch between them, so the compiler lays a step's
// conversions, stores and WTA over the next steps' dependent chains; with
// GUARD each store is tested against the scanline's length. With TAIL (the
// last warp of a launch whose scanlines do not fill it) a group that is not
// `live` walks along for the shuffles and stores nothing; a test of `live`
// before the stores of every warp cost the storing sweeps 10-25 %.
template <int OP, bool GUARD, bool TAIL, typename CostT, int N>
__device__ __forceinline__ void sweep_steps(
    const SweepIn<CostT> (&in)[N], float (&prev)[DPL],
    const SweepArgs<CostT>& a, long long e, int s0, int len, bool live,
    int sl, int lane) {
  constexpr bool WTA = OP == WTA_I16 || OP == WTA_F32;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    // same for the group's lanes
    const bool on = (!TAIL || live) && (!GUARD || s0 + u < len);
    float c[DPL], L[DPL], t[DPL];
#pragma unroll
    for (int k = 0; k < DPL; ++k) c[k] = sweep_cost<CostT>(in[u].c, k);
    sweep_step(prev, c, L, sl, a.p1, a.p2);
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      prev[k] = L[k];
      t[k] = fminf(L[k], CLAMP);
    }
    const long long o = e + u * a.estride;
    if constexpr (OP == STORE_I16 || OP == ADDF_I16 || OP == ADDI_I16) {
      Raw<DPL * 2> out;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        int v;
        if constexpr (OP == STORE_I16)
          v = (int)t[k];
        else if constexpr (OP == ADDF_I16)
          v = (int)__fadd_rn(t[k], (float)in[u].s.i16(k));
        else
          v = in[u].s.i16(k) + (int)t[k];
        out.set_i16(k, v);
      }
      if (on) out.store(a.S16 + o);
    } else if constexpr (!WTA) {
      Raw<DPL * 4> out;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        float v;
        if constexpr (OP == STORE_F32)
          v = t[k];
        else if constexpr (OP == ADD_F32)
          v = __fadd_rn(in[u].f.f32(k), t[k]);
        else
          v = (float)(in[u].s.i16(k) + (int)__fadd_rn(in[u].f.f32(k), t[k]));
        out.set_f32(k, v);
      }
      if (on) out.store(a.F32 + o);
    } else {
      // the sums of pixel (group, step u) into row group * N + u
      WtaTile& tile = wta_tile();
      const int p = (lane / LANES) * N + u;
      int lc = in[u].c.u8(0);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const float S = OP == WTA_I16
                            ? __fadd_rn((float)in[u].s.i16(k), t[k])
                            : __fadd_rn(in[u].f.f32(k), t[k]);
        tile.S[p * WTA_ROW + sl * DPL + k] = S;
        lc = min(lc, in[u].c.u8(k));
      }
      const unsigned group_bits = ((1u << LANES) - 1u)
                                  << (lane & ~(LANES - 1));
      const unsigned with_cost = __ballot_sync(FULL, lc < SENTINEL);
      if (sl == 0) tile.any_cost[p] = (with_cost & group_bits) != 0u;
    }
  }
  if constexpr (WTA) {
    static_assert(DPL * N <= WARP, "a block's pixels must fit the tile");
    // lane p takes pixel p = group * N + u; its place, its scanline's
    // length and whether it is live come from the group's first lane
    WtaTile& tile = wta_tile();
    const int src = (lane / N * LANES) & (WARP - 1);
    const int u = lane % N;
    const long long e_src = __shfl_sync(FULL, e, src);
    const int len_src = __shfl_sync(FULL, !TAIL || live ? len : 0, src);
    __syncwarp();
    if (lane < DPL * N) {
      const float d = wta_pixel(tile.S + lane * WTA_ROW,
                                tile.any_cost[lane] != 0, a.subpixel, a.ur);
      if ((!GUARD && !TAIL) || s0 + u < len_src)
        a.disp[(e_src + u * a.estride) >> 5] = d;
    }
    __syncwarp();  // the tile is free for the next block
  }
}

// One warp's scanlines from their first pixels (element offset `e`, `len`
// steps): the steps every scanline of the warp has, in whole blocks of U,
// run unguarded; the few left (a diagonal's uneven ends, a length that is
// no multiple of U) one by one with every load and store tested.
template <typename CostT, int OP, bool TAIL>
__device__ __forceinline__ void sweep_walk(const SweepArgs<CostT>& a,
                                           long long e, int len, bool live,
                                           int sl, int lane) {
  using In = SweepIn<CostT>;
  constexpr int U = sweep_unroll(
      Raw<DPL * (int)sizeof(CostT)>::NW +
      (sweep_reads_s16(OP) ? Raw<DPL * 2>::NW : 0) +
      (sweep_reads_f32(OP) ? Raw<DPL * 4>::NW : 0));
  const int n_full = __reduce_min_sync(FULL, len) / U * U;
  const int max_len = __reduce_max_sync(FULL, len);

  float prev[DPL];
#pragma unroll
  for (int k = 0; k < DPL; ++k) prev[k] = 0.0f;

  In next[U];
  if (n_full > 0) sweep_load<OP, false>(next, a, e, 0, len);
  for (int s0 = 0; s0 < n_full; s0 += U) {
    In cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[u];
    // the next block's loads fly while this block is walked
    if (s0 + 2 * U <= n_full)
      sweep_load<OP, false>(next, a, e + U * a.estride, s0 + U, len);
    sweep_steps<OP, false, TAIL>(cur, prev, a, e, s0, len, live, sl, lane);
    e += U * a.estride;
  }
#pragma unroll 1
  for (int s = n_full; s < max_len; ++s) {
    In one[1];
    sweep_load<OP, true>(one, a, e, s, len);
    sweep_steps<OP, true, TAIL>(one, prev, a, e, s, len, live, sl, lane);
    e += a.estride;
  }
}

template <typename CostT, int OP>
__global__ void __launch_bounds__(SWEEP_THREADS)
    sgm_sweep_kernel(SweepArgs<CostT> a, int H, int W, int dy, int dx,
                     int n_lines, long long total_lines) {
  const int lane = threadIdx.x & 31;
  const int sl = lane & (LANES - 1);  // lane within the scanline's group
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (warp * DPL >= total_lines) return;  // uniform across the warp
  // the group's scanline, over the batch; in the last warp the groups past
  // the last scanline walk it again (same loads, for the warp's shuffles)
  // and store nothing
  const long long g = min(warp * DPL + lane / LANES, total_lines - 1);
  const bool live = warp * DPL + lane / LANES < total_lines;
  const int b = (int)(g / n_lines);
  const int line = (int)(g % n_lines);

  // first pixel of the scanline: the pixel whose predecessor (y-dy, x-dx)
  // lies outside the image. A diagonal's scanlines are numbered along the
  // edge they enter through — the top (bottom) row from the far corner
  // to the entering column, then down (up) that column — so neighbouring
  // scanlines differ by one step in length.
  int y, x;
  if (dy == 0) {
    y = line;
    x = dx > 0 ? 0 : W - 1;
  } else if (dx == 0) {
    x = line;
    y = dy > 0 ? 0 : H - 1;
  } else if (line < W) {
    x = dx > 0 ? W - 1 - line : line;
    y = dy > 0 ? 0 : H - 1;
  } else {
    const int j = line - W + 1;  // 1 .. H-1: entering through a side column
    y = dy > 0 ? j : H - 1 - j;
    x = dx > 0 ? 0 : W - 1;
  }
  const int ny = dy == 0 ? INT_MAX : (dy > 0 ? H - y : y + 1);
  const int nx = dx == 0 ? INT_MAX : (dx > 0 ? W - x : x + 1);
  const int len = min(ny, nx);
  const long long e = (((long long)b * H + y) * W + x) * WARP + sl * DPL;
  if ((warp + 1) * DPL <= total_lines)  // uniform across the warp
    sweep_walk<CostT, OP, false>(a, e, len, true, sl, lane);
  else
    sweep_walk<CostT, OP, true>(a, e, len, live, sl, lane);
}

// Launch OP; returns cudaGetLastError().
template <typename CostT, int OP>
int sweep_launch(const void* C, void* S16, void* F32, void* disp, int B, int H,
                 int W, int dy, int dx, float p1, float p2, int subpixel,
                 float ur, cudaStream_t stream) {
  if ((dy == 0 && dx == 0) || dy < -1 || dy > 1 || dx < -1 || dx > 1)
    return (int)cudaErrorInvalidValue;
  const int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const long long total_lines = (long long)B * n_lines;
  if (total_lines == 0) return 0;
  const long long warps = (total_lines + DPL - 1) / DPL;
  const long long blocks =
      (warps * WARP + SWEEP_THREADS - 1) / SWEEP_THREADS;
  SweepArgs<CostT> a;
  a.C = (const CostT*)C;
  a.S16 = (int16_t*)S16;
  a.F32 = (float*)F32;
  a.disp = (float*)disp;
  a.estride = ((long long)dy * W + dx) * WARP;
  a.p1 = p1, a.p2 = p2, a.ur = ur;
  a.subpixel = subpixel;
  sgm_sweep_kernel<CostT, OP>
      <<<(unsigned)blocks, SWEEP_THREADS, 0, stream>>>(a, H, W, dy, dx,
                                                       n_lines, total_lines);
  return (int)cudaGetLastError();
}

}  // namespace i3dr
