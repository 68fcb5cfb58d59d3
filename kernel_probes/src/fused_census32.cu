// fused_census32 — fused_census_fwd at D = 32: the census hamming cost from
// word planes and the forward-horizontal SGM pass in one sweep, the uint8
// cost volume C and the W->E path costs L out together.
//
// Replaces i3dr_stereo_tpu/ops/fused_cost_sgm.py · _fused_fwd_kernel
// (pallas_call :201, entry fused_census_horizontal) — J — at the shape of
// the lean flagship path; fused_cost_sgm.cu states the contract (source
// column x - base[y / th] - min_disp - d, C = min(cost, 254) or 255, L on
// the unclamped cost with 1e9 where invalid, float32 or int16 S) and keeps
// the kernel for every other D.
//
// What bounds it on the card: its stores. At 1x2048x2448, D = 32, NW = 3
// it reads 0.12 GB of census words and writes 0.16 GB of C and 0.64 GB of
// float32 L: 0.92 GB, 0.28 ms at 3.35 TB/s; its 481 M popcounts are 0.12 ms
// at 16 a clock an SM. 2048 rows each write 160 bytes a step into two
// volumes, and the card takes such streams at ~2.2 TB/s (as it does the
// sweeps of sgm_sweep.cuh): 0.41 ms with float32 L whatever else the
// kernel does (without its costs 0.42, without its recurrence 0.43; NVIDIA
// H100 80GB HBM3, 700 W). The recurrence alone (no cost, no store) takes
// 0.27 ms, the costs alone 0.20-0.25; with int16 L (half the bytes) the
// two together set the time, 0.39 ms.
//
// Design (census32_kernel).
// - Lane layout: 2 consecutive disparities a lane, 16 lanes a row, 2 rows
//   a warp: 1024 warps at 2048 rows, two a scheduler, so one warp's costs
//   fill the other's dependent steps. C leaves as 2 bytes and L as 8
//   (int16: 4) a lane, 128 consecutive bytes of L a row and step. Measured
//   with float32 L: 0.41 ms against 0.49 for 4 disparities a lane (512
//   warps, 3-step butterflies) and 0.44 for one (2048 warps; 0.42-0.45 with
//   the warp's hardware minimum in place of the 5-step butterfly, which
//   wins only with int16 L, 0.33-0.37 against 0.39).
// - No lane loads a census word from global memory in the walk. A warp
//   stages a tile of 32 columns of its rows in shared memory: the left
//   words and the right words of the tile and its 31-column halo (from
//   column x0 - off - 31), by asynchronous 4-byte copies, coalesced along
//   the row, zero outside the image; the next tile's copies fly while this
//   one is walked (two buffers a warp, __syncwarp the only barrier).
// - A block of 8 columns: a lane reads its window of the right row (9
//   consecutive columns, 8-byte aligned for every lane) and the 8 left
//   words as vector loads from shared memory, computes the 16 costs (xor,
//   popcount, add; validity of the source column by one unsigned compare)
//   ahead of the recurrence, then walks the 8 steps with no test between
//   them. Within a tile the next block's costs are computed before this
//   block's steps, so the two overlap. The columns left over (W % 8) go
//   one by one through the same code.
// - The last warp of a launch whose rows do not fill it walks the last
//   row again in its idle lane group and stores nothing there (compiled
//   into that warp's walk only).
// - Two popcounts for three words by a carry-save adder, which census_cost
//   gains from, made this kernel no faster (0.41-0.44) and is not used.
#include <cuda_pipeline.h>

#include "common.cuh"
#include "fused_census32.cuh"

namespace {

constexpr int THREADS = 128;
constexpr size_t MAX_SHARED = 227 * 1024;

constexpr int DPL = 2;                   // consecutive disparities a lane
constexpr int LANES = i3dr::WARP / DPL;  // lanes a row
constexpr int ROWS = DPL;                // rows a warp
constexpr int TW = 32;           // columns a tile
constexpr int RW = TW + 32;      // right columns staged a tile: a halo of 31
                                 // and one that only fills the last vector
constexpr int PLANE = RW + TW;   // words of one row's plane in a buffer
constexpr int BLK = 8;           // columns a block
constexpr int C32_WARPS = THREADS / i3dr::WARP;

// words a warp stages for one tile
__host__ __device__ constexpr int tile_words(int NW) {
  return ROWS * NW * PLANE;
}

struct Census32Args {
  const uint32_t* cl;  // (NW, B, H, W) word planes
  const uint32_t* cr;
  const int* base;
  uint8_t* C;
  float* Sf;
  int16_t* Si;
  long long plane;  // B * H * W
  long long rows;   // B * H
  int H, W, NW, th, min_disp;
  float p1, p2;
};

// the costs of N columns of one lane: float for the recurrence (1e9 where
// the source column is outside the image) and the DPL bytes of C a column
template <int N>
struct Costs32 {
  float c[N][DPL];
  uint32_t cb[N];
};

// V = 2 or 4 words from p (V * 4 bytes aligned) as one access
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t* out) {
  static_assert(V == 2 || V == 4, "unsupported width");
  if constexpr (V == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
}

// One step of the recurrence for a row held by LANES lanes, DPL consecutive
// disparities each (d = sl * DPL + k); the reference's float32 sequence,
// rounded per operation (sgm_sweep.cuh's sweep_step at any DPL).
__device__ __forceinline__ void census32_step(const float (&prev)[DPL],
                                              const float (&c)[DPL],
                                              float (&L)[DPL], int sl,
                                              float p1, float p2) {
  float lm = prev[0];
#pragma unroll
  for (int k = 1; k < DPL; ++k) lm = fminf(lm, prev[k]);
  const float m = i3dr::lanes_min<LANES>(lm);
  float up = __shfl_up_sync(i3dr::FULL, prev[DPL - 1], 1, LANES);  // L(d-1)
  float dn = __shfl_down_sync(i3dr::FULL, prev[0], 1, LANES);      // L(d+1)
  if (sl == 0) up = i3dr::BIG;
  if (sl == LANES - 1) dn = i3dr::BIG;
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

// Start the copies of the tile at column xt into `buf`: for each of the
// warp's rows and each plane, RW right words from column xt - off - 31
// and TW left words from xt; zero where the column is outside the row.
template <int NWT>
__device__ __forceinline__ void census32_stage(
    const Census32Args& a, uint32_t* buf, const long long (&row)[ROWS],
    const int (&off)[ROWS], int xt, int lane) {
  const int NW = NWT ? NWT : a.NW;
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    const int c0 = xt - off[g] - (i3dr::WARP - 1);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t* dst = buf + (g * NW + w) * PLANE;
      const uint32_t* r = a.cr + w * a.plane + row[g];
      const uint32_t* l = a.cl + w * a.plane + row[g];
#pragma unroll
      for (int j = lane; j < RW; j += i3dr::WARP) {
        const int c = c0 + j;
        if (c >= 0 && c < a.W)
          __pipeline_memcpy_async(dst + j, r + c, 4);
        else
          dst[j] = 0u;
      }
      const int x = xt + lane;
      if (x < a.W)
        __pipeline_memcpy_async(dst + RW + lane, l + x, 4);
      else
        dst[RW + lane] = 0u;
    }
  }
  __pipeline_commit();
}

// The costs of N columns from tile column xo (N = BLK: xo a multiple of
// BLK) of the lane's row, whose planes start at `rowbuf`. s0 is the source
// column of (column xo, disparity DPL * sl): that of (xo + u, DPL * sl + k)
// is s0 + u - k, and it sits at word xo + 31 - DPL * sl + u - k of the plane.
template <int NWT, int N>
__device__ __forceinline__ void census32_costs(const uint32_t* rowbuf, int nw,
                                               int xo, int sl, int s0, int W,
                                               Costs32<N>& out) {
  const int NW = NWT ? NWT : nw;
  // the window: N + DPL - 1 right words from that of u - k = -(DPL - 1),
  // as whole vectors of DPL words when N = BLK
  constexpr int NR = N == BLK ? (N + DPL - 1 + DPL - 1) / DPL * DPL
                              : N + DPL - 1;
  const int j0 = xo + (i3dr::WARP - DPL) - DPL * sl;
  int ham[N][DPL];
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int k = 0; k < DPL; ++k) ham[u][k] = 0;

  auto load = [&](int w, uint32_t (&r)[NR], uint32_t (&l)[N]) {
    const uint32_t* pw = rowbuf + w * PLANE;
    if constexpr (N == BLK) {
#pragma unroll
      for (int q = 0; q < NR / DPL; ++q)
        load_words<DPL>(pw + j0 + DPL * q, r + DPL * q);
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        load_words<4>(pw + RW + xo + 4 * q, l + 4 * q);
    } else {
#pragma unroll
      for (int i = 0; i < NR; ++i) r[i] = pw[j0 + i];
#pragma unroll
      for (int u = 0; u < N; ++u) l[u] = pw[RW + xo + u];
    }
  };

#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t r[NR], l[N];
    load(w, r, l);
#pragma unroll
    for (int u = 0; u < N; ++u)
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        ham[u][k] += __popc(l[u] ^ r[DPL - 1 + u - k]);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    uint32_t cb = 0u;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const bool ok = (unsigned)(s0 + u - k) < (unsigned)W;
      out.c[u][k] = ok ? (float)ham[u][k] : i3dr::BIG;
      cb |= (uint32_t)(ok ? min(ham[u][k], 254) : i3dr::SENTINEL) << (8 * k);
    }
    out.cb[u] = cb;
  }
}

static_assert(DPL == 2, "the stores below are written for two values a lane");

// N steps of the recurrence from computed costs, and their stores at the
// lane's element offset e (step u: e + u * 32)
template <bool S16, bool TAIL, int N>
__device__ __forceinline__ void census32_steps(const Census32Args& a,
                                               const Costs32<N>& in,
                                               float (&prev)[DPL],
                                               long long e, bool live,
                                               int sl) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float L[DPL];
    census32_step(prev, in.c[u], L, sl, a.p1, a.p2);
#pragma unroll
    for (int k = 0; k < DPL; ++k) prev[k] = L[k];
    const long long o = e + u * i3dr::WARP;
    if (!TAIL || live) {
      *reinterpret_cast<uint16_t*>(a.C + o) = (uint16_t)in.cb[u];
      if constexpr (S16) {
        short2 v;  // truncates, as astype
        v.x = (short)(int)fminf(L[0], i3dr::CLAMP);
        v.y = (short)(int)fminf(L[1], i3dr::CLAMP);
        *reinterpret_cast<short2*>(a.Si + o) = v;
      } else {
        *reinterpret_cast<float2*>(a.Sf + o) = make_float2(L[0], L[1]);
      }
    }
  }
}

template <int NWT, bool S16, bool TAIL>
__device__ __forceinline__ void census32_walk(const Census32Args& a,
                                              uint32_t* bufs, long long warp,
                                              int lane) {
  const int NW = NWT ? NWT : a.NW;
  const int sl = lane & (LANES - 1);
  const int g = lane / LANES;
  // the rows of the warp; past the last row the last one again
  long long row[ROWS];
  int off[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long r = min(warp * ROWS + i, a.rows - 1);
    row[i] = r * a.W;
    off[i] = __ldg(a.base + (int)(r % a.H) / a.th) + a.min_disp;
  }
  const long long mine = min(warp * ROWS + g, a.rows - 1);
  const bool live = warp * ROWS + g < a.rows;
  const int my_off = __ldg(a.base + (int)(mine % a.H) / a.th) + a.min_disp;
  const int words = tile_words(NW);
  long long e = mine * a.W * i3dr::WARP + sl * DPL;
  // source column of (column 0, disparity DPL * sl)
  const int s_lane = -my_off - DPL * sl;

  float prev[DPL];
#pragma unroll
  for (int k = 0; k < DPL; ++k) prev[k] = 0.0f;

  census32_stage<NWT>(a, bufs, row, off, 0, lane);
  int cur = 0;
  for (int xt = 0; xt < a.W; xt += TW, cur ^= 1) {
    // the next tile's copies fly while this one is walked
    if (xt + TW < a.W) {
      census32_stage<NWT>(a, bufs + (cur ^ 1) * words, row, off, xt + TW,
                          lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const uint32_t* rowbuf = bufs + cur * words + g * NW * PLANE;
    const int n = min(TW, a.W - xt);
    if (n == TW) {
      Costs32<BLK> now, next;
      census32_costs<NWT>(rowbuf, NW, 0, sl, s_lane + xt, a.W, now);
#pragma unroll
      for (int xo = 0; xo < TW; xo += BLK) {
        if (xo + BLK < TW)
          census32_costs<NWT>(rowbuf, NW, xo + BLK, sl,
                              s_lane + xt + xo + BLK, a.W, next);
        census32_steps<S16, TAIL>(a, now, prev, e, live, sl);
        e += BLK * i3dr::WARP;
        now = next;
      }
    } else {
      int xo = 0;
      for (; xo + BLK <= n; xo += BLK) {
        Costs32<BLK> now;
        census32_costs<NWT>(rowbuf, NW, xo, sl, s_lane + xt + xo, a.W, now);
        census32_steps<S16, TAIL>(a, now, prev, e, live, sl);
        e += BLK * i3dr::WARP;
      }
      for (; xo < n; ++xo) {
        Costs32<1> now;
        census32_costs<NWT>(rowbuf, NW, xo, sl, s_lane + xt + xo, a.W, now);
        census32_steps<S16, TAIL>(a, now, prev, e, live, sl);
        e += i3dr::WARP;
      }
    }
    __syncwarp();  // the buffer is free for the tile after the next
  }
}

template <int NWT, bool S16>
__global__ void __launch_bounds__(THREADS)
    census32_kernel(Census32Args a) {
  extern __shared__ __align__(16) uint32_t i3dr_smem[];
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (warp * ROWS >= a.rows) return;  // uniform across the warp
  uint32_t* bufs =
      i3dr_smem + (threadIdx.x >> 5) * 2 * tile_words(NWT ? NWT : a.NW);
  if ((warp + 1) * ROWS <= a.rows)  // uniform across the warp
    census32_walk<NWT, S16, false>(a, bufs, warp, lane);
  else
    census32_walk<NWT, S16, true>(a, bufs, warp, lane);
}

// shared memory of a block of census32_kernel
size_t census32_shared(int NW) {
  return (size_t)C32_WARPS * 2 * tile_words(NW) * sizeof(uint32_t);
}

template <int NWT, bool S16>
int launch_census32(const Census32Args& a, cudaStream_t stream) {
  const size_t shared = census32_shared(a.NW);
  auto kernel = census32_kernel<NWT, S16>;
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const long long warps = (a.rows + ROWS - 1) / ROWS;
  const long long blocks = (warps + C32_WARPS - 1) / C32_WARPS;
  kernel<<<(unsigned)blocks, THREADS, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

namespace i3dr {

bool fused_census32_takes(int D, int NW) {
  return D == WARP && NW >= 1 && census32_shared(NW) <= MAX_SHARED;
}

int fused_census32(const void* cl, const void* cr, const void* base, int th,
                   void* C, void* S, int s_i16, int B, int H, int W, int NW,
                   int min_disp, float p1, float p2, cudaStream_t stream) {
  if (th < 1 || !fused_census32_takes(WARP, NW))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  Census32Args a;
  a.cl = (const uint32_t*)cl, a.cr = (const uint32_t*)cr;
  a.base = (const int*)base;
  a.C = (uint8_t*)C;
  a.Sf = s_i16 ? nullptr : (float*)S;
  a.Si = s_i16 ? (int16_t*)S : nullptr;
  a.plane = (long long)B * H * W, a.rows = (long long)B * H;
  a.H = H, a.W = W, a.NW = NW, a.th = th, a.min_disp = min_disp;
  a.p1 = p1, a.p2 = p2;
  if (NW == 3)
    return s_i16 ? launch_census32<3, true>(a, stream)
                 : launch_census32<3, false>(a, stream);
  return s_i16 ? launch_census32<0, true>(a, stream)
               : launch_census32<0, false>(a, stream);
}

}  // namespace i3dr
