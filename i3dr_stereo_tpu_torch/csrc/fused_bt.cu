// fused_bt — fused_bt_fwd: the pixelwise Birchfield-Tomasi cost and the
// forward-horizontal SGM pass in one sweep, the uint8 cost volume C and
// the W->E path costs out together.
//
// Replaces i3dr_stereo_tpu/ops/fused_cost_sgm.py · _fused_bt_kernel
// (pallas_call :348, entry fused_bt_horizontal) — K.
//
// For pixel (y, x) and disparity index d the right source column is
//   s = x - base[y / th] - min_disp - d
// (base: one window base per tile of th rows), valid iff 0 <= s <= W-1;
//   cost = rint(2 * min(max(l - rhi, rlo - l, 0), max(r - lhi, llo - r, 0)))
// in doubled units, with lo/hi the min/max of a pixel and its two
// half-sample neighbours 0.5 * (v + v(x±1)), columns edge-replicated;
//   C = min(cost, 254) where valid, else 255;
//   L = the SGM recurrence (sgm_step.cuh) along x on the UNCLAMPED cost
//       (1e9 where invalid), zero carry at x = 0, at the exact D (1-512);
//   S = L as float32, or (int16 mode) trunc(min(L, 10000)); the carry
//       stays the unclamped float32 either way.
// Any base is tested against the bounds.
//
// What held the kernel before this one (one warp a row, 4 disparities a
// lane at D = 128, each pairing's 3 right pixels and their bounds loaded
// and recomputed from global memory, 2 columns of cost ahead of the
// recurrence): its cost loads, not bytes. At 1x1024x1280x128 it took
// 1.046 ms with int16 S against a byte bound of 0.153 ms (0.514 GB), with
// its costs replaced by a constant 0.387, with its stores cut 0.94-0.95
// (NVIDIA H100 80GB HBM3, 700 W). 1024 rows give ~8 warps an SM, so each
// warp has to find its own independent work.
//
// Design (bt_fwd_kernel), one warp a row, K = 4 consecutive disparities a
// lane at D = 128 (the smallest K with 32 K >= D otherwise):
// - No lane loads an image pixel from global memory in the walk. A warp
//   stages a tile of TW = 32 columns of its row: the left pixels and the
//   right pixels of the tile and its 32 K - 1 columns to the left, each
//   with one more on either side, by asynchronous 4-byte copies, coalesced
//   along the row and edge-replicated at the image's ends. The next tile's
//   copies fly while this one is walked.
// - Bounds once: each staged column's (v, lo, hi) is computed once a tile
//   into three planes, not once a pairing.
// - A block of 8 columns: a lane reads its window of the right planes
//   (8 + K - 1 consecutive columns, as 16-byte vectors) and the 8 left
//   columns, computes the 8 K costs (validity of the source column by one
//   unsigned compare) ahead of the recurrence, then walks the 8 steps with
//   no test between them; within a tile the next block's costs are
//   computed before this block's steps, so the two overlap. The columns
//   left over (W % 8) go one by one through the same code.
// - The minimum over the warp is the hardware reduction (common.cuh).
// - Stores as before: a lane writes K bytes of C and K values of S a
//   column, coalesced along the row (16-byte vectors at D = 128).
// Measured at 1x1024x1280x128, in turns with the kernel before it on the
// C entry: 0.386 ms with int16 S (1.046 before), 0.404 with float32
// (1.016); with its costs a constant 0.284-0.288, with neither costs nor
// stores 0.272-0.275, so the recurrence holds it now; the five-shuffle
// minimum took 0.423, tiles of 64 columns 0.927, blocks of 4 columns
// 0.431-0.437 (NVIDIA H100 80GB HBM3, 700 W).
#include <cuda_pipeline.h>

#include "common.cuh"
#include "sgm_step.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / i3dr::WARP;
constexpr int TW = 32;  // left columns a tile

// columns a block of the walk: two blocks of costs live in registers
__host__ __device__ constexpr int bt_blk(int K) {
  return K <= 4 ? 8 : (K <= 8 ? 4 : 2);
}
// right columns a tile's planes hold: the tile and the 32 K - 1 to its left
__host__ __device__ constexpr int bt_rp(int K) { return TW + i3dr::WARP * K; }
// the widest vector (1, 2 or 4 floats) n is a multiple of
__host__ __device__ constexpr int vec_of(int n) {
  return n % 4 == 0 ? 4 : (n % 2 == 0 ? 2 : 1);
}
__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// floats of one warp's shared memory: the left planes (v, lo, hi), the
// right planes, the staged left pixels (TW + 2) and right pixels (RP + 2)
__host__ __device__ constexpr int bt_warp_floats(int K) {
  return 3 * TW + 3 * bt_rp(K) + round_up(TW + 2, 4) +
         round_up(bt_rp(K) + 2, 4);
}

struct BtArgs {
  const float* left;  // (B, H, W) prefiltered images
  const float* right;
  const int* base;
  uint8_t* C;
  float* Sf;
  int16_t* Si;
  long long rows;  // B * H
  int H, W, D, th, min_disp;
  float p1, p2;
};

// the costs of N columns of one lane: float for the recurrence (1e9 where
// the source column is outside the image) and the K bytes of C a column
template <int K, int N>
struct BtCosts {
  float c[N][K];
  uint32_t cb[N][(K + 3) / 4];
};

// V = 1, 2 or 4 floats from p (V * 4 bytes aligned) as one access
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

__device__ __forceinline__ float half_sample(float v, float nb) {
  return __fmul_rn(0.5f, __fadd_rn(v, nb));
}

// Start the copies of the tile at left column xt: the left pixels of
// columns xt - 1 .. xt + TW and the right pixels of R0 - 1 .. R0 + RP,
// each column clamped into the row (the edge replication of the bounds).
template <int K>
__device__ __forceinline__ void bt_stage(const BtArgs& a, float* raw_l,
                                         float* raw_r, long long row_off,
                                         int xt, int R0, int lane) {
  constexpr int RP = bt_rp(K);
  const float* l = a.left + row_off;
  const float* r = a.right + row_off;
  const int last = a.W - 1;
  for (int j = lane; j < TW + 2; j += i3dr::WARP)
    __pipeline_memcpy_async(raw_l + j, l + min(max(xt - 1 + j, 0), last), 4);
  for (int j = lane; j < RP + 2; j += i3dr::WARP)
    __pipeline_memcpy_async(raw_r + j, r + min(max(R0 - 1 + j, 0), last), 4);
  __pipeline_commit();
}

// Each staged column's (v, lo, hi), once: planes of TW left and RP right
// columns. The operations and their order are those of the twin.
template <int K>
__device__ __forceinline__ void bt_bounds(const float* raw_l,
                                          const float* raw_r, float* pl,
                                          float* pr, int lane) {
  constexpr int RP = bt_rp(K);
  for (int j = lane; j < TW; j += i3dr::WARP) {
    const float v = raw_l[j + 1];
    const float la = half_sample(v, raw_l[j]);
    const float lb = half_sample(v, raw_l[j + 2]);
    pl[j] = v;
    pl[TW + j] = fminf(fminf(la, lb), v);
    pl[2 * TW + j] = fmaxf(fmaxf(la, lb), v);
  }
  for (int j = lane; j < RP; j += i3dr::WARP) {
    const float v = raw_r[j + 1];
    const float ra = half_sample(v, raw_r[j + 2]);
    const float rb = half_sample(v, raw_r[j]);
    pr[j] = v;
    pr[RP + j] = fminf(fminf(ra, rb), v);
    pr[2 * RP + j] = fmaxf(fmaxf(ra, rb), v);
  }
}

// The costs of N columns from tile column xo (a multiple of N) for the
// lane's K disparities. s0 is the source column of (tile column 0,
// disparity K * lane): that of (xo + u, K * lane + k) is s0 + xo + u - k,
// and it sits at column xo + u + 32 K - 1 - K * lane - k of the right
// planes.
template <int K, int N>
__device__ __forceinline__ void bt_costs(const float* pl, const float* pr,
                                         int xo, int lane, int s0, int W,
                                         BtCosts<K, N>& out) {
  constexpr int RP = bt_rp(K);
  // the right window: N + K - 1 columns from that of u - k = -(K - 1), as
  // whole vectors (xo and K * (31 - lane) are multiples of V)
  constexpr int V = N == 1 ? 1 : (vec_of(K) < vec_of(N) ? vec_of(K)
                                                         : vec_of(N));
  constexpr int NR = round_up(N + K - 1, V);
  constexpr int VL = vec_of(N);
  const int j0 = xo + K * (i3dr::WARP - 1 - lane);
  float rv[NR], rlo[NR], rhi[NR], lv[N], llo[N], lhi[N];
#pragma unroll
  for (int i = 0; i < NR; i += V) {
    load_vec<V>(pr + j0 + i, rv + i);
    load_vec<V>(pr + RP + j0 + i, rlo + i);
    load_vec<V>(pr + 2 * RP + j0 + i, rhi + i);
  }
#pragma unroll
  for (int u = 0; u < N; u += VL) {
    load_vec<VL>(pl + xo + u, lv + u);
    load_vec<VL>(pl + TW + xo + u, llo + u);
    load_vec<VL>(pl + 2 * TW + xo + u, lhi + u);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
#pragma unroll
    for (int q = 0; q < (K + 3) / 4; ++q) out.cb[u][q] = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = u - k + K - 1;
      const float dl = fmaxf(
          fmaxf(__fsub_rn(lv[u], rhi[i]), __fsub_rn(rlo[i], lv[u])), 0.0f);
      const float dr = fmaxf(
          fmaxf(__fsub_rn(rv[i], lhi[u]), __fsub_rn(llo[u], rv[i])), 0.0f);
      // doubled units, rounded half to even as jnp.round
      const float cost = rintf(__fmul_rn(2.0f, fminf(dl, dr)));
      const bool ok = (unsigned)(s0 + xo + u - k) < (unsigned)W;
      out.c[u][k] = ok ? cost : i3dr::BIG;
      out.cb[u][k / 4] |=
          (uint32_t)(ok ? (int)fminf(cost, 254.0f) : i3dr::SENTINEL)
          << (8 * (k % 4));
    }
  }
}

// N steps of the recurrence from computed costs and their stores; e is the
// element offset of (row, column, K * lane), D elements a column. VEC:
// D = 32 K = 128, every lane stores whole vectors.
template <int K, int N, bool S16, bool VEC>
__device__ __forceinline__ void bt_steps(const BtArgs& a,
                                         const BtCosts<K, N>& in,
                                         float (&prev)[K], long long e,
                                         int lane, int last) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float L[K];
    i3dr::sgm_step<K>(prev, in.c[u], L, lane, last, a.p1, a.p2);
#pragma unroll
    for (int k = 0; k < K; ++k) prev[k] = L[k];
    const long long o = e + (long long)u * a.D;
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        reinterpret_cast<uint32_t*>(a.C + o)[q] = in.cb[u][q];
        if constexpr (S16) {
          short4 v;  // truncates, as astype
          v.x = (short)(int)fminf(L[4 * q], i3dr::CLAMP);
          v.y = (short)(int)fminf(L[4 * q + 1], i3dr::CLAMP);
          v.z = (short)(int)fminf(L[4 * q + 2], i3dr::CLAMP);
          v.w = (short)(int)fminf(L[4 * q + 3], i3dr::CLAMP);
          reinterpret_cast<short4*>(a.Si + o)[q] = v;
        } else {
          reinterpret_cast<float4*>(a.Sf + o)[q] = make_float4(
              L[4 * q], L[4 * q + 1], L[4 * q + 2], L[4 * q + 3]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k <= last) {
          a.C[o + k] = (uint8_t)(in.cb[u][k / 4] >> (8 * (k % 4)));
          if constexpr (S16)
            a.Si[o + k] = (int16_t)(int)fminf(L[k], i3dr::CLAMP);
          else
            a.Sf[o + k] = L[k];
        }
      }
    }
  }
}

template <int K, bool S16, bool VEC>
__global__ void __launch_bounds__(THREADS) bt_fwd_kernel(BtArgs a) {
  constexpr int RP = bt_rp(K);
  constexpr int BLK = bt_blk(K);
  __shared__ __align__(16) float smem[WARPS * bt_warp_floats(K)];
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // uniform across the warp
  float* pl = smem + (threadIdx.x >> 5) * bt_warp_floats(K);
  float* pr = pl + 3 * TW;
  float* raw_l = pr + 3 * RP;
  float* raw_r = raw_l + round_up(TW + 2, 4);

  const int W = a.W;
  const long long row_off = row * W;
  const int off = __ldg(a.base + (int)(row % a.H) / a.th) + a.min_disp;
  const int d0 = K * lane;
  const int last = a.D - 1 - d0;  // see sgm_step.cuh
  // the source column of (tile column 0, disparity d0), less xt
  const int s_lane = -off - d0;
  // the right column of plane column 0, less xt
  const int r_lane = -off - (i3dr::WARP * K - 1);
  long long e = row_off * a.D + d0;

  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) prev[k] = k <= last ? 0.0f : CUDART_INF_F;

  bt_stage<K>(a, raw_l, raw_r, row_off, 0, r_lane, lane);
  __pipeline_wait_prior(0);
  __syncwarp();
  bt_bounds<K>(raw_l, raw_r, pl, pr, lane);
  __syncwarp();
  for (int xt = 0; xt < W; xt += TW) {
    const bool more = xt + TW < W;
    // the next tile's copies fly while this one is walked (the staged
    // pixels of this one were read into the planes before the barrier)
    if (more) bt_stage<K>(a, raw_l, raw_r, row_off, xt + TW, xt + TW + r_lane,
                          lane);
    const int s0 = xt + s_lane;
    const int n = min(TW, W - xt);
    if (n == TW) {
      BtCosts<K, BLK> now, next;
      bt_costs<K, BLK>(pl, pr, 0, lane, s0, W, now);
#pragma unroll
      for (int xo = 0; xo < TW; xo += BLK) {
        if (xo + BLK < TW)
          bt_costs<K, BLK>(pl, pr, xo + BLK, lane, s0, W, next);
        bt_steps<K, BLK, S16, VEC>(a, now, prev, e, lane, last);
        e += (long long)BLK * a.D;
        now = next;
      }
    } else {
      int xo = 0;
      for (; xo + BLK <= n; xo += BLK) {
        BtCosts<K, BLK> now;
        bt_costs<K, BLK>(pl, pr, xo, lane, s0, W, now);
        bt_steps<K, BLK, S16, VEC>(a, now, prev, e, lane, last);
        e += (long long)BLK * a.D;
      }
      for (; xo < n; ++xo) {
        BtCosts<K, 1> now;
        bt_costs<K, 1>(pl, pr, xo, lane, s0, W, now);
        bt_steps<K, 1, S16, VEC>(a, now, prev, e, lane, last);
        e += a.D;
      }
    }
    if (more) {
      __pipeline_wait_prior(0);
      __syncwarp();  // the copies landed and no lane reads the planes
      bt_bounds<K>(raw_l, raw_r, pl, pr, lane);
      __syncwarp();
    }
  }
}

template <int K, bool S16>
int launch_bt(const BtArgs& a, cudaStream_t stream) {
  const long long blocks = (a.rows + WARPS - 1) / WARPS;
  // whole 16-byte stores at the main path's D = 128 only: the wider K
  // run on no main path, and their vector instances spill
  if constexpr (K == 4) {
    if (a.D == i3dr::WARP * K) {
      bt_fwd_kernel<K, S16, true><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
      return (int)cudaGetLastError();
    }
  }
  bt_fwd_kernel<K, S16, false><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool S16>
int launch_bt_k(const BtArgs& a, cudaStream_t stream) {
  switch (i3dr::lanes_k(a.D)) {
    case 1: return launch_bt<1, S16>(a, stream);
    case 2: return launch_bt<2, S16>(a, stream);
    case 4: return launch_bt<4, S16>(a, stream);
    case 8: return launch_bt<8, S16>(a, stream);
    case 12: return launch_bt<12, S16>(a, stream);
    case 16: return launch_bt<16, S16>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// left, right: float32 (B, H, W) prefiltered images; base: int32, one
// entry per tile of th rows (ceil(H / th) entries); C: uint8 (B, H, W, D);
// S: float32 (s_i16 = 0) or int16 (s_i16 = 1) (B, H, W, D); D from 1 to
// 512.
extern "C" int i3dr_fused_bt_fwd(const void* left, const void* right,
                                 const void* base, int th, void* C, void* S,
                                 int s_i16, int B, int H, int W, int D,
                                 int min_disp, float p1, float p2,
                                 void* stream) {
  if (th < 1 || i3dr::lanes_k(D) == 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  BtArgs a;
  a.left = (const float*)left, a.right = (const float*)right;
  a.base = (const int*)base;
  a.C = (uint8_t*)C;
  a.Sf = s_i16 ? nullptr : (float*)S;
  a.Si = s_i16 ? (int16_t*)S : nullptr;
  a.rows = (long long)B * H;
  a.H = H, a.W = W, a.D = D, a.th = th, a.min_disp = min_disp;
  a.p1 = p1, a.p2 = p2;
  return s_i16 ? launch_bt_k<true>(a, (cudaStream_t)stream)
               : launch_bt_k<false>(a, (cudaStream_t)stream);
}
