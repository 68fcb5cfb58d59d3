// census_cost — residual-window census hamming cost volume.
//
// Replaces: the cost half of i3dr_stereo_tpu/ops/sgm_fused_t.py ·
// _fwd_kernel (pl.pallas_call at :187, entry fused_census_fwd_t :152).
//
//   C[b, y, x, d] = 0    on pad rows (y >= H_real) and pad columns
//                        (x >= W_real), whatever the source column; else
//                   255  where the source column x-bpm-d is outside
//                        [0, W_real); else
//                   min(popcount(cl[b,y,x,:] ^ cr[b,y,x-bpm-d,:]), 254)
//
// With more than 254 census bits (a 17x17 window: 288) a distance can pass
// the uint8 clamp, and the TPU's forward-horizontal sweep recurs on the
// unclamped value (sgm_fused_t.py:138-141) while every other direction
// reads C. For that case the wrapper passes a second output Cw, int16
// (B, H, W, D): the unclamped distance, -1 for an invalid source column,
// 0 on padding; sgm_sweep reads it for direction (0, 1). Cw is null for
// narrower windows, where nothing extra is written.
//
// Layout (B, H, W, D), D contiguous. Any bpm, NW >= 1 and D from 1 to 4096
// (a block's 256 threads at 16 disparities each), as long as one pixel's
// window of D columns fits a block's shared memory.
//
// What bounds it on the card: its popcounts, then bytes. The card retires
// 16 popcounts a clock an SM, a sixteenth of its float32 rate (4.1 T/s
// measured by popc_probe.cu). At 2560x2048, D = 32, NW = 3 a popcount a
// word and pairing is 503 M of them, 0.12 ms, against 0.09 ms for the 0.29
// GB it must move (both census planes in, C out).
//
// Design.
// - A block is a strip of `tile` pixels of one image row; rows come from
//   grid.x (B * H may pass 65535) and strips from grid.y: no 64-bit
//   division, one 32-bit remainder a block.
// - The strip's window of the right census row (tile + D - 1 columns from
//   x0 - bpm - (D - 1)) is staged once in shared memory by coalesced
//   loads, zero where the column is outside [0, W_real), so the inner loop
//   is xor, popcount, add on shared memory. The words of one column stay
//   together (stride NW words): a warp reads 32 consecutive columns, free
//   of bank conflicts for odd NW (1, 3 and 9: the 5x5, 9x9, 17x17 windows).
// - A thread owns one pixel and a run of 16 disparities: the left words
//   sit in registers (loaded before the staging, so both latencies
//   overlap) and the 16 costs leave as one 16-byte store, so a warp's
//   store covers 512 consecutive bytes (Cw: two such stores a thread).
//   Only the threads at the image's edges test source columns.
// - With three words (9x9, the main path) a carry-save adder takes the
//   three xors to two popcounts a pairing: 335 M at level 0, 0.08 ms.
// - D that is no multiple of 16 takes the same kernel with byte stores.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 16;  // disparities a thread
constexpr int MAX_SHARED = 227 * 1024;

// VEC: D is a multiple of RUN, so every run is whole and 16-byte aligned.
// NWT: the number of census words (3, the 9x9 window of the main path), or
// 0 for the runtime value `nw`.
template <int NWT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    census_cost_kernel(const uint32_t* __restrict__ cl,
                       const uint32_t* __restrict__ cr,
                       uint8_t* __restrict__ C, int16_t* __restrict__ Cw,
                       int H, int W, int nw, int D, int bpm, int H_real,
                       int W_real, int tile, int runs) {
  extern __shared__ __align__(16) uint32_t i3dr_smem[];
  uint32_t* right = i3dr_smem;  // [column][word], tile + D - 1 columns
  const int NW = NWT ? NWT : nw;
  const long long row = blockIdx.x;  // b * H + y
  const int y = (int)(blockIdx.x % (unsigned)H);
  const int x0 = (int)blockIdx.y * tile;
  const int px = (int)threadIdx.x / runs;
  const int d0 = ((int)threadIdx.x - px * runs) * RUN;
  const int x = x0 + px;
  const bool mine = px < tile && x < W;
  const int kn = VEC ? RUN : min(RUN, D - d0);  // disparities of this run
  const int w_in = min(W_real, W);
  const bool pad_row = y >= H_real;  // same for the block

  // a real pixel's own three words, asked for before the strip is staged
  // so that the two waits overlap
  const bool real = !pad_row && mine && x < w_in;
  const uint32_t* l = cl + (row * W + x) * NW;
  uint32_t a[3] = {0u, 0u, 0u};
  if (NWT == 3 && real) {
#pragma unroll
    for (int w = 0; w < 3; ++w) a[w] = __ldg(l + w);
  }

  if (!pad_row) {
    const int c0 = x0 - bpm - (D - 1);
    const int n = (tile + D - 1) * NW;
    const uint32_t* src = cr + row * W * NW;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int c = c0 + i / NW;
      right[i] = (c >= 0 && c < w_in)
                     ? __ldg(src + ((long long)c * NW + i % NW))
                     : 0u;
    }
    __syncthreads();
  }
  if (!mine) return;

  int cost[RUN], wide[RUN];
#pragma unroll
  for (int k = 0; k < RUN; ++k) cost[k] = wide[k] = 0;

  if (real) {
    // word w of disparity d0 + k: s[w - k * NW]
    const uint32_t* s = right + (px + D - 1 - d0) * NW;
    int ham[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) ham[k] = 0;
    if constexpr (NWT == 3) {
      // three words through a carry-save adder: popcount(x0) + popcount(x1)
      // + popcount(x2) = popcount(x0 ^ x1 ^ x2) + 2 popcount(majority), two
      // popcounts a pairing instead of three
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        if (VEC || k < kn) {
          const uint32_t x0 = a[0] ^ s[-k * 3], x1 = a[1] ^ s[1 - k * 3],
                         x2 = a[2] ^ s[2 - k * 3];
          ham[k] = __popc(x0 ^ x1 ^ x2) +
                   2 * __popc((x0 & x1) | (x2 & (x0 ^ x1)));
        }
      }
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t aw = __ldg(l + w);
#pragma unroll
        for (int k = 0; k < RUN; ++k)
          if (VEC || k < kn) ham[k] += __popc(aw ^ s[w - k * NW]);
      }
    }
    const int hi = x - bpm - d0;  // the source column of k = 0
    if (hi - (RUN - 1) >= 0 && hi < w_in) {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        cost[k] = min(ham[k], 254);
        wide[k] = ham[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        const bool ok = (unsigned)(hi - k) < (unsigned)w_in;
        cost[k] = ok ? min(ham[k], 254) : i3dr::SENTINEL;
        wide[k] = ok ? ham[k] : -1;
      }
    }
  }

  const long long o = (row * W + x) * D + d0;
  if (VEC) {
    uint32_t v[RUN / 4];
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q)
      v[q] = (uint32_t)cost[4 * q] | (uint32_t)cost[4 * q + 1] << 8 |
             (uint32_t)cost[4 * q + 2] << 16 | (uint32_t)cost[4 * q + 3] << 24;
    *reinterpret_cast<uint4*>(C + o) = make_uint4(v[0], v[1], v[2], v[3]);
    if (Cw != nullptr) {
      uint32_t h[RUN / 2];
#pragma unroll
      for (int q = 0; q < RUN / 2; ++q)
        h[q] = ((uint32_t)wide[2 * q] & 0xffffu) |
               (uint32_t)wide[2 * q + 1] << 16;
      uint4* out = reinterpret_cast<uint4*>(Cw + o);
      out[0] = make_uint4(h[0], h[1], h[2], h[3]);
      out[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k < kn) {
        C[o + k] = (uint8_t)cost[k];
        if (Cw != nullptr) Cw[o + k] = (int16_t)wide[k];
      }
    }
  }
}

template <int NWT, bool VEC>
int launch(const void* cl, const void* cr, void* C, void* Cw, int B, int H,
           int W, int NW, int D, int bpm, int H_real, int W_real,
           cudaStream_t stream) {
  const int runs = (D + RUN - 1) / RUN;
  if (runs > THREADS) return (int)cudaErrorInvalidValue;
  const int tile = THREADS / runs;
  const long long strips = ((long long)W + tile - 1) / tile;
  const size_t shared = (size_t)(tile + D - 1) * NW * sizeof(uint32_t);
  if (strips > 65535 || shared > MAX_SHARED)
    return (int)cudaErrorInvalidValue;
  auto kernel = census_cost_kernel<NWT, VEC>;
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((long long)B * H), (unsigned)strips);
  kernel<<<grid, THREADS, shared, stream>>>(
      (const uint32_t*)cl, (const uint32_t*)cr, (uint8_t*)C, (int16_t*)Cw, H,
      W, NW, D, bpm, H_real, W_real, tile, runs);
  return (int)cudaGetLastError();
}

}  // namespace

// cl, cr: uint32 (B, H, W, NW); C: uint8 (B, H, W, D); Cw: int16 (B, H, W,
// D) or null (census words of at most 254 bits)
extern "C" int i3dr_census_cost(const void* cl, const void* cr, void* C,
                                void* Cw, int B, int H, int W, int NW, int D,
                                int bpm, int H_real, int W_real,
                                void* stream) {
  if (NW < 1 || D < 1 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  // the main path's three words (9x9) unrolled, any other number at run time
#define I3DR_CENSUS_COST_LAUNCH(NWT, VEC)                                   \
  launch<NWT, VEC>(cl, cr, C, Cw, B, H, W, NW, D, bpm, H_real, W_real,      \
                   (cudaStream_t)stream)
  if (D % RUN == 0)
    return NW == 3 ? I3DR_CENSUS_COST_LAUNCH(3, true)
                   : I3DR_CENSUS_COST_LAUNCH(0, true);
  return NW == 3 ? I3DR_CENSUS_COST_LAUNCH(3, false)
                 : I3DR_CENSUS_COST_LAUNCH(0, false);
#undef I3DR_CENSUS_COST_LAUNCH
}
