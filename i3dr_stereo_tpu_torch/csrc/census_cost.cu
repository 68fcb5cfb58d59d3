// census_cost — residual-window census hamming cost volume.
//
// Replaces: the cost half of i3dr_stereo_tpu/ops/sgm_fused_t.py ·
// _fwd_kernel (pl.pallas_call at :187, entry fused_census_fwd_t :152).
//
//   C[b, y, x, d] = min(popcount(cl[b,y,x,:] ^ cr[b,y,x-bpm-d,:]), 254)
//                   255  where the source column x-bpm-d is outside [0, W_real)
//                   0    on pad rows (y >= H_real) and pad columns (x >= W_real)
//
// With more than 254 census bits (a 17x17 window: 288) a distance can pass
// the uint8 clamp, and the TPU's forward-horizontal sweep recurs on the
// unclamped value (sgm_fused_t.py:138-141) while every other direction
// reads C. For that case the wrapper passes a second output Cw, int16
// (B, H, W, D): the unclamped distance, -1 for an invalid source column,
// 0 on padding; sgm_sweep reads it for direction (0, 1). Cw is null for
// narrower windows, where nothing extra is written.
//
// Layout (B, H, W, D), D contiguous: one thread per (pixel, d), so the 32
// threads of a warp write the 32 bytes of one pixel's costs.
//
// What bounds it on the card: bytes. Each pixel reads NW words of the
// left census (the same words for all d: one broadcast per warp) and a
// D-wide band of the right census row, which neighbouring pixels share
// (L1/L2 hits), and writes D bytes — at 2448x2048 (padded to 2560x2048),
// D = 32, NW = 3 about 170 MB written, ~0.05 ms of HBM time at 3.35 TB/s.
// The design keeps it a plain streaming pass; the TPU's reversed right
// plane and 8-aligned window slices are layout workarounds not needed here.
#include "common.cuh"

namespace {

__global__ void census_cost_kernel(const uint32_t* __restrict__ cl,
                                   const uint32_t* __restrict__ cr,
                                   uint8_t* __restrict__ C,
                                   int16_t* __restrict__ Cw, long long total,
                                   int H, int W, int NW, int D, int bpm,
                                   int H_real, int W_real) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  int d = (int)(t % D);
  long long p = t / D;       // pixel: (b * H + y) * W + x
  int x = (int)(p % W);
  long long row = p / W;     // b * H + y
  int y = (int)(row % H);
  int out = 0, wide = 0;
  if (y < H_real && x < W_real) {
    int src = x - bpm - d;
    if (src < 0 || src >= W_real) {
      out = i3dr::SENTINEL;
      wide = -1;
    } else {
      const uint32_t* a = cl + p * NW;
      const uint32_t* b = cr + (row * W + src) * NW;
      int ham = 0;
      for (int w = 0; w < NW; ++w) ham += __popc(a[w] ^ b[w]);
      out = min(ham, 254);
      wide = ham;
    }
  }
  C[t] = (uint8_t)out;
  if (Cw != nullptr) Cw[t] = (int16_t)wide;
}

}  // namespace

// Cw may be null (census words of at most 254 bits)
extern "C" int i3dr_census_cost(const void* cl, const void* cr, void* C,
                                void* Cw, int B, int H, int W, int NW, int D,
                                int bpm, int H_real, int W_real,
                                void* stream) {
  long long total = (long long)B * H * W * D;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  census_cost_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cl, (const uint32_t*)cr, (uint8_t*)C, (int16_t*)Cw,
      total, H, W, NW, D, bpm, H_real, W_real);
  return (int)cudaGetLastError();
}
