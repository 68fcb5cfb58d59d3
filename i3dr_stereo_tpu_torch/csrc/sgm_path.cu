// sgm_path — one SGM path direction over a uint8 cost volume.
//
// Replaces the scanline recurrences of the four flagship TPU kernels in
// i3dr_stereo_tpu/ops/sgm_fused_t.py: the forward-horizontal sweep of
// _fwd_kernel (pallas_call :187), _rev_kernel (:242), _vdown_kernel
// (:318, with its two diagonals in 8-path mode) and the bottom-up sweeps
// of _vup_wta_kernel (:423). One launch per direction (dy, dx):
//
//   L(p, d) = (c(p, d) + min(L(p-r, d), L(p-r, d±1) + P1, m + P2)) - m
//   m = min_k L(p-r, k),  c = 1e9 for the 255 sentinel, else the cost
//   out(p, d) = min(L(p, d), 10000)           (float32)
//
// A path enters the image (and re-enters at the edge column of a
// diagonal) with a zero carry, exactly the TPU's zeroed entering column.
//
// The cost is C (uint8, 255 = invalid) or, for the forward-horizontal
// direction of a census window with more than 254 bits, census_cost's
// int16 unclamped plane (negative = invalid): the TPU's _fwd_kernel recurs
// on the unclamped hamming distance.
//
// Design: one warp per scanline, lane = disparity (D = 32). The carry
// lives in a register; min_d is a 5-step shuffle butterfly; d-1 / d+1 are
// one __shfl_up/__shfl_down with 1e9 at the ends. Arithmetic is the
// reference's float32 sequence, rounded per operation (__fadd_rn /
// __fsub_rn) so the compiler cannot contract it differently.
//
// What bounds it on the card: latency, not bytes. Each step depends on
// the previous one, and a scanline of 2560 steps is walked by one warp,
// so the pass is as fast as one warp's dependent chain (shuffles + the
// cost load). The cost loads do not depend on the carry, so the kernel
// loads UNROLL steps of costs ahead of the recurrence to take the global
// load latency off the chain. At 2448x2048 a horizontal pass has only
// 2048 warps (~16 per SM of 132): occupancy is the next limit.
#include <climits>

#include "common.cuh"

namespace {

constexpr int UNROLL = 8;

template <typename T>
__device__ __forceinline__ float cost_of(int c);
template <>
__device__ __forceinline__ float cost_of<uint8_t>(int c) {
  return c == i3dr::SENTINEL ? i3dr::BIG : (float)c;
}
template <>
__device__ __forceinline__ float cost_of<int16_t>(int c) {
  return c < 0 ? i3dr::BIG : (float)c;
}

template <typename T>
__global__ void sgm_path_kernel(const T* __restrict__ C,
                                float* __restrict__ out, int B, int H, int W,
                                int dy, int dx, int n_lines, float p1,
                                float p2) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long long)B * n_lines) return;  // uniform across the warp
  const int b = (int)(warp / n_lines);
  const int line = (int)(warp % n_lines);

  // first pixel of the scanline: the pixel whose predecessor (y-dy, x-dx)
  // lies outside the image
  int y, x;
  if (dy == 0) {
    y = line;
    x = dx > 0 ? 0 : W - 1;
  } else if (dx == 0 || line < W) {
    x = line;
    y = dy > 0 ? 0 : H - 1;
  } else {
    const int j = line - W + 1;  // 1 .. H-1: entering through a side column
    y = dy > 0 ? j : H - 1 - j;
    x = dx > 0 ? 0 : W - 1;
  }
  const int ny = dy == 0 ? INT_MAX : (dy > 0 ? H - y : y + 1);
  const int nx = dx == 0 ? INT_MAX : (dx > 0 ? W - x : x + 1);
  const int len = min(ny, nx);

  const long long stride = ((long long)dy * W + dx) * i3dr::WARP;
  const long long base = (((long long)b * H + y) * W + x) * i3dr::WARP + lane;
  const T* cp = C + base;
  float* op = out + base;

  float prev = 0.0f;
  for (int s0 = 0; s0 < len; s0 += UNROLL) {
    int cb[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      cb[k] = (s0 + k < len) ? (int)cp[(long long)(s0 + k) * stride] : 0;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (s0 + k < len) {  // uniform across the warp
        const float c = cost_of<T>(cb[k]);
        const float m = i3dr::warp_min(prev);
        float up = __shfl_up_sync(i3dr::FULL, prev, 1);    // L(d-1)
        float dn = __shfl_down_sync(i3dr::FULL, prev, 1);  // L(d+1)
        if (lane == 0) up = i3dr::BIG;
        if (lane == i3dr::WARP - 1) dn = i3dr::BIG;
        const float best = fminf(fminf(prev, __fadd_rn(m, p2)),
                                 fminf(__fadd_rn(up, p1), __fadd_rn(dn, p1)));
        const float L = __fsub_rn(__fadd_rn(c, best), m);
        op[(long long)(s0 + k) * stride] = fminf(L, i3dr::CLAMP);
        prev = L;
      }
    }
  }
}

}  // namespace

// wide = 0: C is uint8; wide = 1: C is census_cost's int16 plane
extern "C" int i3dr_sgm_path(const void* C, int wide, void* out, int B, int H,
                             int W, int dy, int dx, float p1, float p2,
                             void* stream) {
  if ((dy == 0 && dx == 0) || dy < -1 || dy > 1 || dx < -1 || dx > 1)
    return (int)cudaErrorInvalidValue;
  const int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const long long threads_total = (long long)B * n_lines * i3dr::WARP;
  if (threads_total == 0) return 0;
  const int threads = 128;
  const long long blocks = (threads_total + threads - 1) / threads;
  if (wide)
    sgm_path_kernel<int16_t>
        <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int16_t*)C, (float*)out, B, H, W, dy, dx, n_lines, p1, p2);
  else
    sgm_path_kernel<uint8_t>
        <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)C, (float*)out, B, H, W, dy, dx, n_lines, p1, p2);
  return (int)cudaGetLastError();
}
