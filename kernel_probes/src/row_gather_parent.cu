// row_gather — per-pixel gather along image rows with a block-anchor clamp.
//
// Replaces: i3dr_stereo_tpu/ops/block_gather.py · _kernel (pallas_call at
// :109, entry block_shift_gather :73).
//
//   out[b, y, x] = src[b, y, clip(x - clip(idx, q - r, q + r), 0, W - 1)]
//   q = q[b, y / 8, x / 128]   (one anchor per 8-row x 128-column block)
//
// The anchor clamp is part of what the pyramid computes (the residual
// search window is centred on it), so it is kept; the TPU's rotated
// 3-lane window and its radius <= 63 limit are not: a GPU thread reads
// any column of its row.
//
// Design: one thread per output pixel; neighbouring threads read
// neighbouring (or nearby) source columns of one row, so the loads
// coalesce. What bounds it on the card: bytes — 12 bytes read + 4
// written per pixel, ~84 MB at 2560x2048, ~0.03 ms of HBM time; at that
// size the launch overhead is of the same order.
#include "common.cuh"

namespace {

__global__ void row_gather_kernel(const float* __restrict__ src,
                                  const int* __restrict__ idx,
                                  const int* __restrict__ q,
                                  float* __restrict__ out, long long total,
                                  int H, int W, int Hq, int Wq, int radius) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int x = (int)(t % W);
  const long long row = t / W;  // b * H + y
  const int y = (int)(row % H);
  const int b = (int)(row / H);
  const int qq = q[((long long)b * Hq + y / 8) * Wq + x / 128];
  const int e = min(max(idx[t], qq - radius), qq + radius);
  const int s = min(max(x - e, 0), W - 1);
  out[t] = src[row * W + s];
}

}  // namespace

extern "C" int i3dr_row_gather(const void* src, const void* idx,
                               const void* q, void* out, int B, int H, int W,
                               int Hq, int Wq, int radius, void* stream) {
  long long total = (long long)B * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  row_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int*)idx, (const int*)q, (float*)out, total, H,
      W, Hq, Wq, radius);
  return (int)cudaGetLastError();
}
