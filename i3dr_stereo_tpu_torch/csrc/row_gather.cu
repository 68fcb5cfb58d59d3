// row_gather — per-pixel gather along image rows with a block-anchor clamp.
//
// Replaces: i3dr_stereo_tpu/ops/block_gather.py · _kernel (pallas_call at
// :109, entry block_shift_gather :73) — E.
//
//   out[b, y, x] = src[b, y, clip(x - clip(idx, q - r, q + r), 0, W - 1)]
//   q = q[b, y / 8, x / 128]   (one anchor per 8-row x 128-column block)
//
// The anchor clamp is part of what the pyramid computes (the residual
// search window is centred on it), so it is kept; the TPU's rotated
// 3-lane window and its radius <= 63 limit are not: any radius is taken.
//
// What bounds it on the card: bytes, 12 a pixel (src, idx in; out), 63 MB
// at level 0's 2560x2048, 0.019 ms at 3.35 TB/s. The kernel before this
// one ran a thread a pixel with four 64-bit divisions and remainders to
// find its row and anchor, 4-byte accesses and an anchor load a thread:
// 0.0367 ms a call there (51 % of the bound; below).
//
// Design (row_gather_kernel): a block of 4 warps on one row (the row from
// blockIdx.x, so no division but one 32-bit one a warp for b and y), a
// warp on one 128-column anchor block: the anchor loaded once a warp, 4
// pixels a lane, idx read as int4 (issued before the anchor load) and out
// written as float4. The source is read through the read-only path: every
// source column of a warp lies in [x0 - q - r, x0 + 127 - q + r], so its
// gathers hit the lines its neighbours brought in. Staging that window
// in shared memory first (coalesced loads, a __syncwarp, then gathers
// there) was built and is not used: bit-equal, but 5 % slower. Rows whose
// width is not a multiple of 4 (or idx / out pointers that are not
// 16-byte aligned) and the last, partial anchor block of a row go pixel
// by pixel.
// Measured at level 0 through the C entry, in turns, 50 calls back to back
// between two events (kernel_probes/probe3.py at commit 1dd326f):
// 0.0234-0.0236 ms a call (80 % of the byte bound) against 0.0367 for the
// kernel before it, 0.0247-0.0248 for the staged variant and 0.0391-0.0392
// for torch.gather on a ready index. By events around one call: the C entry
// 0.032, the wrapper (block_gather.py) 0.056, torch.gather 0.049-0.050. The
// wrapper's host work (0.032-0.034 ms a call issued back to back) outlasts
// the kernel (NVIDIA H100 80GB HBM3, 700 W).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / i3dr::WARP;
constexpr int BW = 128;  // columns of an anchor block: a warp's columns

__global__ void __launch_bounds__(THREADS)
    row_gather_kernel(const float* __restrict__ src,
                      const int* __restrict__ idx,
                      const int* __restrict__ q, float* __restrict__ out,
                      int H, int W, int Hq, int Wq, int radius, bool vec) {
  const int lane = threadIdx.x & 31;
  const int wb = blockIdx.y * WARPS + (threadIdx.x >> 5);  // anchor block
  const int x0 = wb * BW;
  if (x0 >= W) return;  // uniform across the warp
  const int row = blockIdx.x;  // b * H + y
  const int b = row / H;
  const int y = row - b * H;
  const long long ro = (long long)row * W;
  const int n = min(BW, W - x0);
  const bool whole = vec && n == BW;
  int4 iv;
  if (whole)  // issued before the anchor load the gathers wait on
    iv = __ldg(reinterpret_cast<const int4*>(idx + ro + x0) + lane);
  const int qq = __ldg(q + ((long long)b * Hq + y / 8) * Wq + wb);
  const int lo = qq - radius, hi = qq + radius;
  auto fetch = [&](int x, int i) {
    const int e = min(max(i, lo), hi);
    return __ldg(src + ro + min(max(x - e, 0), W - 1));
  };
  if (whole) {
    const int x = x0 + 4 * lane;
    reinterpret_cast<float4*>(out + ro + x0)[lane] =
        make_float4(fetch(x, iv.x), fetch(x + 1, iv.y), fetch(x + 2, iv.z),
                    fetch(x + 3, iv.w));
  } else {
    for (int x = x0 + lane; x < x0 + n; x += i3dr::WARP)
      out[ro + x] = fetch(x, __ldg(idx + ro + x));
  }
}

}  // namespace

extern "C" int i3dr_row_gather(const void* src, const void* idx,
                               const void* q, void* out, int B, int H, int W,
                               int Hq, int Wq, int radius, void* stream) {
  const long long rows = (long long)B * H;
  if (rows * W == 0) return 0;
  if (rows > 0x7fffffffLL || Wq != (W + BW - 1) / BW)
    return (int)cudaErrorInvalidValue;
  const bool vec =
      W % 4 == 0 && (((uintptr_t)idx | (uintptr_t)out) & 15) == 0;
  const dim3 grid((unsigned)rows, (unsigned)((Wq + WARPS - 1) / WARPS));
  row_gather_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int*)idx, (const int*)q, (float*)out, H, W, Hq,
      Wq, radius, vec);
  return (int)cudaGetLastError();
}
