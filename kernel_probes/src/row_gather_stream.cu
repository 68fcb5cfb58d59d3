// row_gather without the gather: a probe, not built into the package
// (kernel_probes/probe2.py). As csrc/row_gather.cu with each pixel reading
// src at its own column, so it moves the same bytes with no gather: the
// card's streaming rate for this layout. Not equal to the twin.
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
    return __ldg(src + ro + x) + (float)(i == 0x7fffffff);
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
