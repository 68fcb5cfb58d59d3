// remap — bicubic (4x4) or bilinear (2x2) rectification remap.
//
// Replaces: i3dr_stereo_tpu/ops/rectify_pallas.py · _kernel (pl.pallas_call
// at :279, entry remap_banded), which equals the reference's gather
// formulation i3dr_stereo_tpu/ops/rectify.py · _remap_gather_impl.
//
//   p = padded source (edge-replicated by `pad`), f = flat_idx[y, x]
//   out[b, y, x] = sum_j wy[y,x,j] * (sum_i wx[y,x,i] * p[b, f + j*Wp + i])
//
// summed in the reference's order — row_acc = row_acc + tap * wx[i], then
// out = out + row_acc * wy[j] — with __fmul_rn / __fadd_rn, so no FMA
// contraction changes a rounding and the result equals the plain torch twin
// bit for bit. The padded image is never materialised: a padded coordinate
// clamped into [0, src) reads the same replicated border pixel. uint8 and
// float32 sources are read in their own type and converted in registers
// (u8 -> f32 is exact).
//
// Design: one thread per output pixel, looping over the batch, so the map
// (flat_idx 4 B + wx 16 B + wy 16 B for cubic) is read once per pixel
// whatever B is. What bounds it on the card: bytes of the map. At
// 2448x2048 cubic: 36 B of map + ~1-4 B of source (the taps of
// neighbouring pixels overlap, so they hit L1/L2) + 4 B of output per
// pixel, ~0.2 GB, ~0.06 ms at 3.35 TB/s. The TPU's anchors, channel bands
// and mosaic DMA were gather workarounds; the GPU gathers freely.
#include "common.cuh"

namespace {

__device__ __forceinline__ float load_f(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load_f(const float* p) { return *p; }

template <typename T, int TAPS>
__global__ void remap_kernel(const T* __restrict__ src,
                             const int* __restrict__ flat_idx,
                             const float* __restrict__ wx,
                             const float* __restrict__ wy,
                             float* __restrict__ out, int B, int n_pix,
                             int src_h, int src_w, int pad) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const int Wp = src_w + 2 * pad;
  const int f = flat_idx[pix];
  const int by = f / Wp;
  const int bx = f - by * Wp;
  int cols[TAPS], rows[TAPS];
  float wxs[TAPS], wys[TAPS];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    cols[i] = min(max(bx + i - pad, 0), src_w - 1);
    rows[i] = min(max(by + i - pad, 0), src_h - 1);
    wxs[i] = wx[(long long)pix * TAPS + i];
    wys[i] = wy[(long long)pix * TAPS + i];
  }
  const long long plane = (long long)src_h * src_w;
  for (int b = 0; b < B; ++b) {
    const T* s = src + b * plane;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const T* row = s + (long long)rows[j] * src_w;
      float row_acc = 0.0f;
#pragma unroll
      for (int i = 0; i < TAPS; ++i)
        row_acc = __fadd_rn(row_acc, __fmul_rn(load_f(row + cols[i]), wxs[i]));
      acc = __fadd_rn(acc, __fmul_rn(row_acc, wys[j]));
    }
    out[(long long)b * n_pix + pix] = acc;
  }
}

template <typename T>
int launch(const void* src, const void* flat_idx, const void* wx,
           const void* wy, void* out, int B, int n_pix, int src_h, int src_w,
           int pad, int taps, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n_pix + threads - 1) / threads;
  if (taps == 4)
    remap_kernel<T, 4><<<blocks, threads, 0, stream>>>(
        (const T*)src, (const int*)flat_idx, (const float*)wx,
        (const float*)wy, (float*)out, B, n_pix, src_h, src_w, pad);
  else if (taps == 2)
    remap_kernel<T, 2><<<blocks, threads, 0, stream>>>(
        (const T*)src, (const int*)flat_idx, (const float*)wx,
        (const float*)wy, (float*)out, B, n_pix, src_h, src_w, pad);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// src: (B, src_h, src_w) uint8 (src_u8 = 1) or float32; flat_idx (H, W)
// int32; wx, wy (H, W, taps) float32; out (B, H, W) float32.
extern "C" int i3dr_remap(const void* src, int src_u8, const void* flat_idx,
                          const void* wx, const void* wy, void* out, int B,
                          int H, int W, int src_h, int src_w, int pad,
                          int taps, void* stream) {
  const int n_pix = H * W;
  if (n_pix == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return src_u8 ? launch<uint8_t>(src, flat_idx, wx, wy, out, B, n_pix, src_h,
                                  src_w, pad, taps, s)
                : launch<float>(src, flat_idx, wx, wy, out, B, n_pix, src_h,
                                src_w, pad, taps, s);
}
