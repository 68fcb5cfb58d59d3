// remap — bicubic (4x4) or bilinear (2x2) rectification remap of one
// camera, or of both cameras of a rig in one launch.
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
// What bounds it on the card: bytes. At 2448x2048 cubic uint8: 4 B of
// flat_idx + 32 B of weights + ~1 B of source (the taps of neighbouring
// pixels overlap, so they hit L1/L2) + 4 B of output a pixel, 0.206 GB,
// 0.061 ms at 3.35 TB/s. The TPU's anchors, channel bands and mosaic DMA
// were gather workarounds; the GPU gathers freely.
//
// What held the kernel before this one (a thread a pixel, eight scalar
// weight loads, sixteen byte loads behind clamps, a launch a camera), in
// turns through its C entry, 50 calls back to back (kernel_probes/probe4.py
// at commit 1dd326f; NVIDIA H100 80GB HBM3, 700 W): 0.0975 ms as it was,
// 0.062 with its weights constants, 0.068 with its source loads cut, 0.0985
// with no division for the base. The map streams past the source's taps:
// with the map alone it runs at ~3 TB/s, with the taps alone it is held by
// their latency, and together the streamed map pushes the taps' lines out
// of the caches.
//
// Design: a pixel's weights are interleaved in the map (wx then wy) and
// read as 16-byte vectors, two for cubic and one for linear; every map load
// and the store are streaming (__ldcs / __stcs: evict first), so the
// source's lines stay in L1 / L2 for the neighbouring pixels' taps, which
// go through the read-only path. That took the kernel to 0.071-0.074 ms
// (plain loads and store: 0.089; streaming loads, plain store: 0.080). A
// block covers THREADS * PX columns of one row (the row from blockIdx.y), a
// thread PX = 2 pixels THREADS apart with both pixels' map loads issued
// first (1 and 4 pixels: 0.074-0.077). blockIdx.z is the camera, so a rig's
// two images are one launch. Tried and not kept (probe4.py at 1dd326f): a
// uint8 stencil row as two aligned words cut by a byte permute (slower than
// four byte loads), rows of a block with the next row's map loaded ahead
// (more registers, no gain with streaming loads), register bounds for more
// resident blocks (spills, 2-4x slower), and a base packed as (row << 16) |
// column in place of the division.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int PX = 2;  // output pixels of a thread, THREADS columns apart

struct Cam {
  const void* src;
  const int* flat;
  const float* weights;
  float* out;
};

// the map is read once: streaming loads (evict first), so the source's
// lines stay in the caches for the neighbouring pixels' taps
template <int TAPS>
__device__ __forceinline__ void load_weights(const float* w, long long pix,
                                             float (&wx)[TAPS],
                                             float (&wy)[TAPS]) {
  const float4* p = reinterpret_cast<const float4*>(w) + pix * (TAPS / 2);
  if constexpr (TAPS == 4) {
    const float4 a = __ldcs(p), b = __ldcs(p + 1);
    wx[0] = a.x, wx[1] = a.y, wx[2] = a.z, wx[3] = a.w;
    wy[0] = b.x, wy[1] = b.y, wy[2] = b.z, wy[3] = b.w;
  } else {
    const float4 a = __ldcs(p);
    wx[0] = a.x, wx[1] = a.y, wy[0] = a.z, wy[1] = a.w;
  }
}

template <typename T, int TAPS>
__global__ void __launch_bounds__(THREADS)
    remap_kernel(Cam c0, Cam c1, int B, int H, int W, int src_h, int src_w,
                 int pad) {
  const Cam cam = blockIdx.z ? c1 : c0;
  const int y = blockIdx.y;
  const int Wp = src_w + 2 * pad;
  const long long n_pix = (long long)H * W;
  const long long plane = (long long)src_h * src_w;
  int xs[PX], f[PX];
  float wx[PX][TAPS], wy[PX][TAPS];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    xs[k] = blockIdx.x * (THREADS * PX) + k * THREADS + threadIdx.x;
    if (xs[k] < W) {
      const long long pix = (long long)y * W + xs[k];
      f[k] = __ldcs(cam.flat + pix);
      load_weights<TAPS>(cam.weights, pix, wx[k], wy[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    if (xs[k] >= W) break;
    const int by = f[k] / Wp;
    const int bx = f[k] - by * Wp;
    for (int b = 0; b < B; ++b) {
      const T* s = static_cast<const T*>(cam.src) + b * plane;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) {
        const T* row = s + (long long)min(max(by + j - pad, 0), src_h - 1) *
                               src_w;
        float row_acc = 0.0f;
#pragma unroll
        for (int i = 0; i < TAPS; ++i) {
          const float v = (float)__ldg(row + min(max(bx + i - pad, 0),
                                                 src_w - 1));
          row_acc = __fadd_rn(row_acc, __fmul_rn(v, wx[k][i]));
        }
        acc = __fadd_rn(acc, __fmul_rn(row_acc, wy[k][j]));
      }
      __stcs(cam.out + b * n_pix + (long long)y * W + xs[k], acc);
    }
  }
}

template <typename T>
int launch(const Cam& c0, const Cam& c1, int cams, int B, int H, int W,
           int src_h, int src_w, int pad, int taps, cudaStream_t stream) {
  const dim3 grid((W + THREADS * PX - 1) / (THREADS * PX), H, cams);
  if (taps == 4)
    remap_kernel<T, 4><<<grid, THREADS, 0, stream>>>(c0, c1, B, H, W, src_h,
                                                     src_w, pad);
  else if (taps == 2)
    remap_kernel<T, 2><<<grid, THREADS, 0, stream>>>(c0, c1, B, H, W, src_h,
                                                     src_w, pad);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int remap(const Cam& c0, const Cam& c1, int cams, int src_u8, int B, int H,
          int W, int src_h, int src_w, int pad, int taps, void* stream) {
  if ((long long)H * W == 0 || B == 0) return 0;
  if (H > 65535 || src_h <= 0 || src_w <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(c0.weights) |
       reinterpret_cast<uintptr_t>(c1.weights)) & 15u)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return src_u8 ? launch<uint8_t>(c0, c1, cams, B, H, W, src_h, src_w, pad,
                                  taps, s)
                : launch<float>(c0, c1, cams, B, H, W, src_h, src_w, pad,
                                taps, s);
}

}  // namespace

// src0, src1: (B, src_h, src_w) uint8 (src_u8 = 1) or float32; flat0,
// flat1: (H, W) int32; weights0, weights1: (H, W, 2 * taps) float32,
// 16-byte aligned: a pixel's taps horizontal weights, then its taps
// vertical ones; out0, out1: (B, H, W) float32. Camera 1's four pointers
// are all null for one camera, or all set for both cameras of a rig in one
// launch (the same shapes, source type and taps).
extern "C" int i3dr_remap(const void* src0, const void* src1, int src_u8,
                          const void* flat0, const void* flat1,
                          const void* weights0, const void* weights1,
                          void* out0, void* out1, int B, int H, int W,
                          int src_h, int src_w, int pad, int taps,
                          void* stream) {
  const int set = !!src1 + !!flat1 + !!weights1 + !!out1;
  if (set % 4) return (int)cudaErrorInvalidValue;
  const Cam c0{src0, (const int*)flat0, (const float*)weights0, (float*)out0};
  const Cam c1 = set ? Cam{src1, (const int*)flat1, (const float*)weights1,
                           (float*)out1}
                     : c0;
  return remap(c0, c1, set ? 2 : 1, src_u8, B, H, W, src_h, src_w, pad, taps,
               stream);
}
