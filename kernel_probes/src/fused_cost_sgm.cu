// fused_cost_sgm — the matching cost and the forward-horizontal SGM pass
// in one sweep: the uint8 cost volume C for the other directions and the
// W->E path costs L come out together, and the float cost never reaches
// memory.
//
// Replaces the two kernels of i3dr_stereo_tpu/ops/fused_cost_sgm.py:
//   _fused_fwd_kernel (pallas_call :201, entry fused_census_horizontal) — J
//   _fused_bt_kernel  (pallas_call :348, entry fused_bt_horizontal)     — K
//
// For pixel (y, x) and disparity index d the right source column is
//   src = x - base[y / th] - min_disp - d
// (base: one window base per tile of th rows), valid iff 0 <= src <= W-1.
//
//   fused_census_fwd: cost = sum_w popcount(cl[w] ^ cr[w] at src) over the
//     NW census word planes.
//   fused_bt_fwd: the pixelwise Birchfield-Tomasi cost in doubled units,
//     cost = rint(2 * min(max(l - rhi, rlo - l, 0), max(r - lhi, llo - r, 0)))
//     with lo/hi the min/max of a pixel and its two half-sample
//     neighbours 0.5 * (v + v(x±1)), columns edge-replicated.
//
//   C = min(cost, 254) where valid, else 255.
//   L = the SGM recurrence (sgm_step.cuh) along x on the UNCLAMPED cost
//       (1e9 where invalid), zero carry at x = 0, at the exact D.
//   S = L as float32, or (int16 mode) trunc(min(L, 10000)); the carry
//       stays the unclamped float32 either way.
//
// Any base is tested against the bounds: the TPU's reversed right plane,
// its 128-aligned window loads and rotations, its 8-column groups and its
// base >= -64 limit have no counterpart.
//
// The census cost at D = 32, the main path's shape, has a kernel of its
// own in fused_census32.cu (what bounds it and its design are told there);
// this file holds the kernel for every other D from 1 to 512 and for the
// BT cost, and both entry points.
//
// Design (fused_fwd_kernel): one warp per image row, the D disparities
// across the lanes, K consecutive ones per lane, the carry in registers
// (sgm_volume.cu's horizontal sweep with the cost computed in place of
// loaded). The costs of a block of U columns are computed ahead of the
// dependent recurrence; for the census cost a lane's K disparities over the
// block meet U + K - 1 consecutive right columns, each loaded once a block
// (11 loads a plane at K = 8, U = 4, where a load a pairing made 32): at
// 2048x2448, D = 256 that took 5.7-5.9 ms to 3.6 (NVIDIA H100 80GB HBM3,
// 700 W). What bounds it there: 6.5 GB moved once are 1.95 ms at 3.35 TB/s.
#include "fused_census32.cuh"
#include "sgm_step.cuh"

namespace {

constexpr int THREADS = 128;

// Cost functors: block() gives the unclamped costs of the U left columns
// from x0 (those below W) of one row against the right columns
// x0 + u - off - (d0 + k), for the k up to `last` whose column lies in the
// row; what it leaves in the other places is not read.

struct CensusCost {
  const uint32_t* cl;  // (NW, B, H, W) word planes
  const uint32_t* cr;
  long long plane;     // B * H * W
  int NW;

  __host__ __device__ static constexpr int unroll(int K) {
    return K <= 8 ? 4 : 2;
  }

  // A lane's K disparities over U columns meet U + K - 1 consecutive right
  // columns: each is loaded once a block, not once a pairing.
  template <int K, int U>
  __device__ __forceinline__ void block(long long row, int x0, int W, int off,
                                        int d0, int last,
                                        float (&out)[U][K]) const {
    int ham[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k) ham[u][k] = 0;
    const int c0 = x0 - off - d0 - (K - 1);  // the column of u - k = -(K - 1)
    for (int w = 0; w < NW; ++w) {
      const uint32_t* l = cl + w * plane + row;
      const uint32_t* r = cr + w * plane + row;
      uint32_t a[U], b[U + K - 1];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = x0 + u < W ? __ldg(l + x0 + u) : 0u;
#pragma unroll
      for (int i = 0; i < U + K - 1; ++i)
        b[i] = (unsigned)(c0 + i) < (unsigned)W ? __ldg(r + c0 + i) : 0u;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k)
          ham[u][k] += __popc(a[u] ^ b[K - 1 + u - k]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k) out[u][k] = (float)ham[u][k];
  }
};

__device__ __forceinline__ float half_sample(float v, float nb) {
  return __fmul_rn(0.5f, __fadd_rn(v, nb));
}

struct BtCost {
  const float* left;   // (B, H, W) prefiltered images
  const float* right;

  __host__ __device__ static constexpr int unroll(int K) {
    return K <= 2 ? 4 : 2;
  }

  template <int K, int U>
  __device__ __forceinline__ void block(long long row, int x0, int W, int off,
                                        int d0, int last,
                                        float (&out)[U][K]) const {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (x0 + u < W) column<K>(row, x0 + u, W, off, d0, last, out[u]);
  }

  template <int K>
  __device__ __forceinline__ void column(long long row, int x, int W, int off,
                                         int d0, int last,
                                         float (&out)[K]) const {
    const float* l = left + row;
    const float* r = right + row;
    const float lx = __ldg(l + x);
    const float la = half_sample(lx, __ldg(l + max(x - 1, 0)));
    const float lb = half_sample(lx, __ldg(l + min(x + 1, W - 1)));
    const float llo = fminf(fminf(la, lb), lx);
    const float lhi = fmaxf(fmaxf(la, lb), lx);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      out[k] = 0.0f;
      const int s = x - off - (d0 + k);
      if (k <= last && s >= 0 && s < W) {
        const float rx = __ldg(r + s);
        const float ra = half_sample(rx, __ldg(r + min(s + 1, W - 1)));
        const float rb = half_sample(rx, __ldg(r + max(s - 1, 0)));
        const float rlo = fminf(fminf(ra, rb), rx);
        const float rhi = fmaxf(fmaxf(ra, rb), rx);
        const float dl =
            fmaxf(fmaxf(__fsub_rn(lx, rhi), __fsub_rn(rlo, lx)), 0.0f);
        const float dr =
            fmaxf(fmaxf(__fsub_rn(rx, lhi), __fsub_rn(llo, rx)), 0.0f);
        // doubled units, rounded half to even as jnp.round
        out[k] = rintf(__fmul_rn(2.0f, fminf(dl, dr)));
      }
    }
  }
};

template <int K, typename Cost>
__global__ void __launch_bounds__(THREADS)
    fused_fwd_kernel(Cost cost, const int* __restrict__ base, int th,
                     uint8_t* __restrict__ C, float* __restrict__ Sf,
                     int16_t* __restrict__ Si, int H, int W, int D,
                     int min_disp, long long n_warps, float p1, float p2) {
  constexpr int UNROLL = Cost::unroll(K);  // columns a block
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (warp >= n_warps) return;      // uniform across the warp
  const int y = (int)(warp % H);    // warp = b * H + y
  const long long row = warp * W;   // the row's offset in a (B, H, W) plane
  const int off = __ldg(base + y / th) + min_disp;
  const int d0 = lane * K;
  const int last = D - 1 - d0;      // see sgm_step.cuh
  const bool vec = K % 4 == 0 && D == i3dr::WARP * K;
  const long long o0 = row * D + d0;

  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) prev[k] = k <= last ? 0.0f : CUDART_INF_F;

  for (int x0 = 0; x0 < W; x0 += UNROLL) {
    float raw[UNROLL][K];
    cost.template block<K, UNROLL>(row, x0, W, off, d0, last, raw);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (x0 + u < W) {  // uniform across the warp
        float c[K], L[K];
        int cb[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = x0 + u - off - (d0 + k);
          const bool ok = s >= 0 && s < W;
          c[k] = ok ? raw[u][k] : i3dr::BIG;
          cb[k] = ok ? (int)fminf(raw[u][k], 254.0f) : i3dr::SENTINEL;
        }
        i3dr::sgm_step<K>(prev, c, L, lane, last, p1, p2);
        const long long o = o0 + (long long)(x0 + u) * D;
        bool stored = false;
        if constexpr (K % 4 == 0) {
          if (vec) {
#pragma unroll
            for (int q = 0; q < K / 4; ++q) {
              reinterpret_cast<unsigned*>(C + o)[q] =
                  (unsigned)cb[4 * q] | (unsigned)cb[4 * q + 1] << 8 |
                  (unsigned)cb[4 * q + 2] << 16 | (unsigned)cb[4 * q + 3] << 24;
              if (Si == nullptr) {
                reinterpret_cast<float4*>(Sf + o)[q] = make_float4(
                    L[4 * q], L[4 * q + 1], L[4 * q + 2], L[4 * q + 3]);
              } else {
                short4 v;
                v.x = (short)(int)fminf(L[4 * q], i3dr::CLAMP);
                v.y = (short)(int)fminf(L[4 * q + 1], i3dr::CLAMP);
                v.z = (short)(int)fminf(L[4 * q + 2], i3dr::CLAMP);
                v.w = (short)(int)fminf(L[4 * q + 3], i3dr::CLAMP);
                reinterpret_cast<short4*>(Si + o)[q] = v;
              }
            }
            stored = true;
          }
        }
        if (!stored) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (k <= last) {
              C[o + k] = (uint8_t)cb[k];
              if (Si == nullptr)
                Sf[o + k] = L[k];
              else  // truncates, as astype
                Si[o + k] = (int16_t)(int)fminf(L[k], i3dr::CLAMP);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) prev[k] = L[k];
      }
    }
  }
}

template <typename Cost>
int launch_fused(Cost cost, const void* base, int th, void* C, void* S,
                 int s_i16, int B, int H, int W, int D, int min_disp,
                 float p1, float p2, cudaStream_t stream) {
  if (th < 1) return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * H;
  if (n_warps == 0 || W == 0) return 0;
  const long long blocks = (n_warps * i3dr::WARP + THREADS - 1) / THREADS;
  float* sf = s_i16 ? nullptr : (float*)S;
  int16_t* si = s_i16 ? (int16_t*)S : nullptr;
#define I3DR_FUSED_LAUNCH(K)                                              \
  fused_fwd_kernel<K, Cost><<<(unsigned)blocks, THREADS, 0, stream>>>(    \
      cost, (const int*)base, th, (uint8_t*)C, sf, si, H, W, D, min_disp, \
      n_warps, p1, p2)
  switch (i3dr::lanes_k(D)) {
    case 1: I3DR_FUSED_LAUNCH(1); break;
    case 2: I3DR_FUSED_LAUNCH(2); break;
    case 4: I3DR_FUSED_LAUNCH(4); break;
    case 8: I3DR_FUSED_LAUNCH(8); break;
    case 12: I3DR_FUSED_LAUNCH(12); break;
    case 16: I3DR_FUSED_LAUNCH(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef I3DR_FUSED_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// cl, cr: uint32 (NW, B, H, W) census word planes; base: int32, one entry
// per tile of th rows (ceil(H / th) entries); C: uint8 (B, H, W, D); S:
// float32 (s_i16 = 0) or int16 (s_i16 = 1) (B, H, W, D); D from 1 to 512.
extern "C" int i3dr_fused_census_fwd(const void* cl, const void* cr,
                                     const void* base, int th, void* C,
                                     void* S, int s_i16, int B, int H, int W,
                                     int NW, int D, int min_disp, float p1,
                                     float p2, void* stream) {
  if (NW < 1) return (int)cudaErrorInvalidValue;
  if (i3dr::fused_census32_takes(D, NW))
    return i3dr::fused_census32(cl, cr, base, th, C, S, s_i16, B, H, W, NW,
                                min_disp, p1, p2, (cudaStream_t)stream);
  CensusCost cost = {(const uint32_t*)cl, (const uint32_t*)cr,
                     (long long)B * H * W, NW};
  return launch_fused(cost, base, th, C, S, s_i16, B, H, W, D, min_disp, p1,
                      p2, (cudaStream_t)stream);
}

// left, right: float32 (B, H, W) prefiltered images; the rest as above.
extern "C" int i3dr_fused_bt_fwd(const void* left, const void* right,
                                 const void* base, int th, void* C, void* S,
                                 int s_i16, int B, int H, int W, int D,
                                 int min_disp, float p1, float p2,
                                 void* stream) {
  BtCost cost = {(const float*)left, (const float*)right};
  return launch_fused(cost, base, th, C, S, s_i16, B, H, W, D, min_disp, p1,
                      p2, (cudaStream_t)stream);
}
