// sgm_volume — SGM path aggregation over (B, H, W, D) cost volumes of
// any D from 1 to 512, float32 or uint8 costs. sgm_aggregate hands it
// volumes padded to a multiple of 128 (the TPU's padding); the lean
// fused path (fused_cost_sgm.cu) hands it the exact D, as the TPU's
// _horizontal_pass / _vertical_pass take it there.
//
// Replaces the two kernels of i3dr_stereo_tpu/ops/sgm_pallas.py behind
// sgm_aggregate_pallas:
//   _lr_kernel   (pallas_call :173, entry _horizontal_pass)  — H
//   _vert_kernel (pallas_call :229, entry _vertical_pass)    — I
// as two launches:
//
//   sgm_volume_kernel: one path direction (dy, dx) per launch, writing
//     its float32 path costs L, unclamped:
//       L(p, d) = (c(p, d) + min(L(p-r, d), L(p-r, d±1) + P1, m + P2)) - m
//       m = min_k L(p-r, k),  L(p-r, -1) = L(p-r, D) = 1e9
//     c = the float32 cost, or 1e9 for the uint8 sentinel 255. A path
//     enters the volume with a zero carry: horizontal paths restart each
//     row, vertical and diagonal paths at the top (bottom) row, and
//     diagonals again at the entering column (the TPU's zeroed column of
//     the shifted carry).
//   sgm_volume_sum_kernel: the sum of the partials in the TPU's order.
//     The partials come grouped as sgm_aggregate_pallas launches them (a
//     horizontal direction alone; a vertical family by penalty, split
//     when the TPU's VMEM rule says so); a group's total is
//     L_1 + L_2 + L_3 in order. float32 mode: S = the group totals summed
//     in order. int16 mode (the TPU stores each group total as int16):
//     each total becomes trunc(min(total, 10000)), and S is their int32
//     sum.
//
// Design: one warp per scanline, lane = disparity, generalised. Each
// lane holds K = ceil(D/32) (1, 2, 4, 8, 12 or 16) consecutive
// disparities of the carry in registers, so d-1 / d+1 cross lanes only
// at a lane's two ends (one shuffle each); min_d is an in-lane min and
// the 5-step butterfly (sgm_step.cuh). Where the lanes tile D exactly
// and K is a multiple of 4 the costs load and the path costs store as
// 16-byte vectors; any other D goes element by element. Arithmetic is the
// reference's float32 sequence, rounded per operation (__fadd_rn /
// __fsub_rn), so the kernel equals its torch twin bit for bit.
//
// What bounds it on the card: bytes and the dependent chain. One
// direction reads C and writes one float32 partial: at 1024x1280x128
// float32 that is 1.34 GB, ~0.40 ms of HBM time at 3.35 TB/s. Each step
// of a scanline depends on the previous one, so the kernel issues the
// loads of the next UNROLL steps (16 bytes a lane) ahead of the
// recurrence. A horizontal pass has only B*H warps (1024 at 1280x1024,
// ~8 per SM): too few to hide the chain's latency fully. The sum kernel
// reads every partial once more (8 partials: 5.4 GB at that shape); an
// in-place accumulation would remove it — later work.
#include <climits>

#include "sgm_step.cuh"

namespace {

constexpr int MAX_PARTS = 8;
constexpr int THREADS = 128;

// the costs of one step that a lane loads ahead: its K disparities, as
// 16-byte (float) or 4-byte (uint8) vectors when the lanes tile D exactly
// (vec), else one by one, skipping the disparities past D
template <typename T, int K>
struct Raw;

template <int K>
struct Raw<float, K> {
  float v[K];
  __device__ __forceinline__ void load(const float* p, bool vec, int last) {
    if constexpr (K % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(p) + q);
          v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z,
                v[4 * q + 3] = w.w;
        }
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = k <= last ? __ldg(p + k) : i3dr::BIG;
  }
  __device__ __forceinline__ float get(int k) const { return v[k]; }
};

template <int K>
struct Raw<uint8_t, K> {
  unsigned v[(K + 3) / 4];
  __device__ __forceinline__ void load(const uint8_t* p, bool vec, int last) {
    if constexpr (K % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q)
          v[q] = __ldg(reinterpret_cast<const unsigned*>(p) + q);
        return;
      }
    }
#pragma unroll
    for (int q = 0; q < (K + 3) / 4; ++q) v[q] = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k <= last) v[k >> 2] |= (unsigned)__ldg(p + k) << (8 * (k & 3));
  }
  __device__ __forceinline__ float get(int k) const {
    const unsigned b = (v[k >> 2] >> (8 * (k & 3))) & 0xffu;
    return b == (unsigned)i3dr::SENTINEL ? i3dr::BIG : (float)b;
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
    sgm_volume_kernel(const T* __restrict__ C, float* __restrict__ out,
                      int H, int W, int D, int dy, int dx, long long n_warps,
                      int n_lines, float p1, float p2) {
  constexpr int UNROLL = K <= 4 ? 8 : (K <= 8 ? 4 : 2);
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (warp >= n_warps) return;  // uniform across the warp
  const int b = (int)(warp / n_lines);
  const int line = (int)(warp % n_lines);
  const int last = D - 1 - lane * K;  // see sgm_step.cuh
  const bool vec = K % 4 == 0 && D == i3dr::WARP * K;

  // first pixel of the scanline: the pixel whose predecessor (y-dy, x-dx)
  // lies outside the volume
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

  const long long stride = ((long long)dy * W + dx) * D;
  const long long base = (((long long)b * H + y) * W + x) * D + lane * K;
  const T* cp = C + base;
  float* op = out + base;

  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) prev[k] = k <= last ? 0.0f : CUDART_INF_F;

  for (int s0 = 0; s0 < len; s0 += UNROLL) {
    Raw<T, K> raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (s0 + u < len)
        raw[u].load(cp + (long long)(s0 + u) * stride, vec, last);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s0 + u < len) {  // uniform across the warp
        float c[K], L[K];
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = raw[u].get(k);
        i3dr::sgm_step<K>(prev, c, L, lane, last, p1, p2);
        float* o = op + (long long)(s0 + u) * stride;
        bool stored = false;
        if constexpr (K % 4 == 0) {
          if (vec) {
#pragma unroll
            for (int q = 0; q < K / 4; ++q)
              reinterpret_cast<float4*>(o)[q] = make_float4(
                  L[4 * q], L[4 * q + 1], L[4 * q + 2], L[4 * q + 3]);
            stored = true;
          }
        }
        if (!stored) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (k <= last) o[k] = L[k];
        }
#pragma unroll
        for (int k = 0; k < K; ++k) prev[k] = L[k];
      }
    }
  }
}

struct Plan {
  const float* p[MAX_PARTS];
  int group_end[MAX_PARTS];  // partials [group_end[g-1], group_end[g])
  int n_groups;
};

// one thread per 4 consecutive elements
template <bool INT16_MODE>
__global__ void __launch_bounds__(256)
    sgm_volume_sum_kernel(Plan plan, void* __restrict__ out, long long n4) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int si[4] = {0, 0, 0, 0};
  int k = 0;
  for (int g = 0; g < plan.n_groups; ++g) {
    float4 t = __ldg(reinterpret_cast<const float4*>(plan.p[k]) + i);
    for (++k; k < plan.group_end[g]; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(plan.p[k]) + i);
      t = make_float4(__fadd_rn(t.x, v.x), __fadd_rn(t.y, v.y),
                      __fadd_rn(t.z, v.z), __fadd_rn(t.w, v.w));
    }
    const float tt[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (INT16_MODE)
        si[j] += (int)fminf(tt[j], i3dr::CLAMP);  // truncates, as astype
      else
        s[j] = g == 0 ? tt[j] : __fadd_rn(s[j], tt[j]);
    }
  }
  if (INT16_MODE)
    reinterpret_cast<int4*>(out)[i] = make_int4(si[0], si[1], si[2], si[3]);
  else
    reinterpret_cast<float4*>(out)[i] = make_float4(s[0], s[1], s[2], s[3]);
}

template <typename T>
int launch_path(const void* C, void* out, int B, int H, int W, int D, int dy,
                int dx, float p1, float p2, cudaStream_t stream) {
  const int n_lines = dy == 0 ? H : (dx == 0 ? W : W + H - 1);
  const long long n_warps = (long long)B * n_lines;
  if (n_warps == 0) return 0;
  const long long blocks = (n_warps * i3dr::WARP + THREADS - 1) / THREADS;
  const T* c = (const T*)C;
  float* o = (float*)out;
#define I3DR_SGM_VOLUME_LAUNCH(K)                                          \
  sgm_volume_kernel<T, K><<<(unsigned)blocks, THREADS, 0, stream>>>(      \
      c, o, H, W, D, dy, dx, n_warps, n_lines, p1, p2)
  switch (i3dr::lanes_k(D)) {
    case 1: I3DR_SGM_VOLUME_LAUNCH(1); break;
    case 2: I3DR_SGM_VOLUME_LAUNCH(2); break;
    case 4: I3DR_SGM_VOLUME_LAUNCH(4); break;
    case 8: I3DR_SGM_VOLUME_LAUNCH(8); break;
    case 12: I3DR_SGM_VOLUME_LAUNCH(12); break;
    case 16: I3DR_SGM_VOLUME_LAUNCH(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef I3DR_SGM_VOLUME_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// u8 = 1: C is uint8 (255 = invalid); u8 = 0: C is float32. D is the
// volume's exact disparity count, 1 to 512.
extern "C" int i3dr_sgm_volume(const void* C, int u8, void* out, int B, int H,
                               int W, int D, int dy, int dx, float p1,
                               float p2, void* stream) {
  if ((dy == 0 && dx == 0) || dy < -1 || dy > 1 || dx < -1 || dx > 1)
    return (int)cudaErrorInvalidValue;
  return u8 ? launch_path<uint8_t>(C, out, B, H, W, D, dy, dx, p1, p2,
                                   (cudaStream_t)stream)
            : launch_path<float>(C, out, B, H, W, D, dy, dx, p1, p2,
                                 (cudaStream_t)stream);
}

// parts: host array of n_parts device pointers, in the TPU's order;
// group_end: host array of n_groups exclusive ends into parts. out is
// float32 (int16_mode = 0) or int32 (int16_mode = 1); n is a multiple
// of 4.
extern "C" int i3dr_sgm_volume_sum(const void* const* parts, int n_parts,
                                   const int* group_end, int n_groups,
                                   int int16_mode, void* out, long long n,
                                   void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS || n_groups < 1 ||
      n_groups > n_parts || group_end[n_groups - 1] != n_parts || n % 4)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  for (int k = 0; k < n_parts; ++k) plan.p[k] = (const float*)parts[k];
  for (int g = 0; g < n_groups; ++g) {
    if (group_end[g] <= (g ? group_end[g - 1] : 0))
      return (int)cudaErrorInvalidValue;
    plan.group_end[g] = group_end[g];
  }
  plan.n_groups = n_groups;
  const long long n4 = n / 4;
  if (n4 == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n4 + threads - 1) / threads);
  if (int16_mode)
    sgm_volume_sum_kernel<true>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(plan, out, n4);
  else
    sgm_volume_sum_kernel<false>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(plan, out, n4);
  return (int)cudaGetLastError();
}
