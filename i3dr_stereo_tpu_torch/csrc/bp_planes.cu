// bp_planes — one synchronous min-sum iteration of constant-space belief
// propagation on K candidate planes a pixel: all four directions'
// messages of every pixel in one launch.
//
// Replaces no Pallas kernel: the reference's update is XLA
// (i3dr_stereo_tpu/matchers/bp.py · _bp_iterate_planes, :122-149, and
// _pairwise_smoothness, :114-119), which the plain torch twin
// (matchers/bp.py · bp_iterate_planes_plain) runs as ~20 launches an
// iteration over (4, B, K, K, H, W) intermediates.
//
// What it computes, for each pixel p and direction i (0: +y, 1: -y,
// 2: +x, 3: -x), from the previous messages m (the wrapper ping-pongs two
// buffers: the update is synchronous):
//   inc_j[k] = m_j[p - dir_j][k] (0 where that neighbour leaves the image)
//   total[k] = (((data[k] + inc_0) + inc_1) + inc_2) + inc_3
//   h_i[k]   = total[k] - inc_{i^1}[k]
//   V[k', k] = min(jump * |dv[k'] - dv[k]|, max_disc), dv the SENDER's
//              candidate disparities on both axes (the classic CSBP
//              approximation)
//   out_i[k] = min_k' (h_i[k'] + V[k', k])
//   msg_i[k] = out_i[k] - (sum_{k=0}^{K-1} out_i[k]) * (1 / K)
// every operation rounded on its own (no FMA), in the twin's order:
// kernel and twin are bit-equal.
//
// Design. A thread a pixel, x on threadIdx.x (the volumes are
// plane-major, (4, B, K, H, W), so a warp's loads of one plane are 32
// neighbouring floats). K is a template parameter (1 to 16), so the
// pixel's candidates, costs and four incoming messages sit in registers
// and each element is read once and each output written once. ptxas (H100
// build): 48 registers at the default K = 4; K = 13 to 16 reach 255 and
// spill 8 to 592 bytes, still right.
//
// What bounds it on the card: bytes, (2 + 8) x B*K*H*W*4 an iteration
// (data and candidates, 4 messages in, 4 out); its 4 K^2 (add, min) pairs
// and K^2 smoothness terms a pixel stay below the float32 rate at K <= 16.
#include "common.cuh"

namespace {

constexpr int TX = 128;

template <int K>
__global__ void __launch_bounds__(TX)
    bp_planes_kernel(const float* __restrict__ data,
                     const float* __restrict__ dvals,
                     const float* __restrict__ msgs,
                     float* __restrict__ out, int B, int H, int W,
                     float jump, float max_disc, float inv_k) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;
  const long long hw = (long long)H * W;
  const long long dir = (long long)B * K * hw;
  const long long p = (long long)b * K * hw + (long long)y * W + x;
  const bool has[4] = {y > 0, y + 1 < H, x > 0, x + 1 < W};
  const long long from[4] = {p - W, dir + p + W, 2 * dir + p - 1,
                             3 * dir + p + 1};

  float inc[4][K], total[K], dv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long s = k * hw;
    dv[k] = __ldg(dvals + p + s);
    float t = __ldg(data + p + s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      inc[j][k] = has[j] ? __ldg(msgs + from[j] + s) : 0.f;
      t = __fadd_rn(t, inc[j][k]);
    }
    total[k] = t;
  }
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h[K], o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = __fsub_rn(total[k], inc[i ^ 1][k]);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float m = inf;
#pragma unroll
      for (int k2 = 0; k2 < K; ++k2) {
        const float v = fminf(
            __fmul_rn(jump, fabsf(__fsub_rn(dv[k2], dv[k]))), max_disc);
        m = fminf(m, __fadd_rn(h[k2], v));
      }
      o[k] = m;
      sum = __fadd_rn(sum, m);
    }
    const float mean = __fmul_rn(sum, inv_k);
    float* __restrict__ dst = out + i * dir + p;
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k * hw] = __fsub_rn(o[k], mean);
  }
}

template <int K>
int launch(const float* data, const float* dvals, const float* msgs,
           float* out, int B, int H, int W, float jump, float max_disc,
           float inv_k, cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, H, B);
  bp_planes_kernel<K><<<grid, TX, 0, stream>>>(data, dvals, msgs, out, B, H,
                                              W, jump, max_disc, inv_k);
  return (int)cudaGetLastError();
}

}  // namespace

// data, dvals: (B, K, H, W) float32; msgs, out: (4, B, K, H, W) float32,
// out not aliasing msgs; 1 <= K <= 16; inv_k = float32(1) / float32(K).
extern "C" int i3dr_bp_planes(const void* data, const void* dvals,
                              const void* msgs, void* out, int B, int K,
                              int H, int W, float jump, float max_disc,
                              float inv_k, void* stream) {
  if ((long long)B * K * H * W == 0) return 0;
  if (B > 65535 || H > 65535 || msgs == out || data == out)
    return (int)cudaErrorInvalidValue;
  const float* d = (const float*)data;
  const float* v = (const float*)dvals;
  const float* m = (const float*)msgs;
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
#define I3DR_PLANES(N) \
  case N:              \
    return launch<N>(d, v, m, o, B, H, W, jump, max_disc, inv_k, s);
    I3DR_PLANES(1) I3DR_PLANES(2) I3DR_PLANES(3) I3DR_PLANES(4)
    I3DR_PLANES(5) I3DR_PLANES(6) I3DR_PLANES(7) I3DR_PLANES(8)
    I3DR_PLANES(9) I3DR_PLANES(10) I3DR_PLANES(11) I3DR_PLANES(12)
    I3DR_PLANES(13) I3DR_PLANES(14) I3DR_PLANES(15) I3DR_PLANES(16)
#undef I3DR_PLANES
    default:
      return (int)cudaErrorInvalidValue;
  }
}
