// Probe variant of bp_messages (kernel_probes/probe9.py): for D <= DMAX
// (16 or 32, CSBP's coarsest level) each pixel's four forward scans are
// held in registers, every loop unrolled to DMAX with d < D guards; a
// thread a pixel, 128 a block. The entry's strip argument is ignored.
#include "common.cuh"

namespace {

constexpr int TX = 128;

template <int DMAX>
__global__ void __launch_bounds__(TX)
    bp_regs_kernel(const float* __restrict__ data,
                   const float* __restrict__ msgs, float* __restrict__ out,
                   int B, int D, int H, int W, float jump, float max_disc,
                   float inv_d) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y, b = blockIdx.z;
  if (x >= W) return;
  const long long hw = (long long)H * W;
  const long long dir = (long long)B * D * hw;
  const long long p = (long long)b * D * hw + (long long)y * W + x;
  const bool has0 = y > 0, has1 = y + 1 < H, has2 = x > 0, has3 = x + 1 < W;
  float g0[DMAX], g1[DMAX], g2[DMAX], g3[DMAX];
  float f0 = i3dr::BIG, f1 = i3dr::BIG, f2 = i3dr::BIG, f3 = i3dr::BIG;
  const float inf = __int_as_float(0x7f800000);
  float n0 = inf, n1 = inf, n2 = inf, n3 = inf;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < D) {
      const long long s = p + d * hw;
      const float i0 = has0 ? __ldg(msgs + s - W) : 0.f;
      const float i1 = has1 ? __ldg(msgs + dir + s + W) : 0.f;
      const float i2 = has2 ? __ldg(msgs + 2 * dir + s - 1) : 0.f;
      const float i3 = has3 ? __ldg(msgs + 3 * dir + s + 1) : 0.f;
      const float t = __fadd_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(__ldg(data + s), i0), i1), i2), i3);
      const float h0 = __fsub_rn(t, i1), h1 = __fsub_rn(t, i0);
      const float h2 = __fsub_rn(t, i3), h3 = __fsub_rn(t, i2);
      g0[d] = f0 = fminf(h0, __fadd_rn(f0, jump));
      g1[d] = f1 = fminf(h1, __fadd_rn(f1, jump));
      g2[d] = f2 = fminf(h2, __fadd_rn(f2, jump));
      g3[d] = f3 = fminf(h3, __fadd_rn(f3, jump));
      n0 = fminf(n0, h0);
      n1 = fminf(n1, h1);
      n2 = fminf(n2, h2);
      n3 = fminf(n3, h3);
    }
  }
  const float c0 = __fadd_rn(n0, max_disc), c1 = __fadd_rn(n1, max_disc);
  const float c2 = __fadd_rn(n2, max_disc), c3 = __fadd_rn(n3, max_disc);
  f0 = f1 = f2 = f3 = i3dr::BIG;
#pragma unroll
  for (int d = DMAX - 1; d >= 0; --d) {
    if (d < D) {
      f0 = fminf(g0[d], __fadd_rn(f0, jump));
      f1 = fminf(g1[d], __fadd_rn(f1, jump));
      f2 = fminf(g2[d], __fadd_rn(f2, jump));
      f3 = fminf(g3[d], __fadd_rn(f3, jump));
      g0[d] = fminf(f0, c0);
      g1[d] = fminf(f1, c1);
      g2[d] = fminf(f2, c2);
      g3[d] = fminf(f3, c3);
    }
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < D) {
      s0 = __fadd_rn(s0, g0[d]);
      s1 = __fadd_rn(s1, g1[d]);
      s2 = __fadd_rn(s2, g2[d]);
      s3 = __fadd_rn(s3, g3[d]);
    }
  }
  s0 = __fmul_rn(s0, inv_d);
  s1 = __fmul_rn(s1, inv_d);
  s2 = __fmul_rn(s2, inv_d);
  s3 = __fmul_rn(s3, inv_d);
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (d < D) {
      const long long s = p + d * hw;
      out[s] = __fsub_rn(g0[d], s0);
      out[dir + s] = __fsub_rn(g1[d], s1);
      out[2 * dir + s] = __fsub_rn(g2[d], s2);
      out[3 * dir + s] = __fsub_rn(g3[d], s3);
    }
  }
}

}  // namespace

extern "C" int i3dr_bp_messages(const void* data, const void* msgs,
                                void* out, int B, int D, int H, int W,
                                float jump, float max_disc, float inv_d,
                                int strip, void* stream) {
  if ((long long)B * D * H * W == 0) return 0;
  if (D > 32 || B > 65535 || H > 65535 || data == out || msgs == out)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 16)
    bp_regs_kernel<16><<<grid, TX, 0, s>>>((const float*)data,
                                           (const float*)msgs, (float*)out, B,
                                           D, H, W, jump, max_disc, inv_d);
  else
    bp_regs_kernel<32><<<grid, TX, 0, s>>>((const float*)data,
                                           (const float*)msgs, (float*)out, B,
                                           D, H, W, jump, max_disc, inv_d);
  return (int)cudaGetLastError();
}
