// Probe variant of bp_messages (kernel_probes/probe9.py): the first form's
// scans staged in the output planes in device memory, but run by a
// persistent grid of `strip` blocks (the entry's strip argument) of 128
// threads walking the strips of pixels, so that the live staging of the
// strips in flight (2 KB a pixel at D = 128) fits the 50 MB L2 and passes
// 2-4 read it there; pass 1's loads issued UNROLL disparities at a time.
#include "common.cuh"

namespace {

constexpr int TX = 128;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(TX)
    bp_l2_kernel(const float* __restrict__ data, const float* __restrict__ msgs,
                 float* __restrict__ out, int B, int D, int H, int W,
                 float jump, float max_disc, float inv_d) {
  const long long hw = (long long)H * W;
  const long long dir = (long long)B * D * hw;
  const int sx = (W + TX - 1) / TX;
  const long long strips = (long long)sx * H * B;
  for (long long st = blockIdx.x; st < strips; st += gridDim.x) {
    const int x = (int)(st % sx) * TX + threadIdx.x;
    const long long yb = st / sx;
    const int y = (int)(yb % H), b = (int)(yb / H);
    if (x >= W) continue;
    const bool has0 = y > 0, has1 = y + 1 < H, has2 = x > 0, has3 = x + 1 < W;
    const long long p = (long long)b * D * hw + (long long)y * W + x;
    const float* m0 = msgs + p - W;
    const float* m1 = msgs + dir + p + W;
    const float* m2 = msgs + 2 * dir + p - 1;
    const float* m3 = msgs + 3 * dir + p + 1;
    const float* dat = data + p;
    float* o0 = out + p;
    float* o1 = out + dir + p;
    float* o2 = out + 2 * dir + p;
    float* o3 = out + 3 * dir + p;
    float f0 = i3dr::BIG, f1 = i3dr::BIG, f2 = i3dr::BIG, f3 = i3dr::BIG;
    const float inf = __int_as_float(0x7f800000);
    float n0 = inf, n1 = inf, n2 = inf, n3 = inf;
    for (int d0 = 0; d0 < D; d0 += UNROLL) {
      float v[UNROLL], a0[UNROLL], a1[UNROLL], a2[UNROLL], a3[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long s = (long long)min(d0 + u, D - 1) * hw;
        v[u] = __ldg(dat + s);
        a0[u] = has0 ? __ldg(m0 + s) : 0.f;
        a1[u] = has1 ? __ldg(m1 + s) : 0.f;
        a2[u] = has2 ? __ldg(m2 + s) : 0.f;
        a3[u] = has3 ? __ldg(m3 + s) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (d0 + u >= D) break;
        const long long s = (long long)(d0 + u) * hw;
        const float t = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(v[u], a0[u]),
                                                       a1[u]), a2[u]), a3[u]);
        const float h0 = __fsub_rn(t, a1[u]), h1 = __fsub_rn(t, a0[u]);
        const float h2 = __fsub_rn(t, a3[u]), h3 = __fsub_rn(t, a2[u]);
        f0 = fminf(h0, __fadd_rn(f0, jump));
        f1 = fminf(h1, __fadd_rn(f1, jump));
        f2 = fminf(h2, __fadd_rn(f2, jump));
        f3 = fminf(h3, __fadd_rn(f3, jump));
        n0 = fminf(n0, h0);
        n1 = fminf(n1, h1);
        n2 = fminf(n2, h2);
        n3 = fminf(n3, h3);
        o0[s] = f0;
        o1[s] = f1;
        o2[s] = f2;
        o3[s] = f3;
      }
    }
    const float c0 = __fadd_rn(n0, max_disc), c1 = __fadd_rn(n1, max_disc);
    const float c2 = __fadd_rn(n2, max_disc), c3 = __fadd_rn(n3, max_disc);
    f0 = f1 = f2 = f3 = i3dr::BIG;
    for (int d = D - 1; d >= 0; --d) {
      const long long s = d * hw;
      f0 = fminf(o0[s], __fadd_rn(f0, jump));
      f1 = fminf(o1[s], __fadd_rn(f1, jump));
      f2 = fminf(o2[s], __fadd_rn(f2, jump));
      f3 = fminf(o3[s], __fadd_rn(f3, jump));
      o0[s] = fminf(f0, c0);
      o1[s] = fminf(f1, c1);
      o2[s] = fminf(f2, c2);
      o3[s] = fminf(f3, c3);
    }
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int d = 0; d < D; ++d) {
      const long long s = d * hw;
      s0 = __fadd_rn(s0, o0[s]);
      s1 = __fadd_rn(s1, o1[s]);
      s2 = __fadd_rn(s2, o2[s]);
      s3 = __fadd_rn(s3, o3[s]);
    }
    s0 = __fmul_rn(s0, inv_d);
    s1 = __fmul_rn(s1, inv_d);
    s2 = __fmul_rn(s2, inv_d);
    s3 = __fmul_rn(s3, inv_d);
    for (int d = 0; d < D; ++d) {
      const long long s = d * hw;
      o0[s] = __fsub_rn(o0[s], s0);
      o1[s] = __fsub_rn(o1[s], s1);
      o2[s] = __fsub_rn(o2[s], s2);
      o3[s] = __fsub_rn(o3[s], s3);
    }
  }
}

}  // namespace

extern "C" int i3dr_bp_messages(const void* data, const void* msgs,
                                void* out, int B, int D, int H, int W,
                                float jump, float max_disc, float inv_d,
                                int strip, void* stream) {
  if ((long long)B * D * H * W == 0) return 0;
  if (strip < 1 || data == out || msgs == out)
    return (int)cudaErrorInvalidValue;
  bp_l2_kernel<<<strip, TX, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const float*)msgs, (float*)out, B, D, H, W, jump,
      max_disc, inv_d);
  return (int)cudaGetLastError();
}
