// bp_messages — one synchronous min-sum iteration of dense belief
// propagation: all four directions' messages of every pixel in one
// launch.
//
// Replaces no Pallas kernel: the reference's update is XLA
// (i3dr_stereo_tpu/matchers/bp.py · _bp_iterate, :75-94, and
// _distance_transform_d, :42-55: two lax.scans over D), which the plain
// torch twin (matchers/bp.py · bp_iterate_plain) runs as ~6 launches a
// disparity step, ~800 an iteration at D = 128.
//
// What it computes, for each pixel p and direction i (0: +y, 1: -y,
// 2: +x, 3: -x), from the previous messages m (never the ones it writes:
// the update is synchronous, the wrapper ping-pongs two buffers):
//   inc_j[d] = m_j[p - dir_j][d] (0 where that neighbour leaves the image)
//   total[d] = (((data[d] + inc_0) + inc_1) + inc_2) + inc_3
//   h_i[d]   = total[d] - inc_{i^1}[d]
//   f_i      = the forward min-scan of h_i over d, f[d] = min(h[d], f[d-1]
//              + jump) from BIG, then the backward one over f likewise
//   out_i[d] = min(f_i[d], min_d h_i + max_disc)
//   msg_i[d] = out_i[d] - (sum_{d=0}^{D-1} out_i[d]) * (1 / D)
// with every add and subtract rounded on its own (no FMA), in the twin's
// order: kernel and twin are bit-equal.
//
// Design. A thread a pixel, its x on threadIdx.x, so that a warp's loads
// and stores of one disparity plane are 32 neighbouring floats (the
// volumes are disparity-major, (4, B, D, H, W)). D is any width, so the
// scans' state cannot live in a register array: each direction's scan is
// staged in its own output plane. Pass 1 walks d upwards, loads data and
// the four incoming messages once, and writes the four forward scans;
// pass 2 walks d downwards over them and writes out_i; pass 3 sums out_i
// upwards; pass 4 subtracts the mean. No shared memory, few registers.
//
// What bounds it on the card: bytes. It must read data and the 4 incoming
// planes and write 4 (9 x B*D*H*W*4 bytes, 1.80 ms at 1x1024x1280x128 and
// 3.35 TB/s); its ~30 operations a pixel and disparity are far below the
// float32 rate. The staging re-reads each output plane three times and
// writes it twice more (17 reads and 12 writes a pixel and disparity
// where the bound counts 5 and 4), most of it beyond the 50 MB L2 at the
// main shapes: a simple kernel that is right, not yet a fast one.
// chip_smoke.py reads 7.7 ms back to back at 1x1024x1280x128 on an NVIDIA
// H100 80GB HBM3 at 700 W (23 % of the bound; 54 registers, no spills).
#include "common.cuh"

namespace {

constexpr int TX = 128;

__global__ void __launch_bounds__(TX)
    bp_messages_kernel(const float* __restrict__ data,
                       const float* __restrict__ msgs,
                       float* __restrict__ out, int B, int D, int H, int W,
                       float jump, float max_disc, float inv_d) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;
  const long long hw = (long long)H * W;
  const long long dir = (long long)B * D * hw;   // one direction's volume
  const long long p = (long long)b * D * hw + (long long)y * W + x;
  // the neighbour each direction's incoming message comes from
  const bool has0 = y > 0, has1 = y + 1 < H, has2 = x > 0, has3 = x + 1 < W;
  const float* __restrict__ m0 = msgs + p - W;
  const float* __restrict__ m1 = msgs + dir + p + W;
  const float* __restrict__ m2 = msgs + 2 * dir + p - 1;
  const float* __restrict__ m3 = msgs + 3 * dir + p + 1;
  const float* __restrict__ dat = data + p;
  float* __restrict__ o0 = out + p;
  float* __restrict__ o1 = out + dir + p;
  float* __restrict__ o2 = out + 2 * dir + p;
  float* __restrict__ o3 = out + 3 * dir + p;

  // pass 1: the forward scans and each direction's minimum of h
  float f0 = i3dr::BIG, f1 = i3dr::BIG, f2 = i3dr::BIG, f3 = i3dr::BIG;
  const float inf = __int_as_float(0x7f800000);
  float n0 = inf, n1 = inf, n2 = inf, n3 = inf;
  for (int d = 0; d < D; ++d) {
    const long long s = d * hw;
    const float i0 = has0 ? __ldg(m0 + s) : 0.f;
    const float i1 = has1 ? __ldg(m1 + s) : 0.f;
    const float i2 = has2 ? __ldg(m2 + s) : 0.f;
    const float i3 = has3 ? __ldg(m3 + s) : 0.f;
    const float t = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(__ldg(dat + s), i0), i1), i2), i3);
    const float h0 = __fsub_rn(t, i1), h1 = __fsub_rn(t, i0);
    const float h2 = __fsub_rn(t, i3), h3 = __fsub_rn(t, i2);
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
  const float c0 = __fadd_rn(n0, max_disc), c1 = __fadd_rn(n1, max_disc);
  const float c2 = __fadd_rn(n2, max_disc), c3 = __fadd_rn(n3, max_disc);

  // pass 2: the backward scans and the cap
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

  // pass 3: the sums from d = 0 upwards; pass 4: the mean subtracted
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

}  // namespace

// data: (B, D, H, W) float32; msgs, out: (4, B, D, H, W) float32, out not
// aliasing msgs; inv_d = float32(1) / float32(D).
extern "C" int i3dr_bp_messages(const void* data, const void* msgs,
                                void* out, int B, int D, int H, int W,
                                float jump, float max_disc, float inv_d,
                                void* stream) {
  if ((long long)B * D * H * W == 0) return 0;
  if (B > 65535 || H > 65535 || data == out || msgs == out)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, H, B);
  bp_messages_kernel<<<grid, TX, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const float*)msgs, (float*)out, B, D, H, W, jump,
      max_disc, inv_d);
  return (int)cudaGetLastError();
}
