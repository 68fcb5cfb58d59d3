// Probe variant of bp_messages (kernel_probes/probe9.py): the first
// shared-memory form, a block a strip of STRIP pixels with its four
// forward scans in dynamic shared memory, pass 1's loads issued UNROLL
// disparities at a time into registers (csrc/bp_messages.cu copies them
// by cp.async instead); beyond D = 908 the device-memory staging. The
// entry's strip argument is the strip (32, 16) or 0 (the staging).
#include "common.cuh"

namespace {

constexpr int STAGED_TX = 128;         // threads of a staged block
constexpr int UNROLL = 8;              // disparities loaded together
constexpr int MAX_SHARED = 232448;     // a block's dynamic shared memory

// the four incoming planes of one pixel, and where its data lies
struct Incoming {
  const float* __restrict__ m0;
  const float* __restrict__ m1;
  const float* __restrict__ m2;
  const float* __restrict__ m3;
  const float* __restrict__ dat;
  bool has0, has1, has2, has3;
};

__device__ __forceinline__ Incoming incoming(const float* data,
                                             const float* msgs, int B, int D,
                                             int H, int W, int x, int y,
                                             int b) {
  const long long hw = (long long)H * W;
  const long long dir = (long long)B * D * hw;   // one direction's volume
  const long long p = (long long)b * D * hw + (long long)y * W + x;
  // the neighbour each direction's incoming message comes from
  return {msgs + p - W,       msgs + dir + p + W, msgs + 2 * dir + p - 1,
          msgs + 3 * dir + p + 1, data + p,       y > 0,
          y + 1 < H,          x > 0,              x + 1 < W};
}

// one forward step of the four scans from a disparity's five inputs
struct Scan {
  float f0, f1, f2, f3, n0, n1, n2, n3;
  __device__ __forceinline__ void step(float v, float i0, float i1, float i2,
                                       float i3, float jump) {
    const float t = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(v, i0), i1), i2),
                              i3);
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
  }
};

__device__ __forceinline__ Scan scan_start() {
  const float inf = __int_as_float(0x7f800000);
  return {i3dr::BIG, i3dr::BIG, i3dr::BIG, i3dr::BIG, inf, inf, inf, inf};
}

template <int STRIP>
__global__ void __launch_bounds__(STRIP)
    bp_messages_strip_kernel(const float* __restrict__ data,
                             const float* __restrict__ msgs,
                             float* __restrict__ out, int B, int D, int H,
                             int W, float jump, float max_disc, float inv_d) {
  extern __shared__ float bp_smem[];
  const int x = blockIdx.x * STRIP + threadIdx.x;
  const int y = blockIdx.y, b = blockIdx.z;
  if (x >= W) return;
  const long long hw = (long long)H * W;
  const Incoming in = incoming(data, msgs, B, D, H, W, x, y, b);
  // this lane's words: direction i of disparity d at s[(4 d + i) * STRIP]
  float* s = bp_smem + threadIdx.x;

  // pass 1: the forward scans and each direction's minimum of h
  Scan sc = scan_start();
  int d = 0;
  for (; d + UNROLL <= D; d += UNROLL) {
    float v[UNROLL], a0[UNROLL], a1[UNROLL], a2[UNROLL], a3[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long o = (long long)(d + u) * hw;
      v[u] = __ldg(in.dat + o);
      a0[u] = in.has0 ? __ldg(in.m0 + o) : 0.f;
      a1[u] = in.has1 ? __ldg(in.m1 + o) : 0.f;
      a2[u] = in.has2 ? __ldg(in.m2 + o) : 0.f;
      a3[u] = in.has3 ? __ldg(in.m3 + o) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      sc.step(v[u], a0[u], a1[u], a2[u], a3[u], jump);
      float* q = s + (d + u) * 4 * STRIP;
      q[0] = sc.f0;
      q[STRIP] = sc.f1;
      q[2 * STRIP] = sc.f2;
      q[3 * STRIP] = sc.f3;
    }
  }
  for (; d < D; ++d) {
    const long long o = (long long)d * hw;
    sc.step(__ldg(in.dat + o), in.has0 ? __ldg(in.m0 + o) : 0.f,
            in.has1 ? __ldg(in.m1 + o) : 0.f,
            in.has2 ? __ldg(in.m2 + o) : 0.f,
            in.has3 ? __ldg(in.m3 + o) : 0.f, jump);
    float* q = s + d * 4 * STRIP;
    q[0] = sc.f0;
    q[STRIP] = sc.f1;
    q[2 * STRIP] = sc.f2;
    q[3 * STRIP] = sc.f3;
  }
  const float c0 = __fadd_rn(sc.n0, max_disc), c1 = __fadd_rn(sc.n1, max_disc);
  const float c2 = __fadd_rn(sc.n2, max_disc), c3 = __fadd_rn(sc.n3, max_disc);

  // pass 2: the backward scans and the cap, in place
  float f0 = i3dr::BIG, f1 = i3dr::BIG, f2 = i3dr::BIG, f3 = i3dr::BIG;
#pragma unroll 4
  for (int e = D - 1; e >= 0; --e) {
    float* q = s + e * 4 * STRIP;
    f0 = fminf(q[0], __fadd_rn(f0, jump));
    f1 = fminf(q[STRIP], __fadd_rn(f1, jump));
    f2 = fminf(q[2 * STRIP], __fadd_rn(f2, jump));
    f3 = fminf(q[3 * STRIP], __fadd_rn(f3, jump));
    q[0] = fminf(f0, c0);
    q[STRIP] = fminf(f1, c1);
    q[2 * STRIP] = fminf(f2, c2);
    q[3 * STRIP] = fminf(f3, c3);
  }

  // pass 3: the sums from d = 0 upwards
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    const float* q = s + e * 4 * STRIP;
    s0 = __fadd_rn(s0, q[0]);
    s1 = __fadd_rn(s1, q[STRIP]);
    s2 = __fadd_rn(s2, q[2 * STRIP]);
    s3 = __fadd_rn(s3, q[3 * STRIP]);
  }
  s0 = __fmul_rn(s0, inv_d);
  s1 = __fmul_rn(s1, inv_d);
  s2 = __fmul_rn(s2, inv_d);
  s3 = __fmul_rn(s3, inv_d);

  // pass 4: each output written once, the mean subtracted
  const long long dir = (long long)B * D * hw;
  float* o = out + (long long)b * D * hw + (long long)y * W + x;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    const float* q = s + e * 4 * STRIP;
    float* oe = o + (long long)e * hw;
    oe[0] = __fsub_rn(q[0], s0);
    oe[dir] = __fsub_rn(q[STRIP], s1);
    oe[2 * dir] = __fsub_rn(q[2 * STRIP], s2);
    oe[3 * dir] = __fsub_rn(q[3 * STRIP], s3);
  }
}

__global__ void __launch_bounds__(STAGED_TX)
    bp_messages_staged_kernel(const float* __restrict__ data,
                              const float* __restrict__ msgs,
                              float* __restrict__ out, int B, int D, int H,
                              int W, float jump, float max_disc, float inv_d) {
  const int x = blockIdx.x * STAGED_TX + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;
  const long long hw = (long long)H * W;
  const long long dir = (long long)B * D * hw;
  const Incoming in = incoming(data, msgs, B, D, H, W, x, y, b);
  const long long p = (long long)b * D * hw + (long long)y * W + x;
  float* __restrict__ o0 = out + p;
  float* __restrict__ o1 = out + dir + p;
  float* __restrict__ o2 = out + 2 * dir + p;
  float* __restrict__ o3 = out + 3 * dir + p;

  // pass 1: the forward scans, staged in the output planes
  Scan sc = scan_start();
  for (int d = 0; d < D; ++d) {
    const long long s = d * hw;
    sc.step(__ldg(in.dat + s), in.has0 ? __ldg(in.m0 + s) : 0.f,
            in.has1 ? __ldg(in.m1 + s) : 0.f,
            in.has2 ? __ldg(in.m2 + s) : 0.f,
            in.has3 ? __ldg(in.m3 + s) : 0.f, jump);
    o0[s] = sc.f0;
    o1[s] = sc.f1;
    o2[s] = sc.f2;
    o3[s] = sc.f3;
  }
  const float c0 = __fadd_rn(sc.n0, max_disc), c1 = __fadd_rn(sc.n1, max_disc);
  const float c2 = __fadd_rn(sc.n2, max_disc), c3 = __fadd_rn(sc.n3, max_disc);

  // pass 2: the backward scans and the cap
  float f0 = i3dr::BIG, f1 = i3dr::BIG, f2 = i3dr::BIG, f3 = i3dr::BIG;
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

template <int STRIP>
int launch_strip(const float* data, const float* msgs, float* out, int B,
                 int D, int H, int W, float jump, float max_disc, float inv_d,
                 cudaStream_t stream) {
  const long long shared = 16LL * D * STRIP;
  if (shared > MAX_SHARED) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bp_messages_strip_kernel<STRIP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + STRIP - 1) / STRIP, H, B);
  bp_messages_strip_kernel<STRIP><<<grid, STRIP, (size_t)shared, stream>>>(
      data, msgs, out, B, D, H, W, jump, max_disc, inv_d);
  return (int)cudaGetLastError();
}

}  // namespace

// data: (B, D, H, W) float32; msgs, out: (4, B, D, H, W) float32, out not
// aliasing msgs; inv_d = float32(1) / float32(D); strip: 32 or 16 (the
// shared-memory kernel's pixels a block, 16 * D * strip bytes of it) or 0
// (the device-memory-staged kernel), as matchers/bp.py · messages_plan
// picks it from D.
extern "C" int i3dr_bp_messages(const void* data, const void* msgs,
                                void* out, int B, int D, int H, int W,
                                float jump, float max_disc, float inv_d,
                                int strip, void* stream) {
  if ((long long)B * D * H * W == 0) return 0;
  if (B > 65535 || H > 65535 || data == out || msgs == out)
    return (int)cudaErrorInvalidValue;
  const float* dp = (const float*)data;
  const float* mp = (const float*)msgs;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (strip == 32)
    return launch_strip<32>(dp, mp, op, B, D, H, W, jump, max_disc, inv_d, s);
  if (strip == 16)
    return launch_strip<16>(dp, mp, op, B, D, H, W, jump, max_disc, inv_d, s);
  if (strip != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + STAGED_TX - 1) / STAGED_TX, H, B);
  bp_messages_staged_kernel<<<grid, STAGED_TX, 0, s>>>(
      dp, mp, op, B, D, H, W, jump, max_disc, inv_d);
  return (int)cudaGetLastError();
}
