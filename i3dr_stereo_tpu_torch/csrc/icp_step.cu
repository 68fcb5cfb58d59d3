// icp_step — one Gauss-Newton iteration of projective point-to-plane ICP:
// the normal equations over every pixel of a pyramid level, the damped
// 6x6 solve and the pose update, all on the card.
//
// Replaces no Pallas kernel: the reference's iteration is XLA
// (i3dr_stereo_tpu/mapping/odometry.py · _icp_level, :112-151), which the
// plain torch twin (mapping/odometry.py · icp_step_plain) runs as ~60
// launches over (H, W, 3) and (H, W, 6) intermediates an iteration.
//
// What it computes. The maps are the port's packed layout, (H, W, 4)
// float32: cur = [vertex, valid] of the current frame, prev_v the same of
// the previous frame, prev_n = [normal, ok] of the previous frame. T is
// state[0:16] (T_pc, row-major). For every current pixel with valid > 0:
//   p = R v + t, each row ((v0 R_r0 + v1 R_r1) + v2 R_r2) + t_r
//   u = (fx p0) / max(p2, 1e-9) + cx,  v = (fy p1) / max(p2, 1e-9) + cy
//   ui, vi = rint(u), rint(v) (half to even, as jnp.round); in bounds:
//   p2 > 1e-6 and 0 <= ui < W and 0 <= vi < H (compared as floats, which
//   is what a saturating int cast gives)
//   q, n, ok = prev_v[vi, ui], prev_n[vi, ui];  d = p - q
//   the pixel counts where ok > 0 and ((d0 d0 + d1 d1) + d2 d2) < thr2:
//   r = (d0 n0 + d1 n1) + d2 n2, J = [p x n; n],
//   A += J J^T (21 entries), Jr += J r, sum r^2 += r r, sum w += 1.
// The per-pixel arithmetic is the twin's, rounded op by op (so kernel and
// twin pair the same pixels); the sums are not the twin's order.
// Then, with b = -Jr: xi = solve(A + 1e-6 I, b) (LU with partial
// pivoting, as getrf / getrs), T = se3_exp(xi) @ T (Rodrigues with the
// reference's small-angle forms), rmse = sqrt(sum r^2 / max(sum w, 1)),
// frac = max(sum w, 1) * inv_hw (XLA's product by the reciprocal of the
// constant H * W). state after the call: T (0-15), rmse (16), frac (17),
// A undamped (18-53, row-major), b (54-59), sum r^2 (60), sum w (61).
//
// Design. Two launches, in the caller's stream, with no host sync and no
// float atomics, so reruns give identical poses:
// - icp_terms_kernel: a fixed grid (a function of H * W alone) of 256
//   threads a block, each thread striding over pixels with its 29 sums in
//   registers; a block sums them by a butterfly of shuffles a warp and its
//   8 warps in order, and writes its 29 partial sums;
// - icp_solve_kernel: one block, a warp for each of the 29 sums adding
//   the blocks' partials in a fixed order, then one thread solves, takes
//   the exponential and writes the state. The next iteration's first
//   launch reads T from there.
// The maps are read as float4: the current map in order, the previous
// maps gathered at the hit pixel (neighbouring pixels hit neighbouring
// pixels, so the gathers share sectors).
//
// What bounds it on the card: bytes. The function needs 38 a pixel (the
// current vertex and valid flag, the previous vertex, normal and ok flag:
// 190 MB at 2448x2048, 0.057 ms at 3.35 TB/s); the packed maps read here
// are 48 (padding and the flags as floats). Its ~100 float operations a
// matched pixel stay below the float32 rate.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 256;
constexpr int WARPS = TX / 32;
constexpr int NT = 29;           // 21 of A, 6 of J r, sum r^2, sum w
constexpr int SLOT = 32;         // floats of a block's partial sums
constexpr int MAX_BLOCKS = 1024;
constexpr int PIXELS = 8;        // pixels a thread, at least, below the cap
constexpr unsigned FULL = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, thr2;
};

__global__ void __launch_bounds__(TX)
    icp_terms_kernel(const float4* __restrict__ cur,
                     const float4* __restrict__ prev_v,
                     const float4* __restrict__ prev_n, int H, int W, Cam cam,
                     const float* __restrict__ state,
                     float* __restrict__ partials) {
  __shared__ float red[WARPS][NT];
  float R[9], t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[3 * r + c] = __ldg(state + 4 * r + c);
    t[r] = __ldg(state + 4 * r + 3);
  }
  float acc[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) acc[k] = 0.f;
  const long long n = (long long)H * W;
  for (long long i = (long long)blockIdx.x * TX + threadIdx.x; i < n;
       i += (long long)gridDim.x * TX) {
    const float4 c = __ldg(cur + i);
    if (!(c.w > 0.f)) continue;
    float p[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      p[r] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(c.x, R[3 * r]),
                              __fmul_rn(c.y, R[3 * r + 1])),
                    __fmul_rn(c.z, R[3 * r + 2])),
          t[r]);
    const float pz = fmaxf(p[2], 1e-9f);
    const float uf =
        rintf(__fadd_rn(__fdiv_rn(__fmul_rn(cam.fx, p[0]), pz), cam.cx));
    const float vf =
        rintf(__fadd_rn(__fdiv_rn(__fmul_rn(cam.fy, p[1]), pz), cam.cy));
    if (!(p[2] > 1e-6f && uf >= 0.f && uf < (float)W && vf >= 0.f &&
          vf < (float)H))
      continue;
    const long long j = (long long)(int)vf * W + (int)uf;
    const float4 nq = __ldg(prev_n + j);
    if (!(nq.w > 0.f)) continue;
    const float4 q = __ldg(prev_v + j);
    const float d0 = __fsub_rn(p[0], q.x);
    const float d1 = __fsub_rn(p[1], q.y);
    const float d2 = __fsub_rn(p[2], q.z);
    const float dd = __fadd_rn(
        __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
    if (!(dd < cam.thr2)) continue;
    const float r = __fadd_rn(
        __fadd_rn(__fmul_rn(d0, nq.x), __fmul_rn(d1, nq.y)),
        __fmul_rn(d2, nq.z));
    const float J[6] = {
        __fsub_rn(__fmul_rn(p[1], nq.z), __fmul_rn(p[2], nq.y)),
        __fsub_rn(__fmul_rn(p[2], nq.x), __fmul_rn(p[0], nq.z)),
        __fsub_rn(__fmul_rn(p[0], nq.y), __fmul_rn(p[1], nq.x)),
        nq.x, nq.y, nq.z};
    int a = 0;
#pragma unroll
    for (int u = 0; u < 6; ++u) {
#pragma unroll
      for (int v = u; v < 6; ++v) acc[a++] += J[u] * J[v];
    }
#pragma unroll
    for (int u = 0; u < 6; ++u) acc[21 + u] += J[u] * r;
    acc[27] += r * r;
    acc[28] += 1.f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    float s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];
    partials[(long long)blockIdx.x * SLOT + threadIdx.x] = s;
  }
}

// T (4x4) = se3_exp(xi) @ T, as the reference's _se3_exp
__device__ void se3_update(const float xi[6], float T[16]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float th = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
  const bool big = th > 1e-8f;
  const float a = big ? sinf(th) / fmaxf(th, 1e-12f) : 1.f;
  const float b = big ? (1.f - cosf(th)) / fmaxf(th * th, 1e-12f) : 0.5f;
  const float c =
      big ? (th - sinf(th)) / fmaxf(th * th * th, 1e-12f) : 1.f / 6.f;
  const float Wh[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = Wh[3 * i] * Wh[j] + Wh[3 * i + 1] * Wh[3 + j] +
                      Wh[3 * i + 2] * Wh[6 + j];
  float E[16] = {0.f};
  for (int i = 0; i < 3; ++i) {
    float tr = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      E[4 * i + j] = id + a * Wh[3 * i + j] + b * W2[3 * i + j];
      tr += (id + b * Wh[3 * i + j] + c * W2[3 * i + j]) * xi[3 + j];
    }
    E[4 * i + 3] = tr;
  }
  E[15] = 1.f;
  float out[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
      for (int k = 0; k < 4; ++k) s += E[4 * i + k] * T[4 * k + j];
      out[4 * i + j] = s;
    }
  for (int k = 0; k < 16; ++k) T[k] = out[k];
}

__global__ void __launch_bounds__(1024)
    icp_solve_kernel(const float* __restrict__ partials, int blocks,
                     float* __restrict__ state, float inv_hw) {
  __shared__ float tot[NT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < NT) {
    float s = 0.f;
    for (int b = lane; b < blocks; b += 32)
      s += partials[(long long)b * SLOT + warp];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) tot[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float A[36], x[6];
  int a = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) A[6 * i + j] = A[6 * j + i] = tot[a++];
  for (int i = 0; i < 6; ++i) x[i] = -tot[21 + i];
  for (int k = 0; k < 36; ++k) state[18 + k] = A[k];
  for (int i = 0; i < 6; ++i) state[54 + i] = x[i];
  state[60] = tot[27];
  state[61] = tot[28];
  // (A + 1e-6 I) xi = b: LU with partial pivoting, then the two triangles
  for (int i = 0; i < 6; ++i) A[7 * i] += 1e-6f;
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[6 * i + k]) > fabsf(A[6 * piv + k])) piv = i;
    if (piv != k) {
      for (int j = 0; j < 6; ++j) {
        const float s = A[6 * k + j];
        A[6 * k + j] = A[6 * piv + j];
        A[6 * piv + j] = s;
      }
      const float s = x[k];
      x[k] = x[piv];
      x[piv] = s;
    }
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[6 * i + k] / A[7 * k];
      for (int j = k + 1; j < 6; ++j) A[6 * i + j] -= l * A[6 * k + j];
      x[i] -= l * x[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    float s = x[k];
    for (int j = k + 1; j < 6; ++j) s -= A[6 * k + j] * x[j];
    x[k] = s / A[7 * k];
  }
  float T[16];
  for (int k = 0; k < 16; ++k) T[k] = state[k];
  se3_update(x, T);
  for (int k = 0; k < 16; ++k) state[k] = T[k];
  const float nw = fmaxf(tot[28], 1.f);
  state[16] = sqrtf(tot[27] / nw);
  state[17] = nw * inv_hw;
}

}  // namespace

// cur, prev_v, prev_n: (H, W, 4) float32, 16-byte aligned; partials:
// MAX_BLOCKS * SLOT = 32768 floats of scratch; state: 62 floats, T at 0-15, read
// and rewritten. thr2 = dist_thresh^2 and inv_hw = 1 / (H W), both in
// float32. Two launches: the sums, then the solve and the update.
extern "C" int i3dr_icp_step(const void* cur, const void* prev_v,
                             const void* prev_n, void* partials, void* state,
                             int H, int W, float fx, float fy, float cx,
                             float cy, float thr2, float inv_hw,
                             void* stream) {
  const long long n = (long long)H * W;
  if (n <= 0 || ((size_t)cur | (size_t)prev_v | (size_t)prev_n) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long want = (n + (long long)TX * PIXELS - 1) / (TX * PIXELS);
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  const Cam cam = {fx, fy, cx, cy, thr2};
  const cudaStream_t s = (cudaStream_t)stream;
  icp_terms_kernel<<<blocks, TX, 0, s>>>(
      (const float4*)cur, (const float4*)prev_v, (const float4*)prev_n, H, W,
      cam, (const float*)state, (float*)partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icp_solve_kernel<<<1, 1024, 0, s>>>((const float*)partials, blocks,
                                      (float*)state, inv_hw);
  return (int)cudaGetLastError();
}
