// icp_step — projective point-to-plane ICP on the card: every Gauss-Newton
// step of every pyramid level of a track (coarse to fine) in one
// cooperative launch; one step from a given state is the same launch with
// one level of one step.
//
// Replaces no Pallas kernel: the reference's iteration is XLA
// (i3dr_stereo_tpu/mapping/odometry.py · _icp_level, :112-151), which the
// plain torch twin (mapping/odometry.py · icp_step_plain) runs as ~60
// launches over (H, W, 3) and (H, W, 6) intermediates a step.
//
// What a step computes. Maps are float32: cur (H, W, 4) = [vertex, valid]
// of the current frame, read in order; rec (H, W, 8) = [vertex, valid,
// normal, ok] of the previous frame, one 32-byte record a pixel, gathered
// at the hit pixel. T is the state's 4x4 (T_pc, row-major). For every
// current pixel with valid > 0:
//   p = R v + t, each row ((v0 R_r0 + v1 R_r1) + v2 R_r2) + t_r
//   u = (fx p0) / max(p2, 1e-9) + cx,  v = (fy p1) / max(p2, 1e-9) + cy
//   ui, vi = rint(u), rint(v) (half to even, as jnp.round); in bounds:
//   p2 > 1e-6 and 0 <= ui < W and 0 <= vi < H (compared as floats, which
//   is what a saturating int cast gives)
//   q, n, ok = the record at (vi, ui);  d = p - q
//   the pixel counts where ok > 0 and ((d0 d0 + d1 d1) + d2 d2) < thr2:
//   r = (d0 n0 + d1 n1) + d2 n2, J = [p x n; n],
//   A += J J^T (21 entries), Jr += J r, sum r^2 += r r, sum w += 1.
// The per-pixel arithmetic is the twin's, rounded op by op (so kernel and
// twin pair the same pixels); the sums are not the twin's order.
// Then, with b = -Jr: xi = solve(A + 1e-6 I, b) (LU with partial
// pivoting, as getrf / getrs), T = se3_exp(xi) @ T (Rodrigues with the
// reference's small-angle forms), rmse = sqrt(sum r^2 / max(sum w, 1)),
// frac = max(sum w, 1) * inv_hw (XLA's product by the reciprocal of the
// constant H * W). rmse and frac are zeroed where a level starts, as the
// reference's _icp_level does, so a level of no step leaves them 0. The
// state after the launch: T (0-15), rmse (16), frac (17), and of the last
// step A undamped (18-53, row-major), b (54-59), sum r^2 (60), sum w (61).
//
// Design. A persistent grid, as many blocks of 256 threads as the card
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs,
// fewer for a small map), launched cooperatively in the caller's stream:
// - a thread strides over the pixels PIX at a time: the PIX current
//   pixels loaded together, then the 2 PIX gathers of their records
//   issued together before any is tested; its 29 sums stay in registers;
// - a block adds its threads' sums (a butterfly of shuffles a warp, its 8
//   warps in order) and writes them to its slot of the step's partials,
//   double-buffered by the parity of the step;
// - one grid barrier; then every block adds all blocks' partials in one
//   fixed order (read through L2, 16 bytes a thread, loads together), and
//   one thread of each block solves and updates its copy of T in shared
//   memory, the 6x6 system in registers. Every block computes the same
//   bits, so no second barrier publishes T, and the next step's partials
//   go to the other buffer while slow blocks still read these.
// No float atomics and no host sync: reruns give identical states.
//
// What bounds it on the card: bytes. The function needs 38 a pixel and
// step (the current vertex and valid flag, the previous vertex, normal
// and ok flag: 190 MB a step at 2448x2048, 0.057 ms at 3.35 TB/s); read
// here are 16 in order and one 32-byte sector of a hit record. Its ~100
// float operations a matched pixel stay below the float32 rate. At the
// coarse levels a step is mostly its fixed cost: the barrier, reading the
// partials and the serial 6x6 solve (~10 us on an H100).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TX = 256;
constexpr int WARPS = TX / 32;
constexpr int NT = 29;           // 21 of A, 6 of J r, sum r^2, sum w
constexpr int SLOT = 32;         // floats of a block's partial sums
constexpr int MAX_BLOCKS = 2048;
constexpr int MAX_LEVELS = 8;
// pixels a thread keeps in flight, and blocks an SM holds (<= 128
// registers): the fastest pair on an H100 of 1, 2, 4, 8 and 1-4 blocks
// (kernel_probes/probe10.py at commit 1dd326f)
constexpr int PIX = 4;
constexpr int MIN_BLOCKS = 2;
constexpr long long MAX_PIXELS = 1LL << 30;
constexpr unsigned FULL = 0xffffffffu;

struct Level {
  const float4* cur;   // (H W) float4: [x, y, z, valid]
  const float4* rec;   // (H W) pairs of float4: [x, y, z, valid], [n, ok]
  int H, W, iters;
  float fx, fy, cx, cy, inv_hw;
};

struct Track {
  Level lv[MAX_LEVELS];
  int n;
  float thr2;
};

// this thread's share of one step's sums over a level's pixels
__device__ __forceinline__ void accumulate(const Level& L, float thr2,
                                           const float* T, float acc[NT]) {
  float R[9], t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[3 * r + c] = T[4 * r + c];
    t[r] = T[4 * r + 3];
  }
  const int n = L.H * L.W;
  const int stride = gridDim.x * TX;
  const float Wf = (float)L.W, Hf = (float)L.H;
  for (int base = blockIdx.x * TX + threadIdx.x; base < n;
       base += PIX * stride) {
    float4 c[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int i = base + k * stride;
      c[k] = i < n ? __ldg(L.cur + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float p[PIX][3];
    int j[PIX];
    bool go[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
        p[k][r] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(c[k].x, R[3 * r]),
                                __fmul_rn(c[k].y, R[3 * r + 1])),
                      __fmul_rn(c[k].z, R[3 * r + 2])),
            t[r]);
      const float pz = fmaxf(p[k][2], 1e-9f);
      const float uf = rintf(
          __fadd_rn(__fdiv_rn(__fmul_rn(L.fx, p[k][0]), pz), L.cx));
      const float vf = rintf(
          __fadd_rn(__fdiv_rn(__fmul_rn(L.fy, p[k][1]), pz), L.cy));
      go[k] = c[k].w > 0.f && p[k][2] > 1e-6f && uf >= 0.f && uf < Wf &&
              vf >= 0.f && vf < Hf;
      j[k] = go[k] ? (int)vf * L.W + (int)uf : 0;
    }
    float4 q[PIX], nq[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      if (go[k]) {
        q[k] = __ldg(L.rec + 2 * j[k]);
        nq[k] = __ldg(L.rec + 2 * j[k] + 1);
      } else {
        q[k] = nq[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      if (!(go[k] && nq[k].w > 0.f)) continue;
      const float d0 = __fsub_rn(p[k][0], q[k].x);
      const float d1 = __fsub_rn(p[k][1], q[k].y);
      const float d2 = __fsub_rn(p[k][2], q[k].z);
      const float dd = __fadd_rn(
          __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
      if (!(dd < thr2)) continue;
      const float r = __fadd_rn(
          __fadd_rn(__fmul_rn(d0, nq[k].x), __fmul_rn(d1, nq[k].y)),
          __fmul_rn(d2, nq[k].z));
      const float J[6] = {
          __fsub_rn(__fmul_rn(p[k][1], nq[k].z), __fmul_rn(p[k][2], nq[k].y)),
          __fsub_rn(__fmul_rn(p[k][2], nq[k].x), __fmul_rn(p[k][0], nq[k].z)),
          __fsub_rn(__fmul_rn(p[k][0], nq[k].y), __fmul_rn(p[k][1], nq[k].x)),
          nq[k].x, nq[k].y, nq[k].z};
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
  }
}

// T (4x4) = se3_exp(xi) @ T, as the reference's _se3_exp
__device__ __forceinline__ void se3_update(const float xi[6], float T[16]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float th = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
  const bool big = th > 1e-8f;
  const float a = big ? sinf(th) / fmaxf(th, 1e-12f) : 1.f;
  const float b = big ? (1.f - cosf(th)) / fmaxf(th * th, 1e-12f) : 0.5f;
  const float c =
      big ? (th - sinf(th)) / fmaxf(th * th * th, 1e-12f) : 1.f / 6.f;
  const float Wh[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = Wh[3 * i] * Wh[j] + Wh[3 * i + 1] * Wh[3 + j] +
                      Wh[3 * i + 2] * Wh[6 + j];
  float E[16] = {0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float tr = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      E[4 * i + j] = id + a * Wh[3 * i + j] + b * W2[3 * i + j];
      tr += (id + b * Wh[3 * i + j] + c * W2[3 * i + j]) * xi[3 + j];
    }
    E[4 * i + 3] = tr;
  }
  E[15] = 1.f;
  float out[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += E[4 * i + k] * T[4 * k + j];
      out[4 * i + j] = s;
    }
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = out[k];
}

// from the step's sums: xi = solve(A + 1e-6 I, -Jr), T = se3_exp(xi) @ T,
// rmse and frac (out[0], out[1]). Every loop is unrolled and the pivot's
// row swap is a predicated exchange, so the system stays in registers.
__device__ __forceinline__ void solve_update(const float tot[NT],
                                             float inv_hw, float T[16],
                                             float out[2]) {
  float A[6][6], x[6];
  int a = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) A[i][j] = A[j][i] = tot[a++];
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = -tot[21 + i];
  // (A + 1e-6 I) xi = b: LU with partial pivoting, then the two triangles
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] += 1e-6f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float top = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > top) {
        top = fabsf(A[i][k]);
        piv = i;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool swap = i == piv;
#pragma unroll
      for (int j = k; j < 6; ++j) {
        const float s = A[k][j];
        A[k][j] = swap ? A[i][j] : s;
        A[i][j] = swap ? s : A[i][j];
      }
      const float s = x[k];
      x[k] = swap ? x[i] : s;
      x[i] = swap ? s : x[i];
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      x[i] -= l * x[k];
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float s = x[k];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) s -= A[k][j] * x[j];
    x[k] = s / A[k][k];
  }
  float Tl[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) Tl[k] = T[k];
  se3_update(x, Tl);
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = Tl[k];
  const float nw = fmaxf(tot[NT - 1], 1.f);
  out[0] = sqrtf(tot[NT - 2] / nw);
  out[1] = nw * inv_hw;
}

__global__ void __launch_bounds__(TX, MIN_BLOCKS)
    icp_track_kernel(const __grid_constant__ Track tr,
                     float* __restrict__ partials,
                     float* __restrict__ state) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[WARPS][SLOT];
  __shared__ float tot[NT];
  __shared__ float T[16];
  __shared__ float out[2];         // rmse, frac
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 16) T[threadIdx.x] = state[threadIdx.x];
  if (threadIdx.x == 16) out[0] = state[16];
  if (threadIdx.x == 17) out[1] = state[17];
  __syncthreads();
  int step = 0;
  for (int l = 0; l < tr.n; ++l) {
    const Level& L = tr.lv[l];
    if (threadIdx.x == 0) out[0] = out[1] = 0.f;
    for (int it = 0; it < L.iters; ++it, ++step) {
      float acc[NT];
#pragma unroll
      for (int k = 0; k < NT; ++k) acc[k] = 0.f;
      accumulate(L, tr.thr2, T, acc);
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        float s = acc[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        if (lane == 0) red[warp][k] = s;
      }
      __syncthreads();
      float* part = partials + (size_t)(step & 1) * gridDim.x * SLOT;
      if (threadIdx.x < NT) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];
        part[(size_t)blockIdx.x * SLOT + threadIdx.x] = s;
      }
      grid.sync();
      // every block: all blocks' partials in one fixed order, through L2;
      // thread t adds quarter t % 8 (16 bytes) of the lines of blocks
      // t / 8, t / 8 + 32, ..., its loads issued together; then lanes 8
      // and 16 apart, then the 8 warps in order
      {
        const int q = threadIdx.x & 7;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int b = threadIdx.x >> 3; b < (int)gridDim.x; b += TX / 8) {
          const float4 w =
              __ldcg((const float4*)(part + (size_t)b * SLOT) + q);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
#pragma unroll
        for (int o = 8; o < 32; o <<= 1) {
          v.x += __shfl_xor_sync(FULL, v.x, o);
          v.y += __shfl_xor_sync(FULL, v.y, o);
          v.z += __shfl_xor_sync(FULL, v.z, o);
          v.w += __shfl_xor_sync(FULL, v.w, o);
        }
        if (lane < 8) {
          red[warp][4 * q] = v.x;
          red[warp][4 * q + 1] = v.y;
          red[warp][4 * q + 2] = v.z;
          red[warp][4 * q + 3] = v.w;
        }
        __syncthreads();
        if (threadIdx.x < NT) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) t += red[w][threadIdx.x];
          tot[threadIdx.x] = t;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) solve_update(tot, L.inv_hw, T, out);
      __syncthreads();
    }
  }
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  for (int k = 0; k < 16; ++k) state[k] = T[k];
  state[16] = out[0];
  state[17] = out[1];
  if (step == 0) return;           // no step: the sums stay as they were
  int a = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) {
      state[18 + 6 * i + j] = state[18 + 6 * j + i] = tot[a];
      ++a;
    }
  for (int i = 0; i < 6; ++i) state[54 + i] = -tot[21 + i];
  state[60] = tot[27];
  state[61] = tot[28];
}

}  // namespace

// The grid of a track whose largest level has max_pixels pixels, on the
// current device: the blocks the card holds at once, fewer where the map
// gives a thread under PIX pixels. Sized once per card and shape.
extern "C" int i3dr_icp_grid(long long max_pixels, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icp_track_kernel, TX, 0);
  if (err != cudaSuccess) return (int)err;
  long long b = (max_pixels + (long long)TX * PIX - 1) / ((long long)TX * PIX);
  const long long most = (long long)sms * per_sm;
  if (b > most) b = most;
  if (b > MAX_BLOCKS) b = MAX_BLOCKS;
  *blocks = (int)(b < 1 ? 1 : b);
  return 0;
}

// A whole track, one cooperative launch. n levels, run in order (coarse to
// fine): maps[2 l], maps[2 l + 1] = level l's cur (16-byte aligned) and rec
// (32-byte aligned); dims[3 l..] = H, W, steps; cams[5 l..] = fx, fy, cx,
// cy, inv_hw (1 / (H W) in float32). thr2 = dist_thresh^2 in float32.
// partials: 2 * blocks * 32 floats of scratch; state: 64 floats, T read
// and the state rewritten. A grid the card cannot hold at once fails with
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int i3dr_icp_track(int n, const unsigned long long* maps,
                              const int* dims, const float* cams, float thr2,
                              void* partials, void* state, int blocks,
                              void* stream) {
  if (n < 0 || n > MAX_LEVELS || blocks < 1 || blocks > MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  Track tr = {};
  tr.n = n;
  tr.thr2 = thr2;
  for (int l = 0; l < n; ++l) {
    Level& L = tr.lv[l];
    L.cur = (const float4*)maps[2 * l];
    L.rec = (const float4*)maps[2 * l + 1];
    L.H = dims[3 * l];
    L.W = dims[3 * l + 1];
    L.iters = dims[3 * l + 2];
    L.fx = cams[5 * l];
    L.fy = cams[5 * l + 1];
    L.cx = cams[5 * l + 2];
    L.cy = cams[5 * l + 3];
    L.inv_hw = cams[5 * l + 4];
    if (L.H < 1 || L.W < 1 || (long long)L.H * L.W > MAX_PIXELS ||
        L.iters < 0 || maps[2 * l] % 16 != 0 || maps[2 * l + 1] % 32 != 0)
      return (int)cudaErrorInvalidValue;
  }
  float* p = (float*)partials;
  float* s = (float*)state;
  void* args[] = {&tr, &p, &s};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)icp_track_kernel, dim3(blocks), dim3(TX), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}
