// gauss_rays, the form with a warp a hole (kernel_probes/probe8.py): a
// block a 64 x 32 tile writes its valid pixels through and lists its holes
// in shared memory; a warp takes a hole of the list, a lane a direction
// (lanes k, k + 32, ... past 32 directions) walking the doubling's
// recursion a leaf at a time, and every lane sums the weights lane by
// lane in direction order by shuffles. Same C entry, table and results as
// csrc/gauss_rays.cu.
#include "common.cuh"

namespace {

constexpr int TX = 64, TY = 32;   // a block's tile
constexpr int THREADS = 256;
constexpr int ROUNDS = 6;   // the one instance: 32 < max_radius <= 64

template <int R>
struct Dir {
  int oy[R], ox[R];
  float len[R];
};

// N(L, (y, x)) of one direction: the state after its first L rounds
template <int R, int L>
__device__ __forceinline__ void node(const float* __restrict__ d,
                                     const unsigned char* __restrict__ v,
                                     int H, int W, int y, int x,
                                     const Dir<R>& dir, float& val,
                                     float& dst) {
  if constexpr (L == 0) {
    const long long i = (long long)y * W + x;
    const bool ok = __ldg(v + i) != 0;
    val = ok ? __ldg(d + i) : 0.f;
    dst = ok ? 0.f : i3dr::BIG;
  } else {
    node<R, L - 1>(d, v, H, W, y, x, dir, val, dst);
    const int dy = dir.oy[L - 1], dx = dir.ox[L - 1];
    // the right subtree's distance is >= 0, so its candidate is >= the
    // round's length: where the left one is no farther it cannot win
    if ((dy != 0 || dx != 0) && dst > dir.len[L - 1]) {
      const int yy = y + dy, xx = x + dx;
      float v2 = 0.f, d2 = i3dr::BIG;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        node<R, L - 1>(d, v, H, W, yy, xx, dir, v2, d2);
      d2 = __fadd_rn(d2, dir.len[L - 1]);
      if (d2 < dst) {
        val = v2;
        dst = d2;
      }
    }
  }
}

// the fill of one hole p = (y, x) by a warp: a lane a direction (lanes
// k, k + 32, ... when there are more than 32), each direction's doubling
// walked as the recursion it unrolls into, then the weights and sums
// taken lane by lane in direction order, the same on every lane
template <int R>
__device__ __forceinline__ void fill_hole(const float* __restrict__ d,
                                          const unsigned char* __restrict__ v,
                                          const float* __restrict__ table,
                                          int H, int W, int y, int x,
                                          int n_dir, float radius,
                                          float inv_two_sig2, float min_rays,
                                          float* out, unsigned char* vout) {
  const int lane = threadIdx.x % 32;
  float wsum = 0.f, vsum = 0.f, nrays = 0.f;
  for (int k0 = 0; k0 < n_dir; k0 += 32) {
    const int k = k0 + lane;
    float w = 0.f, wv = 0.f, h = 0.f;
    if (k < n_dir) {
      const float* row = table + k * 3 * R;
      Dir<R> dir;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dir.oy[r] = __float_as_int(__ldg(row + 2 * r));
        dir.ox[r] = __float_as_int(__ldg(row + 2 * r + 1));
        dir.len[r] = __ldg(row + 2 * R + r);
      }
      float val, dst;
      node<R, R>(d, v, H, W, y, x, dir, val, dst);
      const bool hit = dst < radius;
      w = hit ? expf(__fmul_rn(-__fmul_rn(dst, dst), inv_two_sig2)) : 0.f;
      wv = __fmul_rn(w, val);
      h = hit ? 1.f : 0.f;
    }
    const int n = min(32, n_dir - k0);
    for (int q = 0; q < n; ++q) {
      wsum = __fadd_rn(wsum, __shfl_sync(i3dr::FULL, w, q));
      vsum = __fadd_rn(vsum, __shfl_sync(i3dr::FULL, wv, q));
      nrays = __fadd_rn(nrays, __shfl_sync(i3dr::FULL, h, q));
    }
  }
  if (lane == 0) {
    *out = wsum > 0.f ? __fdiv_rn(vsum, fmaxf(wsum, 1e-20f)) : 0.f;
    *vout = nrays >= min_rays && wsum > 0.f;
  }
}

// table: a row of 3R words a direction, (dy, dx) of each round as int32,
// then each round's length as float32. A block a TX x TY tile: its valid
// pixels pass through, its holes are listed in shared memory, and each
// thread fills holes of the list, so a warp's lanes all work while the
// tile has holes left.
template <int R>
__global__ void __launch_bounds__(THREADS)
    gauss_rays_kernel(const float* __restrict__ d,
                      const unsigned char* __restrict__ v,
                      const float* __restrict__ table, float* __restrict__ out,
                      unsigned char* __restrict__ vout, int H, int W,
                      int n_dir, float radius, float inv_two_sig2,
                      float min_rays) {
  __shared__ unsigned short holes[TX * TY];
  __shared__ int n_holes;
  const long long plane = (long long)blockIdx.z * H * W;
  d += plane;
  v += plane;
  out += plane;
  vout += plane;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  if (threadIdx.x == 0) n_holes = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < TX * TY / THREADS; ++q) {
    const int e = q * THREADS + threadIdx.x;   // the tile's pixel e
    const int x = x0 + e % TX, y = y0 + e / TX;
    const bool in = x < W && y < H;
    const long long i = (long long)y * W + x;
    const bool valid = in && __ldg(v + i) != 0;
    if (valid) {
      out[i] = __ldg(d + i);
      vout[i] = 1;
    }
    const unsigned hole = __ballot_sync(i3dr::FULL, in && !valid);
    int at = 0;
    if (lane == 0 && hole) at = atomicAdd(&n_holes, __popc(hole));
    at = __shfl_sync(i3dr::FULL, at, 0);
    if (in && !valid)
      holes[at + __popc(hole & ((1u << lane) - 1))] = (unsigned short)e;
  }
  __syncthreads();
  for (int h = threadIdx.x / 32; h < n_holes; h += THREADS / 32) {
    const int e = holes[h];
    const int x = x0 + e % TX, y = y0 + e / TX;
    const long long i = (long long)y * W + x;
    fill_hole<R>(d, v, table, H, W, y, x, n_dir, radius, inv_two_sig2,
                 min_rays, out + i, vout + i);
  }
}

}  // namespace

// d: (B, H, W) float32, v / vout: (B, H, W) bool (one byte), table: (n_dir,
// 3 * rounds) as above, rounds = ROUNDS; radius = min(max_radius, BIG / 2),
// inv_two_sig2 = 1 / (2 sigma^2) and min_rays = max(min_elements, 1), in
// float32.
extern "C" int i3dr_gauss_rays(const void* d, const void* v,
                               const void* table, void* out, void* vout,
                               int B, int H, int W, int n_dir, int rounds,
                               float radius, float inv_two_sig2,
                               float min_rays,
                               void* stream) {
  if ((long long)B * H * W == 0) return 0;
  if (B > 65535 || n_dir < 1 || rounds != ROUNDS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  gauss_rays_kernel<ROUNDS><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const unsigned char*)v, (const float*)table,
      (float*)out, (unsigned char*)vout, H, W, n_dir, radius, inv_two_sig2,
      min_rays);
  return (int)cudaGetLastError();
}
