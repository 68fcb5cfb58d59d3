// gauss_rays, the rounds form (kernel_probes/probe8.py): the reference's
// doubling rounds run on a shared-memory tile, a byte of state a pixel.
// Same C entry, table and results as csrc/gauss_rays.cu.
//
// A block a T x T output tile; a tile without a hole writes its pixels
// through. Else it stages the valid mask of the tile and a halo of
// 2^R - 1 px on every side (the largest |sum of offsets| of a direction)
// as states, and for each direction in order runs the rounds over the
// region each needs (the tile extended by the later rounds' offsets),
// ping-ponging two buffers. A state is 255 (no support, BIG) or the
// subset of rounds taken so far (a valid pixel: the empty one, 0): its
// distance is the float32 sum of the rounds' lengths in round order
// (a table of 2^R entries a direction, built the way the twin adds), its
// value d at p + the subset's offsets, read once after the last round. A
// word of four states that are all 0 (valid pixels) never changes and is
// skipped.
#include "common.cuh"

namespace {

constexpr int T = 32;                       // output tile
constexpr int THREADS = 256;                // 32 rows x 8 words
constexpr int R = 6;                        // rounds: 32 < radius <= 64
constexpr int H0 = (1 << R) - 1;            // halo a side
constexpr int BOX = T + 2 * H0;             // rows and columns of the box
// column c of the box at byte OFF + c of its row: the tile's columns
// word-aligned, and 5-8 bytes of slack on each side for the word cover of
// a region and its shifted read
constexpr int OFF = 5 + (4 - (5 + H0) % 4) % 4;
constexpr int PITCH = (OFF + BOX + 11 + 3) / 4 * 4;
constexpr int BUF = PITCH * BOX;
constexpr unsigned char NONE = 255;

__device__ __forceinline__ unsigned load_word(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(THREADS)
    gauss_rays_kernel(const float* __restrict__ d,
                      const unsigned char* __restrict__ v,
                      const float* __restrict__ table, float* __restrict__ out,
                      unsigned char* __restrict__ vout, int H, int W,
                      int n_dir, float radius, float inv_two_sig2,
                      float min_rays) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* M = smem;                  // the initial states
  unsigned char* bufs[2] = {smem + BUF, smem + 2 * BUF};
  float* dstS = reinterpret_cast<float*>(smem + 3 * BUF);   // [256]
  short2* offS = reinterpret_cast<short2*>(dstS + 256);       // [64]
  __shared__ int oy_s[R], ox_s[R];
  __shared__ float len_s[R];

  const long long plane = (long long)blockIdx.z * H * W;
  d += plane;
  v += plane;
  out += plane;
  vout += plane;
  const int tx0 = blockIdx.x * T, ty0 = blockIdx.y * T;
  const int ty = threadIdx.x / 8, wq = threadIdx.x % 8;
  const int y = ty0 + ty;
  // this thread's four pixels: valid bits, holes
  unsigned holes = 0;
  float dv[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int x = tx0 + 4 * wq + b;
    dv[b] = 0.f;
    if (y < H && x < W) {
      const long long i = (long long)y * W + x;
      if (__ldg(v + i)) {
        dv[b] = __ldg(d + i);
        out[i] = dv[b];
        vout[i] = 1;
      } else {
        holes |= 1u << b;
      }
    }
  }
  if (!__syncthreads_or(holes != 0)) return;

  // the box's states, in M and both buffers
  const int gy0 = ty0 - H0, gx0 = tx0 - H0;
  for (int e = threadIdx.x; e < BOX * (PITCH / 4); e += THREADS) {
    const int ry = e / (PITCH / 4), wc = e % (PITCH / 4);
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gy = gy0 + ry, gx = gx0 + wc * 4 + b - OFF;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W &&
                      __ldg(v + (long long)gy * W + gx) != 0;
      word |= (ok ? 0u : (unsigned)NONE) << (8 * b);
    }
    const int at = ry * PITCH + wc * 4;
    *reinterpret_cast<unsigned*>(M + at) = word;
    *reinterpret_cast<unsigned*>(bufs[0] + at) = word;
    *reinterpret_cast<unsigned*>(bufs[1] + at) = word;
  }
  if (threadIdx.x == 0) dstS[255] = i3dr::BIG;

  float wsum[4] = {0.f, 0.f, 0.f, 0.f}, vsum[4] = {0.f, 0.f, 0.f, 0.f},
        nrays[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < n_dir; ++k) {
    __syncthreads();   // the previous direction is done with the tables
    const float* row = table + k * 3 * R;
    if (threadIdx.x < R) {
      oy_s[threadIdx.x] = __float_as_int(__ldg(row + 2 * threadIdx.x));
      ox_s[threadIdx.x] = __float_as_int(__ldg(row + 2 * threadIdx.x + 1));
      len_s[threadIdx.x] = __ldg(row + 2 * R + threadIdx.x);
    }
    __syncthreads();
    if (threadIdx.x < (1 << R)) {   // a subset's distance and offsets
      const int S = threadIdx.x;
      float acc = 0.f;
      int sy = 0, sx = 0;
      for (int r = 0; r < R; ++r)
        if (S >> r & 1) {
          acc = __fadd_rn(acc, len_s[r]);
          sy += oy_s[r];
          sx += ox_s[r];
        }
      dstS[S] = acc;
      offS[S] = make_short2((short)sy, (short)sx);
    }
    // the later rounds' offsets, summed: the region of round r is the
    // tile extended by them
    int ey[R], ex[R];
    {
      int sy = 0, sx = 0;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        ey[r] = sy;
        ex[r] = sx;
        sy += oy_s[r];
        sx += ox_s[r];
      }
    }
    __syncthreads();
    const unsigned char* src = M;
    int cur = 0;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const int oy = oy_s[r], ox = ox_s[r];
      if (oy == 0 && ox == 0) continue;
      unsigned char* dst = bufs[cur];
      const unsigned bit = 1u << r;
      const int ry0 = H0 + min(0, ey[r]), ry1 = H0 + T + max(0, ey[r]);
      const int rx0 = H0 + min(0, ex[r]), rx1 = H0 + T + max(0, ex[r]);
      const int wc0 = (OFF + rx0) >> 2, wc1 = (OFF + rx1 + 3) >> 2;
      const int nw = wc1 - wc0, n = (ry1 - ry0) * nw;
      const int shift = oy * PITCH + ox;
      for (int e = threadIdx.x; e < n; e += THREADS) {
        const int ry = ry0 + e / nw, wc = wc0 + e % nw;
        const int at = ry * PITCH + wc * 4;
        const unsigned sw = load_word(src + at);
        if (sw == 0) continue;   // four valid pixels
        const int to = at + shift, a0 = to & ~3;
        const unsigned tw = __byte_perm(load_word(src + a0),
                                        load_word(src + a0 + 4),
                                        0x3210 + (to & 3) * 0x1111);
        const int gy = gy0 + ry;
        unsigned word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const unsigned s = sw >> (8 * b) & 255u;
          const unsigned c = (tw >> (8 * b) & 255u) | bit;
          unsigned nb = dstS[c] < dstS[s] ? c : s;
          const int gx = gx0 + wc * 4 + b - OFF;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) nb = NONE;
          word |= nb << (8 * b);
        }
        *reinterpret_cast<unsigned*>(dst + at) = word;
      }
      __syncthreads();
      src = dst;
      cur ^= 1;
    }
    // this direction's hit, weight and sums on the thread's holes
    if (holes) {
      const unsigned fw = load_word(src + (H0 + ty) * PITCH + OFF + H0 +
                                    4 * wq);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (!(holes >> b & 1)) continue;
        const unsigned s = fw >> (8 * b) & 255u;
        const float dst = dstS[s];
        float val = 0.f;
        if (s != NONE) {
          const short2 o = offS[s];
          val = __ldg(d + (long long)(y + o.x) * W + (tx0 + 4 * wq + b + o.y));
        }
        const bool hit = dst < radius;
        const float w =
            hit ? expf(__fmul_rn(-__fmul_rn(dst, dst), inv_two_sig2)) : 0.f;
        wsum[b] = __fadd_rn(wsum[b], w);
        vsum[b] = __fadd_rn(vsum[b], __fmul_rn(w, val));
        nrays[b] = __fadd_rn(nrays[b], hit ? 1.f : 0.f);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (!(holes >> b & 1)) continue;
    const long long i = (long long)y * W + tx0 + 4 * wq + b;
    out[i] = wsum[b] > 0.f ? __fdiv_rn(vsum[b], fmaxf(wsum[b], 1e-20f)) : 0.f;
    vout[i] = nrays[b] >= min_rays && wsum[b] > 0.f;
  }
}

}  // namespace

extern "C" int i3dr_gauss_rays(const void* d, const void* v,
                               const void* table, void* out, void* vout,
                               int B, int H, int W, int n_dir, int rounds,
                               float radius, float inv_two_sig2,
                               float min_rays, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  if (B > 65535 || n_dir < 1 || rounds != R)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 3 * BUF + 256 * sizeof(float) + 64 * sizeof(short2);
  const cudaError_t e = cudaFuncSetAttribute(
      gauss_rays_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  gauss_rays_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)d, (const unsigned char*)v, (const float*)table,
      (float*)out, (unsigned char*)vout, H, W, n_dir, radius, inv_two_sig2,
      min_rays);
  return (int)cudaGetLastError();
}
