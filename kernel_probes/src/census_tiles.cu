// Probe variant of the census transform (kernel_probes/probe9.py): the
// parent's census_fixed_kernel with a block walking TILES tiles along x,
// each tile copied in by cp.async (an element at a time, its address
// found by a division) into one of two buffers while the one before is
// computed; census_any_kernel as it is.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int COLS = 32;        // output columns of a block: one a lane
constexpr int FIX_WARPS = 4;    // warps of a fixed-window block, along y
constexpr int FIX_ROWS = 8;     // output rows of a fixed-window thread
constexpr int TILES = 4;        // tiles of a fixed-window block, along x
constexpr int ANY_ROWS = 8;     // output rows of a run-time-window block

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

template <int WH, int WW>
__global__ void __launch_bounds__(COLS* FIX_WARPS)
    census_fixed_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, int* __restrict__ oa,
                        int* __restrict__ ob, int B, int H, int W) {
  constexpr int PH = WH / 2, PW = WW / 2;
  constexpr int CENTRE = PH * WW + PW;
  constexpr int NW = (WH * WW - 1 + 31) / 32;
  constexpr int TH = FIX_WARPS * FIX_ROWS + WH - 1, TW = COLS + WW - 1;
  __shared__ float tile[2][TH][TW];

  const int z = blockIdx.z;
  const bool second = z >= B;
  const long long plane = (long long)H * W;
  const float* img = (second ? b : a) + (second ? z - B : z) * plane;
  int* out = (second ? ob : oa) + (second ? z - B : z) * plane * NW;
  const int y0 = blockIdx.y * (FIX_WARPS * FIX_ROWS);
  const int tile0 = blockIdx.x * TILES;   // this block's first tile along x
  const int tiles = min(TILES, (W + COLS - 1) / COLS - tile0);
  // a tile and its halo into buffer buf by cp.async, one group
  auto fill = [&](int buf, int x0) {
    for (int i = threadIdx.y * COLS + threadIdx.x; i < TH * TW;
         i += COLS * FIX_WARPS) {
      const int r = i / TW, c = i - r * TW;
      __pipeline_memcpy_async(
          &tile[buf][r][c],
          img + (long long)clampi(y0 - PH + r, H - 1) * W +
              clampi(x0 - PW + c, W - 1),
          4);
    }
    __pipeline_commit();
  };
  fill(0, tile0 * COLS);

  const int tx = threadIdx.x, ty = threadIdx.y * FIX_ROWS;
  for (int t = 0; t < tiles; ++t) {
    // the next tile's copies go out before this one is read
    if (t + 1 < tiles) {
      fill((t + 1) & 1, (tile0 + t + 1) * COLS);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float(*tl)[TW] = tile[t & 1];
    float centre[FIX_ROWS];
    unsigned words[FIX_ROWS][NW];
#pragma unroll
    for (int r = 0; r < FIX_ROWS; ++r) {
      centre[r] = tl[ty + r + PH][tx + PW];
#pragma unroll
      for (int k = 0; k < NW; ++k) words[r][k] = 0u;
    }
#pragma unroll
    for (int s = 0; s < FIX_ROWS + WH - 1; ++s) {
      float v[WW];
#pragma unroll
      for (int dx = 0; dx < WW; ++dx) v[dx] = tl[ty + s][tx + dx];
#pragma unroll
      for (int r = 0; r < FIX_ROWS; ++r) {
        const int dy = s - r;
        if (dy < 0 || dy >= WH) continue;
#pragma unroll
        for (int dx = 0; dx < WW; ++dx) {
          const int k = dy * WW + dx;
          if (k == CENTRE) continue;
          const int i = k < CENTRE ? k : k - 1;
          if (v[dx] > centre[r]) words[r][i / 32] |= 1u << (i % 32);
        }
      }
    }

    const int x = (tile0 + t) * COLS + tx;
    if (x < W) {
#pragma unroll
      for (int r = 0; r < FIX_ROWS; ++r) {
        const int y = y0 + ty + r;
        if (y >= H) break;
        int* o = out + ((long long)y * W + x) * NW;
#pragma unroll
        for (int k = 0; k < NW; ++k) o[k] = (int)words[r][k];
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }
}

__global__ void __launch_bounds__(COLS* ANY_ROWS)
    census_any_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, int* __restrict__ oa,
                      int* __restrict__ ob, int B, int H, int W, int wh,
                      int ww, int nw) {
  const int ph = wh / 2, pw = ww / 2;
  const int z = blockIdx.z;
  const bool second = z >= B;
  const long long plane = (long long)H * W;
  const float* img = (second ? b : a) + (second ? z - B : z) * plane;
  int* out = (second ? ob : oa) + (second ? z - B : z) * plane * nw;
  const int x = blockIdx.x * COLS + threadIdx.x;
  const int y = blockIdx.y * ANY_ROWS + threadIdx.y;
  if (x >= W || y >= H) return;
  auto at = [&](int dy, int dx) {
    return __ldg(img + (long long)clampi(y - ph + dy, H - 1) * W +
                 clampi(x - pw + dx, W - 1));
  };
  const float c = at(ph, pw);
  const int centre = ph * ww + pw, nb = wh * ww - 1;
  int p = 0, dy = 0, dx = 0;  // window position p = dy * ww + dx
  auto step = [&]() {
    ++p;
    if (++dx == ww) dx = 0, ++dy;
  };
  int* o = out + ((long long)y * W + x) * nw;
  for (int k = 0; k < nw; ++k) {
    unsigned word = 0u;
    const int n = min(32, nb - 32 * k);
    for (int bit = 0; bit < n; ++bit) {
      if (p == centre) step();
      word |= (unsigned)(at(dy, dx) > c) << bit;
      step();
    }
    o[k] = (int)word;
  }
}

}  // namespace

// a, b: (B, H, W) float32 images (b null for one image); oa, ob: (B, H, W,
// NW) int32 words, NW = ceil((wh * ww - 1) / 32); wh, ww odd.
extern "C" int i3dr_census_transform(const void* a, const void* b, void* oa,
                                     void* ob, int B, int H, int W, int wh,
                                     int ww, void* stream) {
  if (wh < 1 || ww < 1 || wh % 2 == 0 || ww % 2 == 0 || wh * ww < 2)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  const int images = b ? 2 : 1;
  if ((long long)B * images > 65535 || (b == nullptr) != (ob == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned gx = (W + COLS - 1) / COLS;
  if (wh == 9 && ww == 9) {
    const dim3 grid((gx + TILES - 1) / TILES,
                    (H + FIX_WARPS * FIX_ROWS - 1) / (FIX_WARPS * FIX_ROWS),
                    B * images);
    census_fixed_kernel<9, 9><<<grid, dim3(COLS, FIX_WARPS), 0, s>>>(
        (const float*)a, (const float*)b, (int*)oa, (int*)ob, B, H, W);
  } else {
    const int nw = (wh * ww - 1 + 31) / 32;
    const dim3 grid(gx, (H + ANY_ROWS - 1) / ANY_ROWS, B * images);
    census_any_kernel<<<grid, dim3(COLS, ANY_ROWS), 0, s>>>(
        (const float*)a, (const float*)b, (int*)oa, (int*)ob, B, H, W, wh, ww,
        nw);
  }
  return (int)cudaGetLastError();
}
