// Shared constants and warp reductions of the port's kernels.
//
// The SGM kernels put the disparities of one pixel on the lanes of a warp,
// or of an aligned group of its lanes (PAPERS.md [1], arXiv 1610.04121):
// min over d is a butterfly of shuffles, and the d-1 / d+1 neighbours of
// the recurrence are one shuffle up / down.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace i3dr {

constexpr float BIG = 1.0e9f;       // cost of an invalid (sentinel) pairing
constexpr float CLAMP = 10000.0f;   // per-direction partial-sum clamp
constexpr float NODATA = -1.0e9f;   // invalid-pixel marker of the WTA
constexpr int SENTINEL = 255;       // uint8 cost of an invalid pairing
constexpr int WARP = 32;            // = D, disparities per pixel
constexpr unsigned FULL = 0xffffffffu;

// min over each aligned group of LANES lanes (a power of two)
template <int LANES>
__device__ __forceinline__ float lanes_min(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  return lanes_min<WARP>(v);
}

}  // namespace i3dr
