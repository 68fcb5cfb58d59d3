// Shared constants and warp reductions of the port's kernels.
//
// The SGM kernels put the D = 32 disparities of one pixel on the 32
// lanes of one warp (PAPERS.md [1], arXiv 1610.04121): min over d is a
// butterfly of shuffles, and the d-1 / d+1 neighbours of the recurrence
// are one shuffle up / down.
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

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

}  // namespace i3dr
