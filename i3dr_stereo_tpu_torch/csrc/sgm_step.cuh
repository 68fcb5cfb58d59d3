// One step of the SGM recurrence for a warp that holds one pixel's D
// disparities in registers, K consecutive disparities per lane
// (d = lane * K + k), at the exact D <= 32 * K: the disparities past D
// are absent, not invalid-cost lanes.
//
//   L(d) = (c(d) + min(prev(d), prev(d-1) + P1, prev(d+1) + P1, m + P2)) - m
//   m = min_k prev(k),  prev(-1) = prev(D) = 1e9
//
// the reference's float32 sequence (sgm_pallas._step), rounded per
// operation, so a kernel built on it equals its torch twin bit for bit.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace i3dr {

// the smallest supported K with 32 * K >= D (0: D is out of range)
inline int lanes_k(int D) {
  const int ks[] = {1, 2, 4, 8, 12, 16};
  for (int k : ks)
    if (D >= 1 && D <= WARP * k) return k;
  return 0;
}

// `last` = D - 1 - lane * K: the index k of the volume's last disparity
// in this lane (negative: the lane holds none; >= K: it holds K, none of
// them the last). An absent disparity keeps prev = +inf, so it never
// sets the minimum, and the last one sees 1e9 above it. The minimum over
// the warp is its hardware reduction (common.cuh). Against the five-shuffle
// butterfly, at 1x1024x1280: fused_bt_fwd (D = 128, int16) 0.423 -> 0.386
// ms; census_fwd_kernel, 10 calls back to back, D = 64 0.576-0.584 ->
// 0.521-0.538 and D = 128 0.784-0.787 -> 0.720-0.727; the sgm_volume
// chain (8 paths, D = 64 and 128) 1-3 % faster with float32 costs and
// within 1 % with uint8 (kernel_probes/warp_min.py at commit 1dd326f;
// NVIDIA H100 80GB HBM3, 700 W).
template <int K>
__device__ __forceinline__ void sgm_step(const float (&prev)[K],
                                         const float (&c)[K], float (&L)[K],
                                         int lane, int last, float p1,
                                         float p2) {
  float lm = prev[0];
#pragma unroll
  for (int k = 1; k < K; ++k) lm = fminf(lm, prev[k]);
  const float m = warp_min(lm);
  float up = __shfl_up_sync(FULL, prev[K - 1], 1);  // L(d-1)
  float dn = __shfl_down_sync(FULL, prev[0], 1);    // L(d+1)
  if (lane == 0) up = BIG;
  const float mp2 = __fadd_rn(m, p2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float lo = k == 0 ? up : prev[k - 1];
    const float hi = k == last ? BIG : (k == K - 1 ? dn : prev[k + 1]);
    const float best = fminf(fminf(prev[k], mp2),
                             fminf(__fadd_rn(lo, p1), __fadd_rn(hi, p1)));
    L[k] = k <= last ? __fsub_rn(__fadd_rn(c[k], best), m) : CUDART_INF_F;
  }
}

}  // namespace i3dr
