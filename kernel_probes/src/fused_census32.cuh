// fused_census32 — the census cost and the forward-horizontal SGM pass in
// one sweep at D = 32 (entry fused_census_fwd of fused_cost_sgm.cu, which
// states the contract).
#pragma once

#include <cuda_runtime.h>

namespace i3dr {

// whether the kernel takes this shape (D = 32 and NW census words whose
// tiles fit a block's shared memory)
bool fused_census32_takes(int D, int NW);

// Launch it; the arguments are i3dr_fused_census_fwd's. Returns
// cudaGetLastError().
int fused_census32(const void* cl, const void* cr, const void* base, int th,
                   void* C, void* S, int s_i16, int B, int H, int W, int NW,
                   int min_disp, float p1, float p2, cudaStream_t stream);

}  // namespace i3dr
