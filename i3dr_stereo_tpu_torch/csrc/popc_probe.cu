// popc_probe — the card's popcount rate, for the bounds of the two census
// kernels (census_cost.cu, fused_cost_sgm.cu): their floor is set by
// popcounts, which the card retires far below its float32 rate. Not a
// kernel of any path: chip_smoke.py times it beside the kernels it bounds.
//
// Every thread keeps 8 independent chains of add, popcount, add, so the
// popcount unit is the only one kept full (two plain integer operations a
// popcount, at four times its rate).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHAINS = 8;

__global__ void __launch_bounds__(THREADS)
    popc_probe_kernel(uint32_t* __restrict__ out, int iters) {
  uint32_t x[CHAINS], acc[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    x[j] = (blockIdx.x * THREADS + threadIdx.x) * 2654435761u + j;
    acc[j] = 0u;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      x[j] += 0x9e3779b9u;
      acc[j] += (uint32_t)__popc(x[j]);
    }
  }
  uint32_t sum = 0u;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) sum += acc[j];
  out[blockIdx.x * THREADS + threadIdx.x] = sum;
}

}  // namespace

// out: uint32 (blocks * 256); does blocks * 256 * iters * 8 popcounts
extern "C" int i3dr_popc_probe(void* out, int blocks, int iters,
                               void* stream) {
  if (blocks < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  popc_probe_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, iters);
  return (int)cudaGetLastError();
}
