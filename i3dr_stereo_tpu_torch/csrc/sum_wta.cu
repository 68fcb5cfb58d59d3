// sum_wta — direction sum + winner-take-all with parabolic subpixel.
//
// Replaces: the sum and WTA half of i3dr_stereo_tpu/ops/sgm_fused_t.py ·
// _vup_wta_kernel (pallas_call at :423, entry vsweep_up_wta_t :398).
//
// The TPU kernels store some partial sums in int16, truncating there;
// the sum is rebuilt with exactly those truncation points from the
// per-direction float32 outputs of sgm_path (each already min(L, 1e4)):
//   S_fwd  = int(L_fwd)                                  (_fwd_kernel store)
//   S_h    = int(L_rev + float(S_fwd))                   (_rev_kernel store)
//   S_down = int(sum of the down directions, in order)   (_vdown_kernel store)
//   S      = float(S_h + S_down) + each up direction, in order
// then, per pixel (first minimum, two reductions, never a packed key):
//   m = min_d S, db = first d with S == m
//   valid = m < 9999 and min_d C < 255 [and the uniqueness margin]
//   disp = db + clip((Sm - Sp) / (2 (Sm + Sp - 2m)), ±0.5) for 0 < db < D-1
// Output: float32 disparity per pixel, -1e9 where invalid.
//
// Design: one warp per pixel, lane = disparity; the three minima are
// shuffle butterflies, Sm/Sp one indexed shuffle each. Float operations
// are explicitly rounded (__fadd_rn, __fmul_rn, __fdiv_rn) in the
// reference's order.
//
// What bounds it on the card: bytes. Each pixel reads 4 (8 in 8-path
// mode) float32 partials and the uint8 costs: 544 bytes per pixel at
// D = 32, 4 paths, ~2.9 GB at 2448x2048 (padded 2560x2048), ~0.9 ms of
// HBM time. Fusing the last sweep with the WTA (as the TPU does) would
// remove one partial's write and read — a later optimisation.
#include "common.cuh"

namespace {

constexpr int MAX_PARTS = 8;

struct Parts {
  const float* p[MAX_PARTS];
};

__global__ void sum_wta_kernel(const uint8_t* __restrict__ C, Parts parts,
                               int n_down, int n_up, float* __restrict__ disp,
                               long long n_pix, int subpixel, float ur) {
  const int lane = threadIdx.x & 31;
  const long long pix =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (pix >= n_pix) return;  // uniform across the warp
  const long long o = pix * i3dr::WARP + lane;

  const int s_fwd = (int)parts.p[0][o];
  const int s_h = (int)__fadd_rn(parts.p[1][o], (float)s_fwd);
  float down = parts.p[2][o];
  for (int k = 1; k < n_down; ++k) down = __fadd_rn(down, parts.p[2 + k][o]);
  const int s_down = (int)down;
  float S = (float)(s_h + s_down);
  for (int k = 0; k < n_up; ++k) S = __fadd_rn(S, parts.p[2 + n_down + k][o]);

  const float m = i3dr::warp_min(S);
  const int db = i3dr::warp_min(S == m ? lane : i3dr::WARP);
  const int cmin = i3dr::warp_min((int)C[o]);
  bool valid = (m < 9999.0f) && (cmin < i3dr::SENTINEL);
  if (ur > 0.0f) {  // uniqueness margin against |d - db| > 1
    const float far = i3dr::warp_min(abs(lane - db) > 1 ? S : i3dr::BIG);
    valid = valid &&
            (__fmul_rn(far, __fsub_rn(100.0f, ur)) >= __fmul_rn(m, 100.0f));
  }
  float d = (float)db;
  if (subpixel) {
    const float Sm = __shfl_sync(i3dr::FULL, S, db > 0 ? db - 1 : 0);
    const float Sp =
        __shfl_sync(i3dr::FULL, S, db < i3dr::WARP - 1 ? db + 1 : db);
    const float denom = __fsub_rn(__fadd_rn(Sm, Sp), __fmul_rn(2.0f, m));
    float off = denom > 1e-9f
                    ? __fdiv_rn(__fsub_rn(Sm, Sp), __fmul_rn(2.0f, denom))
                    : 0.0f;
    off = fminf(fmaxf(off, -0.5f), 0.5f);
    if (db > 0 && db < i3dr::WARP - 1) d = __fadd_rn(d, off);
  }
  if (lane == 0) disp[pix] = valid ? d : i3dr::NODATA;
}

}  // namespace

extern "C" int i3dr_sum_wta(const void* C, const void* const* parts,
                            int n_down, int n_up, void* disp, long long n_pix,
                            int subpixel, float ur, void* stream) {
  if (n_down < 1 || n_up < 1 || 2 + n_down + n_up > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  Parts ps = {};
  for (int k = 0; k < 2 + n_down + n_up; ++k)
    ps.p[k] = (const float*)parts[k];
  const int threads = 256;
  const long long blocks = (n_pix * i3dr::WARP + threads - 1) / threads;
  sum_wta_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)C, ps, n_down, n_up, (float*)disp, n_pix, subpixel, ur);
  return (int)cudaGetLastError();
}
