// tsdf_integrate — one TSDF fusion step over a whole voxel grid, in place.
//
// Replaces no Pallas kernel: the reference's update is XLA
// (i3dr_stereo_tpu/mapping/tsdf.py · _integrate, :38-75), which the plain
// torch twin (mapping/tsdf.py · integrate_plain) runs as ~30 launches
// over voxel-sized intermediates (an int64 flat index among them).
//
// What it computes, for every voxel (i, j, k) of the (X, Y, Z) grid
// (z fastest), from the depth image (H, W) metres (0 = invalid), the
// intrinsics K and the world->camera pose T:
//   w{x,y,z} = origin + (index + 0.5) * voxel
//   c{x,y,z} = ((T[r][0] * wx + T[r][1] * wy) + T[r][2] * wz) + T[r][3]
//   u = (K00 * cx) / cz + K02,  v = (K11 * cy) / cz + K12
//   ui, vi = rint(u), rint(v) (half to even, as jnp.round)
//   in_img = cz > 1e-6 and 0 <= ui < W and 0 <= vi < H
//   d = depth[clip(vi), clip(ui)];  sdf = d - cz
//   seen = in_img and d > 0 and sdf > -trunc
//   t_new = clip(sdf / trunc, -1, 1);  w_new = seen ? 1 : 0
//   w_tot = weight + w_new
//   tsdf = w_tot > 0 ? (tsdf * weight + t_new * w_new) / max(w_tot, 1e-9)
//                    : tsdf;  weight = w_tot
// every operation rounded on its own (no FMA), in the twin's order:
// kernel and twin are bit-equal. The comparisons with 0 and W, H are made
// on the rounded floats, which is what the reference's int32 comparisons
// give after a saturating cast (the twin clamps in float before its cast),
// and the clipped index clamps the float (a NaN, where cz = cx = 0, reads
// pixel 0; such a voxel is not seen, and an unseen voxel's result does not
// depend on d). Every voxel is written: a voxel this frame does not see is
// still rewritten as (tsdf * weight + 0) / weight, which may differ from
// tsdf by an ulp, as in the reference.
//
// Design. A thread a run of 4 voxels along z (one float4 of tsdf and one
// of weight, where Z is a multiple of 4; else a voxel a thread), the
// grid flattened over (x, y, z / 4). The grid's arrays stream through once
// (loads and stores marked evict-first: 1 GiB at 512^3 does not fit the
// 50 MB L2), while the depth image (20 MB at 2448x2048) is read through
// the read-only path and stays in L2: neighbouring voxels project to
// neighbouring pixels.
//
// What bounds it on the card: bytes. The grid's two arrays read once and
// written once, 16 bytes a voxel (2.15 GB at 512^3, 0.64 ms at 3.35
// TB/s), and the depth image read once; its ~45 float operations a voxel
// (four of them divisions) stay below the float32 rate.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 256;

struct Params {
  float k00, k02, k11, k12;
  float t[12];  // rows 0-2 of T_cw, row-major
  float ox, oy, oz, voxel, trunc;
};

__device__ __forceinline__ float row(const float* r, float wx, float wy,
                                     float wz) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], wx), __fmul_rn(r[1], wy)),
                __fmul_rn(r[2], wz)),
      r[3]);
}

__device__ __forceinline__ void voxel(float& t, float& w, float wx, float wy,
                                      float wz, const float* __restrict__ depth,
                                      int H, int W, const Params& p) {
  const float cx = row(p.t, wx, wy, wz);
  const float cy = row(p.t + 4, wx, wy, wz);
  const float cz = row(p.t + 8, wx, wy, wz);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(p.k00, cx), cz), p.k02);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(p.k11, cy), cz), p.k12);
  const float uf = rintf(u);
  const float vf = rintf(v);
  const bool in_img = cz > 1e-6f && uf >= 0.f && uf < (float)W &&
                      vf >= 0.f && vf < (float)H;
  const int ui = (int)fminf(fmaxf(uf, 0.f), (float)(W - 1));
  const int vi = (int)fminf(fmaxf(vf, 0.f), (float)(H - 1));
  const float d = __ldg(depth + (long long)vi * W + ui);
  const float sdf = __fsub_rn(d, cz);
  const bool seen = in_img && d > 0.f && sdf > -p.trunc;
  const float t_new = fminf(fmaxf(__fdiv_rn(sdf, p.trunc), -1.f), 1.f);
  const float w_new = seen ? 1.f : 0.f;
  const float w_tot = __fadd_rn(w, w_new);
  if (w_tot > 0.f)
    t = __fdiv_rn(__fadd_rn(__fmul_rn(t, w), __fmul_rn(t_new, w_new)),
                  fmaxf(w_tot, 1e-9f));
  w = w_tot;
}

template <int V>
__global__ void __launch_bounds__(TX)
    tsdf_kernel(float* __restrict__ tsdf, float* __restrict__ weight,
                const float* __restrict__ depth, int X, int Y, int Z, int H,
                int W, Params p) {
  const int zg = Z / V;
  const long long g = (long long)blockIdx.x * TX + threadIdx.x;
  if (g >= (long long)X * Y * zg) return;
  const int k0 = (int)(g % zg) * V;
  const long long col = g / zg;
  const int j = (int)(col % Y);
  const int i = (int)(col / Y);
  const float wx = __fadd_rn(p.ox, __fmul_rn(__fadd_rn((float)i, 0.5f), p.voxel));
  const float wy = __fadd_rn(p.oy, __fmul_rn(__fadd_rn((float)j, 0.5f), p.voxel));
  const long long at = col * Z + k0;
  if (V == 4) {
    float4 t = __ldcs(reinterpret_cast<const float4*>(tsdf + at));
    float4 w = __ldcs(reinterpret_cast<const float4*>(weight + at));
    float tv[4] = {t.x, t.y, t.z, t.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float wz =
          __fadd_rn(p.oz, __fmul_rn(__fadd_rn((float)(k0 + s), 0.5f), p.voxel));
      voxel(tv[s], wv[s], wx, wy, wz, depth, H, W, p);
    }
    __stcs(reinterpret_cast<float4*>(tsdf + at),
           make_float4(tv[0], tv[1], tv[2], tv[3]));
    __stcs(reinterpret_cast<float4*>(weight + at),
           make_float4(wv[0], wv[1], wv[2], wv[3]));
  } else {
    float t = tsdf[at], w = weight[at];
    const float wz =
        __fadd_rn(p.oz, __fmul_rn(__fadd_rn((float)k0, 0.5f), p.voxel));
    voxel(t, w, wx, wy, wz, depth, H, W, p);
    tsdf[at] = t;
    weight[at] = w;
  }
}

}  // namespace

// tsdf, weight: (X, Y, Z) float32, updated in place; depth: (H, W) float32;
// k*: the intrinsics; t: rows 0-2 of T_cw (12 floats, row-major) as
// arguments; origin, voxel and trunc (= trunc_vox * voxel in float32).
// A run of 4 voxels a thread where Z % 4 == 0 and both arrays are 16-byte
// aligned, else a voxel a thread.
extern "C" int i3dr_tsdf_integrate(
    void* tsdf, void* weight, const void* depth, int X, int Y, int Z, int H,
    int W, float k00, float k02, float k11, float k12, float t00, float t01,
    float t02, float t03, float t10, float t11, float t12, float t13,
    float t20, float t21, float t22, float t23, float ox, float oy, float oz,
    float voxel_size, float trunc, void* stream) {
  if ((long long)X * Y * Z == 0) return 0;
  if (H <= 0 || W <= 0 || tsdf == weight) return (int)cudaErrorInvalidValue;
  const Params p = {k00, k02, k11, k12,
                    {t00, t01, t02, t03, t10, t11, t12, t13, t20, t21, t22,
                     t23},
                    ox, oy, oz, voxel_size, trunc};
  float* t = (float*)tsdf;
  float* w = (float*)weight;
  const float* d = (const float*)depth;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = Z % 4 == 0 && ((size_t)tsdf % 16) == 0 &&
                   ((size_t)weight % 16) == 0;
  const long long n = (long long)X * Y * (vec ? Z / 4 : Z);
  const long long blocks = (n + TX - 1) / TX;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    tsdf_kernel<4><<<(unsigned)blocks, TX, 0, s>>>(t, w, d, X, Y, Z, H, W, p);
  else
    tsdf_kernel<1><<<(unsigned)blocks, TX, 0, s>>>(t, w, d, X, Y, Z, H, W, p);
  return (int)cudaGetLastError();
}
