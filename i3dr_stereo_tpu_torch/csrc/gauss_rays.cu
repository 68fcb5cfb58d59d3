// gauss_rays — the 32-direction Gauss gap fill, one launch for every
// direction.
//
// Replaces no Pallas kernel: the reference's interpolator is unrolled XLA
// (i3dr_stereo_tpu/ops/gauss_interp.py · gauss_interpolate, jax.jit at
// :38; rounds at :60-89), which the plain torch twin
// (ops/gauss_interp.py · gauss_interpolate_plain) runs as ~10 launches a
// round, 192 rounds at 32 directions, each round writing two full planes.
//
// What it computes, for each hole p (valid pixels pass through):
//   per direction k, the reference's distance doubling: the state
//   (val, dst) = (d, 0) on valid pixels, (0, BIG) in holes; round r
//   replaces the state at p by the state at p + o_r with dst + |o_r| when
//   that is strictly smaller, out-of-image neighbours reading (0, BIG),
//   rounds with o_r = (0, 0) skipped (o_r and |o_r| in float32 from the
//   host, table below). Then hit = dst < radius, w = exp(-(dst*dst) / 2s^2)
//   (as XLA computes it: a product with the float32 reciprocal of 2s^2),
//   wsum += w, vsum += w * val, nrays += hit in direction order, and
//   filled = vsum / max(wsum, 1e-20), valid = nrays >= max(min, 1) and
//   wsum > 0 (the reference's guard against weights that underflow).
//
// Design. The state after the last round unrolls into a recursion,
//   N(r, q) = pick_r(N(r-1, q), N(r-1, q + o_r)),  N(0, q) = the leaf at q,
// so a thread evaluates its own hole's 2^R leaves (R = 6 at radius 64)
// through the read-only path, with no intermediate plane in device
// memory. Above level BL = 2 a subtree is not walked where it cannot win:
// where its root leaves the image (it reads (0, BIG)), or where the state
// it would replace is no farther than the round's length |o_r| (its
// candidate, a distance >= 0 plus |o_r| rounded up or exact, is at least
// |o_r|). A subtree of level BL is taken whole: its 4 leaves' masks are
// loaded at once and picked in registers (a node whose root leaves the
// image is (0, BIG)), carrying the winning leaf's position; the
// disparity is read once, at the winner of the whole tree. The walk's
// time is its chain of dependent loads: with a load a leaf, each pick
// waited for the one before it. A block is 8 x 16 pixels, so a warp is
// 8 x 4 of them: its holes lie close together and walk trees of a like
// shape over the same lines of L1.
//   kernel_probes/probe8.py at commit 1dd326f timed it and the forms below
// (in its src/) at level 0 of the flagship frame (PERF.md has the figures):
// the walk a leaf at a time in 32 x 8 blocks (the form before), leaves
// gathered 1 to 4 levels at once, blocks of 32 x 8 to 8 x 32. Slower than
// the form before: the holes of a tile listed in shared memory, a thread a
// hole (src/gauss_rays_lane.cu) or a warp a hole and a lane a direction
// (src/gauss_rays_warp.cu): a warp then waits on its slowest of 32 trees;
// and the reference's rounds on a 32 x 32 tile in shared memory with a byte
// of state a pixel (src/gauss_rays_rounds.cu): ~400 byte updates a pixel,
// and nearly every tile has holes.
//   Every float op is the twin's, in its order, with __fadd_rn /
// __fmul_rn / __fdiv_rn so that nothing is contracted into an FMA, and
// expf as torch's exp on the card computes it. The per-round alternative
// (192 launches, two planes written each) moves ~23 GB a call at
// 2448x2048.
//
// What bounds it on the card: ~10 bytes a pixel moved once (0.015 ms at
// 2448x2048) against the doubling's operations where they are needed:
// only holes, since a valid pixel's state (d, 0) can never be replaced,
// ~6 a round and ~12 a direction, 1536 a hole at 32 directions and 6
// rounds (0.014 ms for level 0's 627141 holes at 67 TFLOP/s). The
// recursion does 2^R - 1 picks a hole and direction where the doubling
// does R.
//
// One instance, R = 6 (32 < max_radius <= 64): every caller in the
// package fills with the reference's radius 64; the twin takes any other.
#include "common.cuh"

namespace {

constexpr int TX = 8, TY = 16;
constexpr int ROUNDS = 6;   // the one instance: 32 < max_radius <= 64
constexpr int BL = 2;       // levels evaluated in one batch

template <int R>
struct Dir {
  int oy[R], ox[R];
  float len[R];
};

// N(L, (y, x)) for L <= BL, (y, x) in the image, from its 2^L leaves
// loaded at once: node T of level l (bits 0..l-1 of T clear) is N(l,
// pos(T)), pos(T) = (y, x) + the offsets of the rounds in T; it is BIG
// where pos(T) leaves the image, else the pick of nodes T and T | 2^l of
// level l - 1. Returns the distance and the winning leaf's position.
template <int R, int L>
__device__ __forceinline__ void batch(const unsigned char* __restrict__ v,
                                      int H, int W, int y, int x,
                                      const Dir<R>& dir, int& pos,
                                      float& dst) {
  constexpr int N = 1 << L;
  float ds[N];
  int at[N];
  bool in[N];
#pragma unroll
  for (int T = 0; T < N; ++T) {
    int yy = y, xx = x;
#pragma unroll
    for (int r = 0; r < L; ++r)
      if (T >> r & 1) {
        yy += dir.oy[r];
        xx += dir.ox[r];
      }
    in[T] = yy >= 0 && yy < H && xx >= 0 && xx < W;
    at[T] = yy * W + xx;
    ds[T] = in[T] && __ldg(v + at[T]) != 0 ? 0.f : i3dr::BIG;
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool moves = dir.oy[l] != 0 || dir.ox[l] != 0;
#pragma unroll
    for (int T = 0; T < N; T += 2 << l) {
      if (moves) {
        const float d2 = __fadd_rn(ds[T | 1 << l], dir.len[l]);
        if (d2 < ds[T]) {
          ds[T] = d2;
          at[T] = at[T | 1 << l];
        }
      }
      if (!in[T]) ds[T] = i3dr::BIG;
    }
  }
  pos = at[0];
  dst = ds[0];
}

// N(L, (y, x)): above level BL as the recursion, a subtree skipped where
// it cannot win (its root outside the image, or the state it would
// replace no farther than the round's length); from level BL down in one
// batch
template <int R, int L>
__device__ __forceinline__ void node(const unsigned char* __restrict__ v,
                                     int H, int W, int y, int x,
                                     const Dir<R>& dir, int& pos,
                                     float& dst) {
  if constexpr (L <= BL) {
    batch<R, L>(v, H, W, y, x, dir, pos, dst);
  } else {
    node<R, L - 1>(v, H, W, y, x, dir, pos, dst);
    const int dy = dir.oy[L - 1], dx = dir.ox[L - 1];
    if ((dy != 0 || dx != 0) && dst > dir.len[L - 1]) {
      const int yy = y + dy, xx = x + dx;
      int p2 = 0;
      float d2 = i3dr::BIG;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        node<R, L - 1>(v, H, W, yy, xx, dir, p2, d2);
      d2 = __fadd_rn(d2, dir.len[L - 1]);
      if (d2 < dst) {
        pos = p2;
        dst = d2;
      }
    }
  }
}

// table: a row of 3R words a direction, (dy, dx) of each round as int32,
// then each round's length as float32
template <int R>
__global__ void __launch_bounds__(TX* TY)
    gauss_rays_kernel(const float* __restrict__ d,
                      const unsigned char* __restrict__ v,
                      const float* __restrict__ table, float* __restrict__ out,
                      unsigned char* __restrict__ vout, int H, int W,
                      int n_dir, float radius, float inv_two_sig2,
                      float min_rays) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long plane = (long long)blockIdx.z * H * W;
  d += plane;
  v += plane;
  const long long i = (long long)y * W + x;
  if (__ldg(v + i)) {
    out[plane + i] = __ldg(d + i);
    vout[plane + i] = 1;
    return;
  }
  float wsum = 0.f, vsum = 0.f, nrays = 0.f;
  for (int k = 0; k < n_dir; ++k) {
    const float* row = table + k * 3 * R;
    Dir<R> dir;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dir.oy[r] = __float_as_int(__ldg(row + 2 * r));
      dir.ox[r] = __float_as_int(__ldg(row + 2 * r + 1));
      dir.len[r] = __ldg(row + 2 * R + r);
    }
    int pos;
    float dst;
    node<R, R>(v, H, W, y, x, dir, pos, dst);
    const float val = dst < i3dr::BIG ? __ldg(d + pos) : 0.f;
    const bool hit = dst < radius;
    const float w =
        hit ? expf(__fmul_rn(-__fmul_rn(dst, dst), inv_two_sig2)) : 0.f;
    wsum = __fadd_rn(wsum, w);
    vsum = __fadd_rn(vsum, __fmul_rn(w, val));
    nrays = __fadd_rn(nrays, hit ? 1.f : 0.f);
  }
  out[plane + i] = wsum > 0.f ? __fdiv_rn(vsum, fmaxf(wsum, 1e-20f)) : 0.f;
  vout[plane + i] = nrays >= min_rays && wsum > 0.f;
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
  if (B > 65535 || n_dir < 1 || rounds != ROUNDS ||
      (long long)H * W > 0x7fffffffLL)   // a leaf's position is an int
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  gauss_rays_kernel<ROUNDS><<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      (const float*)d, (const unsigned char*)v, (const float*)table,
      (float*)out, (unsigned char*)vout, H, W, n_dir, radius, inv_two_sig2,
      min_rays);
  return (int)cudaGetLastError();
}
