// sgm_volume — SGM path aggregation over (B, H, W, D) cost volumes of
// any D from 1 to 512, float32 or uint8 costs, one path direction a
// launch, each launch folding its path costs into the running sum in
// place. sgm_aggregate hands it volumes padded to a multiple of 128 (the
// TPU's padding); the lean fused path (fused_cost_sgm.cu) hands it the
// exact D, as the TPU's _horizontal_pass / _vertical_pass take it there.
//
// Replaces the two kernels of i3dr_stereo_tpu/ops/sgm_pallas.py behind
// sgm_aggregate_pallas:
//   _lr_kernel   (pallas_call :173, entry _horizontal_pass)  — H
//   _vert_kernel (pallas_call :229, entry _vertical_pass)    — I
//
// One launch walks every scanline of one direction (dy, dx):
//   L(p, d) = (c(p, d) + min(L(p-r, d), L(p-r, d±1) + P1, m + P2)) - m
//   m = min_k L(p-r, k),  L(p-r, -1) = L(p-r, D) = 1e9
// c = the float32 cost, or 1e9 for the uint8 sentinel 255. A path enters
// the volume with a zero carry: horizontal paths restart each row,
// vertical and diagonal paths at the top (bottom) row, and diagonals again
// at the entering column (the TPU's zeroed column of the shifted carry).
//
// What a launch does with L is its op, three choices made at compile time:
//   v   = L, or (X) x + L            x: a float32 plane, the group total
//   v   = v (float32 out), or (INT) int(min(v, 10000))   (int32 out)
//   out = v, or (ACC) acc + v        acc: float32, int32 or int16
// The TPU sums a group of directions (a horizontal direction alone; a
// vertical family by penalty, split where its VMEM rule says so) inside
// one kernel, L_1 + L_2 + L_3 in order, and adds the group totals in
// order; in int16 mode it stores each total as trunc(min(total, 10000))
// and the sum is their int32 sum. With S the running sum and T a float32
// group total the host runs, per direction in that order:
//   group of one                  S = f(L)        or S = S + f(L)
//   first of a group              T = L
//   middle of a group             T = T + L
//   last of a group               S = f(T + L)    or S = S + f(T + L)
// (f: nothing, or int(min(., 10000)) in int16 mode), so every sum is
// rounded where the TPU rounds it. No per-direction volume is written, and
// no sum pass reads them back. A lane reads and writes only its own
// elements of out / x / acc at its own step, so all three may be one
// plane, updated in place; acc may also be another plane of another type
// (the lean path's first launch reads J's int16 plane and writes the int32
// sum).
//
// Design: one warp a scanline. Each lane holds K = ceil(D/32) (1, 2, 4, 8,
// 12 or 16) consecutive disparities of the carry in registers, so d-1 /
// d+1 cross lanes only at a lane's two ends (one shuffle each); min_d is
// an in-lane min and the warp's hardware minimum (sgm_step.cuh). Where
// the lanes tile D exactly and K is a multiple of 4, every plane moves as
// vectors of four elements; any other D goes element by element. Arithmetic is the
// reference's float32 sequence, rounded per operation (__fadd_rn /
// __fsub_rn), so the kernel equals its torch twin bit for bit.
//
// What bounds it on the card: bytes and the dependent chain. The loads of
// a step (the costs and the planes the op reads) do not depend on the
// carry: the next U steps' loads fly while the current U are walked (two
// register buffers), and the steps every scanline has are walked in whole
// blocks of U with no test between them (a test before each store cost the
// flagship's sweeps 10-25 %); the steps left over go one by one. At
// 1024x1280x128 float32 an 8-path aggregation moves 15.4 GB (C read eight
// times, S and T in place) where per-direction partials and a sum pass
// moved 16.8: 6.1-6.2 ms (2.5 TB/s, 74 % of the 4.6 ms byte bound) where
// those took 8.1 (NVIDIA H100 80GB HBM3, 700 W). The vertical launches
// reach ~2.6 TB/s; a horizontal pass has only B*H warps (1024 at
// 1280x1024, ~8 per SM), too few to hide the chain's latency, and reaches
// 2.0-2.4.
#pragma once

#include <climits>

#include "sgm_step.cuh"

namespace i3dr {

constexpr int VOLUME_THREADS = 128;

// the kinds of acc
enum VolumeAcc { ACC_NONE = 0, ACC_F32 = 1, ACC_I32 = 2, ACC_I16 = 3 };

// an op: X + 2 * ACC + 8 * INT
__host__ __device__ constexpr int volume_op(bool x, int acc, bool int_out) {
  return (x ? 1 : 0) + 2 * acc + (int_out ? 8 : 0);
}
__host__ __device__ constexpr bool op_x(int op) { return op & 1; }
__host__ __device__ constexpr int op_acc(int op) { return (op >> 1) & 3; }
__host__ __device__ constexpr bool op_int(int op) { return op & 8; }
__host__ __device__ constexpr int acc_bytes(int acc) {
  return acc == ACC_NONE ? 0 : (acc == ACC_I16 ? 2 : 4);
}

// K elements of BYTES (1, 2 or 4) bytes each of one lane, packed in
// 32-bit words: as K / 4 vectors of four elements when the lanes tile D
// exactly (vec), else one by one, skipping the disparities past D
template <int K, int BYTES>
struct LaneWords {
  static constexpr int NW = (K * BYTES + 3) / 4;
  uint32_t w[NW];

  // RO: through the read-only path (the plane is not written by this
  // launch)
  template <bool RO>
  __device__ __forceinline__ void load(const void* p, bool vec, int last) {
    if constexpr (K % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          if constexpr (BYTES == 1) {
            const uint32_t* s = (const uint32_t*)p + q;
            w[q] = RO ? __ldg(s) : *s;
          } else if constexpr (BYTES == 2) {
            const uint2* s = (const uint2*)p + q;
            const uint2 t = RO ? __ldg(s) : *s;
            w[2 * q] = t.x, w[2 * q + 1] = t.y;
          } else {
            const uint4* s = (const uint4*)p + q;
            const uint4 t = RO ? __ldg(s) : *s;
            w[4 * q] = t.x, w[4 * q + 1] = t.y, w[4 * q + 2] = t.z,
                  w[4 * q + 3] = t.w;
          }
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k > last) continue;
      if constexpr (BYTES == 1) {
        const uint8_t* s = (const uint8_t*)p + k;
        w[k >> 2] |= (uint32_t)(RO ? __ldg(s) : *s) << (8 * (k & 3));
      } else if constexpr (BYTES == 2) {
        const uint16_t* s = (const uint16_t*)p + k;
        w[k >> 1] |= (uint32_t)(RO ? __ldg(s) : *s) << (16 * (k & 1));
      } else {
        const uint32_t* s = (const uint32_t*)p + k;
        w[k] = RO ? __ldg(s) : *s;
      }
    }
  }

  __device__ __forceinline__ void store(void* p, bool vec, int last) const {
    static_assert(BYTES == 4, "only 32-bit planes are written");
    if constexpr (K % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q)
          ((uint4*)p)[q] =
              make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k <= last) ((uint32_t*)p)[k] = w[k];
  }

  __device__ __forceinline__ int u8(int k) const {
    return (int)((w[k >> 2] >> (8 * (k & 3))) & 0xffu);
  }
  __device__ __forceinline__ int i16(int k) const {
    return (int)(int16_t)(uint16_t)(w[k >> 1] >> (16 * (k & 1)));
  }
  __device__ __forceinline__ int i32(int k) const { return (int)w[k]; }
  __device__ __forceinline__ float f32(int k) const {
    return __uint_as_float(w[k]);
  }
};

// the planes of one launch and the constants of its direction; x and acc
// may alias out, so only C is read through the read-only path
struct VolumeArgs {
  const void* C;
  void* out;
  const void* x;
  const void* acc;
  int H, W, D, dy, dx;
  int n_lines;
  long long n_warps;
  float p1, p2;
};

// what one lane loads for one step (a member that the op does not read
// is never loaded)
template <typename CostT, int K, int OP>
struct VolumeIn {
  LaneWords<K, (int)sizeof(CostT)> c;
  LaneWords<K, 4> x;
  LaneWords<K, (acc_bytes(op_acc(OP)) ? acc_bytes(op_acc(OP)) : 4)> a;
};

// floor to a power of two of min(8, 32 / words): the steps whose loads
// are kept in flight, sized so the two buffers stay within ~64 registers
__host__ __device__ constexpr int volume_unroll(int words) {
  int u = 8;
  while (u > 1 && u * words > 32) u >>= 1;
  return u;
}

template <typename CostT, int K, int OP, int N>
__device__ __forceinline__ void volume_load(VolumeIn<CostT, K, OP> (&buf)[N],
                                            const VolumeArgs& a, long long e,
                                            long long stride, bool vec,
                                            int last) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long o = e + u * stride;
    buf[u].c.template load<true>((const CostT*)a.C + o, vec, last);
    if constexpr (op_x(OP))
      buf[u].x.template load<false>((const float*)a.x + o, vec, last);
    if constexpr (op_acc(OP) == ACC_I16)
      buf[u].a.template load<false>((const int16_t*)a.acc + o, vec, last);
    else if constexpr (op_acc(OP) != ACC_NONE)
      buf[u].a.template load<false>((const uint32_t*)a.acc + o, vec, last);
  }
}

template <typename CostT, int K>
__device__ __forceinline__ float volume_cost(
    const LaneWords<K, (int)sizeof(CostT)>& c, int k) {
  if constexpr (sizeof(CostT) == 1) {
    const int v = c.u8(k);
    return v == SENTINEL ? BIG : (float)v;
  } else {
    return c.f32(k);
  }
}

// N steps of the scanline from loaded inputs: the recurrence, the op, the
// stores, with no test between them
template <typename CostT, int K, int OP, int N>
__device__ __forceinline__ void volume_steps(
    const VolumeIn<CostT, K, OP> (&in)[N], float (&prev)[K],
    const VolumeArgs& a, long long e, long long stride, bool vec, int lane,
    int last) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float c[K], L[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = volume_cost<CostT, K>(in[u].c, k);
    sgm_step<K>(prev, c, L, lane, last, a.p1, a.p2);
    LaneWords<K, 4> out;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      prev[k] = L[k];
      const float v = op_x(OP) ? __fadd_rn(in[u].x.f32(k), L[k]) : L[k];
      if constexpr (op_int(OP)) {
        int r = (int)fminf(v, CLAMP);  // truncates, as astype
        if constexpr (op_acc(OP) == ACC_I32) r += in[u].a.i32(k);
        if constexpr (op_acc(OP) == ACC_I16) r += in[u].a.i16(k);
        out.w[k] = (uint32_t)r;
      } else {
        out.w[k] = __float_as_uint(
            op_acc(OP) == ACC_F32 ? __fadd_rn(in[u].a.f32(k), v) : v);
      }
    }
    out.store((uint32_t*)a.out + e + u * stride, vec, last);
  }
}

template <typename CostT, int K, int OP>
__global__ void __launch_bounds__(VOLUME_THREADS)
    sgm_volume_kernel(VolumeArgs a) {
  using In = VolumeIn<CostT, K, OP>;
  constexpr int U = volume_unroll(
      decltype(In::c)::NW + (op_x(OP) ? K : 0) +
      (op_acc(OP) != ACC_NONE ? decltype(In::a)::NW : 0));
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (warp >= a.n_warps) return;  // uniform across the warp
  const int H = a.H, W = a.W, D = a.D, dy = a.dy, dx = a.dx;
  const int b = (int)(warp / a.n_lines);
  const int line = (int)(warp % a.n_lines);
  const int last = D - 1 - lane * K;  // see sgm_step.cuh
  const bool vec = K % 4 == 0 && D == WARP * K;

  // first pixel of the scanline: the pixel whose predecessor (y-dy, x-dx)
  // lies outside the volume
  int y, x;
  if (dy == 0) {
    y = line;
    x = dx > 0 ? 0 : W - 1;
  } else if (dx == 0 || line < W) {
    x = line;
    y = dy > 0 ? 0 : H - 1;
  } else {
    const int j = line - W + 1;  // 1 .. H-1: entering through a side column
    y = dy > 0 ? j : H - 1 - j;
    x = dx > 0 ? 0 : W - 1;
  }
  const int ny = dy == 0 ? INT_MAX : (dy > 0 ? H - y : y + 1);
  const int nx = dx == 0 ? INT_MAX : (dx > 0 ? W - x : x + 1);
  const int len = min(ny, nx);  // the same for the warp's lanes

  const long long stride = ((long long)dy * W + dx) * D;
  long long e = (((long long)b * H + y) * W + x) * D + lane * K;

  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) prev[k] = k <= last ? 0.0f : CUDART_INF_F;

  const int n_full = len / U * U;
  In next[U];
  if (n_full > 0) volume_load(next, a, e, stride, vec, last);
  for (int s0 = 0; s0 < n_full; s0 += U) {
    In cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[u];
    // the next block's loads fly while this block is walked
    if (s0 + 2 * U <= n_full)
      volume_load(next, a, e + U * stride, stride, vec, last);
    volume_steps(cur, prev, a, e, stride, vec, lane, last);
    e += U * stride;
  }
#pragma unroll 1
  for (int s = n_full; s < len; ++s) {
    In one[1];
    volume_load(one, a, e, stride, vec, last);
    volume_steps(one, prev, a, e, stride, vec, lane, last);
    e += stride;
  }
}

template <typename CostT, int OP>
int volume_launch_k(const VolumeArgs& a, cudaStream_t stream) {
  const long long blocks =
      (a.n_warps * WARP + VOLUME_THREADS - 1) / VOLUME_THREADS;
#define I3DR_SGM_VOLUME_LAUNCH(K)                                        \
  sgm_volume_kernel<CostT, K, OP>                                        \
      <<<(unsigned)blocks, VOLUME_THREADS, 0, stream>>>(a)
  switch (lanes_k(a.D)) {
    case 1: I3DR_SGM_VOLUME_LAUNCH(1); break;
    case 2: I3DR_SGM_VOLUME_LAUNCH(2); break;
    case 4: I3DR_SGM_VOLUME_LAUNCH(4); break;
    case 8: I3DR_SGM_VOLUME_LAUNCH(8); break;
    case 12: I3DR_SGM_VOLUME_LAUNCH(12); break;
    case 16: I3DR_SGM_VOLUME_LAUNCH(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef I3DR_SGM_VOLUME_LAUNCH
  return (int)cudaGetLastError();
}

template <int OP>
int volume_launch_op(const VolumeArgs& a, bool u8, cudaStream_t stream) {
  return u8 ? volume_launch_k<uint8_t, OP>(a, stream)
            : volume_launch_k<float, OP>(a, stream);
}

// the float32-out ops (sgm_volume.cu) and the int32-out ops
// (sgm_volume_int.cu), compiled side by side
int volume_launch_f32(int op, const VolumeArgs& a, bool u8,
                      cudaStream_t stream);
int volume_launch_i32(int op, const VolumeArgs& a, bool u8,
                      cudaStream_t stream);

}  // namespace i3dr
