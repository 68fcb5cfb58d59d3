// speckle_ccl — exact cv::filterSpeckles keep-mask by union-find labelling.
//
// Replaces: i3dr_stereo_tpu/ops/speckle_pallas.py · _kernel / _kernel_slow
// (pl.pallas_call at :304 single window and :340 tiled, entry
// speckle_filter_pallas :284).
//
//   keep[b, y, x] = valid && |component(b, y, x)| > max_size
//
// where components are 4-connected over valid pixels with
// |d_p - d_q| <= max_diff (float32, a runtime argument).
//
// The TPU kernel bounds the work by the threshold (S+2 label rounds, tiles
// with halos of S+1, a systolic mass drain) because it cannot scatter.
// The GPU can: this is block-based union-find in the manner of Playne &
// Hawick (IEEE TPDS 2018), four launches per call and no host sync:
//
//   1. local:    one 32x32 tile per block labels itself in shared memory
//                (union-find with atomicMin on roots, then compression),
//                writes each pixel's tile root as a frame-local index and
//                zeroes the size histogram;
//   2. boundary: one thread per pixel pair across a tile edge unions the
//                two tile trees in global memory (the same lock-free
//                union: a link always points to a smaller index, so no
//                cycle forms, and a failed atomicMin retries);
//   3. count:    every valid pixel finds its root, compresses its own
//                entry, and adds one to sizes[root];
//   4. keep:     keep = valid && sizes[label] > max_size.
//
// Labels depend on the order of the atomics; the components, hence the
// keep-mask, do not, so it equals the plain twin bit for bit.
//
// What bounds it on the card: bytes and the depth of the trees. Per pixel
// the passes move ~4 B of disparity, 1 B of validity, ~12 B of labels and
// sizes and 1 B of output (~20 MB at the flagship's 1224x1024 after the
// ds2 front-end, ~6 us of HBM time), so the cost is the launches and the
// find chains: a tile's trees are compressed before they leave shared
// memory, so a global chain runs over tile roots only.
#include "common.cuh"

namespace {

constexpr int TILE = 32;

__device__ __forceinline__ int find_root(const volatile int* L, int a) {
  int p;
  while ((p = L[a]) != a) a = p;
  return a;
}

// Link the trees of a and b: the larger root points to the smaller one.
// An atomicMin that finds its target no longer a root has still written a
// valid link (to a smaller index of the merged set) and the loop goes on
// with the value it displaced, so no link is lost.
__device__ __forceinline__ void unite(int* L, int a, int b) {
  const volatile int* VL = L;
  bool done;
  do {
    a = find_root(VL, a);
    b = find_root(VL, b);
    if (a < b) {
      const int old = atomicMin(&L[b], a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(&L[a], b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__device__ __forceinline__ bool joined(float a, float b, float max_diff) {
  return fabsf(__fsub_rn(a, b)) <= max_diff;
}

__global__ void __launch_bounds__(TILE * TILE)
    ccl_local(const float* __restrict__ d, const uint8_t* __restrict__ valid,
              int* __restrict__ labels, int* __restrict__ sizes, int H, int W,
              float max_diff) {
  __shared__ int lab[TILE * TILE];
  __shared__ float ds[TILE * TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * TILE + tx, y = blockIdx.y * TILE + ty;
  const long long frame = (long long)blockIdx.z * H * W;
  const int li = ty * TILE + tx;
  const bool in = x < W && y < H;
  const long long p = frame + (long long)y * W + x;
  const bool v = in && valid[p];
  ds[li] = v ? d[p] : 0.0f;
  lab[li] = v ? li : -1;  // -1: invalid, never united
  if (in) sizes[p] = 0;
  __syncthreads();
  if (v) {
    if (tx + 1 < TILE && lab[li + 1] >= 0 && joined(ds[li], ds[li + 1], max_diff))
      unite(lab, li, li + 1);
    if (ty + 1 < TILE && lab[li + TILE] >= 0 &&
        joined(ds[li], ds[li + TILE], max_diff))
      unite(lab, li, li + TILE);
  }
  __syncthreads();
  // every union is done: compression only replaces a link by an ancestor
  if (v) lab[li] = find_root(lab, li);
  __syncthreads();
  if (in) {
    int out = -1;
    if (v) {
      const int r = lab[li];
      out = (blockIdx.y * TILE + r / TILE) * W + blockIdx.x * TILE + r % TILE;
    }
    labels[p] = out;
  }
}

__global__ void ccl_boundary(const float* __restrict__ d,
                             const uint8_t* __restrict__ valid,
                             int* __restrict__ labels, int H, int W,
                             int n_vert, int n_total, float max_diff) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_total) return;
  int x, y, dx, dy;
  if (t < n_vert) {  // pixel left of a vertical tile edge, and its right
    y = t % H;
    x = (t / H + 1) * TILE - 1;
    dx = 1, dy = 0;
  } else {  // pixel above a horizontal tile edge, and the one below
    const int u = t - n_vert;
    x = u % W;
    y = (u / W + 1) * TILE - 1;
    dx = 0, dy = 1;
  }
  const long long frame = (long long)blockIdx.y * H * W;
  const int a = y * W + x, b = (y + dy) * W + x + dx;
  if (!valid[frame + a] || !valid[frame + b]) return;
  if (!joined(d[frame + a], d[frame + b], max_diff)) return;
  unite(labels + frame, a, b);
}

__global__ void ccl_count(const uint8_t* __restrict__ valid,
                          int* __restrict__ labels, int* __restrict__ sizes,
                          int n_pix) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const long long frame = (long long)blockIdx.y * n_pix;
  if (!valid[frame + i]) return;
  int* L = labels + frame;
  const int r = find_root(L, i);
  L[i] = r;  // the merge is over: any link may become its root
  atomicAdd(&sizes[frame + r], 1);
}

__global__ void ccl_keep(const uint8_t* __restrict__ valid,
                         const int* __restrict__ labels,
                         const int* __restrict__ sizes,
                         uint8_t* __restrict__ keep, int n_pix, int max_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const long long p = (long long)blockIdx.y * n_pix + i;
  keep[p] = valid[p] && sizes[(long long)blockIdx.y * n_pix + labels[p]] >
                            max_size;
}

}  // namespace

// d float32, valid uint8 (0/1), labels and sizes int32 scratch, keep uint8
// (0/1) output, all (B, H, W); H * W < 2^31, B <= 65535.
extern "C" int i3dr_speckle_ccl(const void* d, const void* valid,
                                void* labels, void* sizes, void* keep, int B,
                                int H, int W, int max_size, float max_diff,
                                void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* dd = (const float*)d;
  const uint8_t* vv = (const uint8_t*)valid;
  int* L = (int*)labels;
  int* S = (int*)sizes;
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;

  ccl_local<<<dim3(tiles_x, tiles_y, B), dim3(TILE, TILE), 0, s>>>(
      dd, vv, L, S, H, W, max_diff);

  const int n_vert = H * (tiles_x - 1);
  const int n_total = n_vert + W * (tiles_y - 1);
  const int threads = 256;
  if (n_total > 0)
    ccl_boundary<<<dim3((n_total + threads - 1) / threads, B), threads, 0,
                   s>>>(dd, vv, L, H, W, n_vert, n_total, max_diff);

  const int n_pix = H * W;
  const dim3 grid((n_pix + threads - 1) / threads, B);
  ccl_count<<<grid, threads, 0, s>>>(vv, L, S, n_pix);
  ccl_keep<<<grid, threads, 0, s>>>(vv, L, S, (uint8_t*)keep, n_pix,
                                    max_size);
  return (int)cudaGetLastError();
}
