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
//   1. local:    one tile of 16 rows of 32 pixels per block labels
//                itself in shared memory: the runs along each row from two
//                ballots of its warp (a pixel points to its run's first
//                pixel), one union per pair of runs that meet between two
//                rows (union-find with atomicMin on roots), compression;
//                then it counts each tile root's pixels in shared memory
//                (one add a run of a warp's pixels with one root), writes
//                each pixel's tile root as a frame-local index, and the
//                count at the root's pixel in sizes (0 everywhere else);
//   2. boundary: one thread per pixel pair across a tile edge unions the
//                two tile trees in global memory (the same lock-free
//                union: a link always points to a smaller index, so no
//                cycle forms, and a failed atomicMin retries). It links
//                tile roots only: every other pixel keeps its tile root;
//   3. count:    one thread per tile root (sizes > 0) finds its global
//                root r, points its own link straight at r and, if it is
//                not r itself, adds its tile's count to sizes[r]. Only
//                global roots receive adds, so no count is read while it
//                is written;
//   4. keep:     a pixel reads its tile root, that root's (now direct)
//                link r, and keep = valid && sizes[r] > max_size.
//
// Labels depend on the order of the atomics; the components, hence the
// keep-mask, do not, so it equals the plain twin bit for bit.
//
// What bounds it on the card: launches and latency. Per pixel the passes
// move ~4 B of disparity, 1 B of validity, ~16 B of labels and sizes and
// 1 B of output (~25 MB at the flagship's 1224x1024 after the ds2
// front-end, ~7 us of HBM time). There the four launches take 0.09-0.12
// ms, 0.06 of it in the kernels (boundary 0.03, local 0.02, count and
// keep 0.006 each; NVIDIA H100 80GB HBM3, 700 W). Two designs cost more:
// a pixel-level count (every valid pixel walking its tile roots' chain
// and adding one to its root's size) took 0.6 ms, because the layered
// scene's components are whole planes and ~1.25 M adds met a handful of
// addresses (0.83-0.88 ms with it, 0.23 with the adds taken out); a
// 32x32 tile united pixel by pixel took 0.15 ms in its local pass, where
// the runs from ballots leave one union per pair of runs. Tiles of 8, 16
// and 32 rows measured within 15 %; 16 was the fastest.
#include "common.cuh"

namespace {

// a tile is TILE_H rows of 32 pixels, one warp a row
constexpr int TILE_W = i3dr::WARP;
constexpr int TILE_H = 16;

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

__global__ void __launch_bounds__(TILE_W * TILE_H)
    ccl_local(const float* __restrict__ d, const uint8_t* __restrict__ valid,
              int* __restrict__ labels, int* __restrict__ sizes, int H, int W,
              float max_diff) {
  __shared__ int lab[TILE_W * TILE_H];
  __shared__ float ds[TILE_W * TILE_H];
  __shared__ int count[TILE_W * TILE_H];
  const int tx = threadIdx.x, ty = threadIdx.y;  // lane tx of the row's warp
  const int x = blockIdx.x * TILE_W + tx, y = blockIdx.y * TILE_H + ty;
  const long long frame = (long long)blockIdx.z * H * W;
  const int li = ty * TILE_W + tx;
  const bool in = x < W && y < H;
  const long long p = frame + (long long)y * W + x;
  const bool v = in && valid[p];
  const float dv = v ? d[p] : 0.0f;
  // runs along the row, from ballots: a valid pixel joined to its left
  // neighbour continues that neighbour's run, and points to the run's
  // first pixel
  const float dl = __shfl_up_sync(i3dr::FULL, dv, 1);
  const unsigned vmask = __ballot_sync(i3dr::FULL, v);
  const bool cont =
      v && tx > 0 && ((vmask >> (tx - 1)) & 1u) && joined(dv, dl, max_diff);
  const unsigned starts = __ballot_sync(i3dr::FULL, !cont);
  const int start = 31 - __clz(starts & (i3dr::FULL >> (31 - tx)));
  lab[li] = v ? ty * TILE_W + start : -1;  // -1: invalid, never united
  ds[li] = dv;
  count[li] = 0;
  __syncthreads();
  // the rows below: the two runs that meet where a pixel joins the one
  // below it, united once where the pair begins along the row
  int a = -1, b = -1;
  if (v && ty + 1 < TILE_H && lab[li + TILE_W] >= 0 &&
      joined(dv, ds[li + TILE_W], max_diff)) {
    a = lab[li];
    b = lab[li + TILE_W];
  }
  const int pa = __shfl_up_sync(i3dr::FULL, a, 1);
  const int pb = __shfl_up_sync(i3dr::FULL, b, 1);
  __syncthreads();  // every pair is read before any union links a root
  if (a >= 0 && (tx == 0 || pa != a || pb != b)) unite(lab, a, b);
  __syncthreads();
  // every union is done: compression only replaces a link by an ancestor
  const int r = v ? find_root(lab, li) : -1;
  if (v) lab[li] = r;
  // each tile root's pixels: one shared add a run of a warp's pixels with
  // one root
  const unsigned peers = __match_any_sync(i3dr::FULL, r);
  if (v && __ffs(peers) - 1 == tx) atomicAdd(&count[r], __popc(peers));
  __syncthreads();
  if (in) {
    labels[p] = v ? (blockIdx.y * TILE_H + r / TILE_W) * W +
                        blockIdx.x * TILE_W + r % TILE_W
                  : -1;
    sizes[p] = v && r == li ? count[li] : 0;
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
    x = (t / H + 1) * TILE_W - 1;
    dx = 1, dy = 0;
  } else {  // pixel above a horizontal tile edge, and the one below
    const int u = t - n_vert;
    x = u % W;
    y = (u / W + 1) * TILE_H - 1;
    dx = 0, dy = 1;
  }
  const long long frame = (long long)blockIdx.y * H * W;
  const int a = y * W + x, b = (y + dy) * W + x + dx;
  if (!valid[frame + a] || !valid[frame + b]) return;
  if (!joined(d[frame + a], d[frame + b], max_diff)) return;
  unite(labels + frame, a, b);
}

__global__ void ccl_count(int* labels, int* sizes, int n_pix) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const long long frame = (long long)blockIdx.y * n_pix;
  int* S = sizes + frame;
  const int c = S[i];
  if (c == 0) return;  // not a tile root
  int* L = labels + frame;
  const int r = find_root(L, i);
  if (r != i) {
    L[i] = r;  // the merge is over: any link may become its root
    atomicAdd(&S[r], c);
  }
}

__global__ void ccl_keep(const uint8_t* __restrict__ valid,
                         const int* __restrict__ labels,
                         const int* __restrict__ sizes,
                         uint8_t* __restrict__ keep, int n_pix, int max_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const long long frame = (long long)blockIdx.y * n_pix;
  const long long p = frame + i;
  bool k = false;
  if (valid[p]) {
    const int r = labels[frame + labels[p]];  // tile root, then its root
    k = sizes[frame + r] > max_size;
  }
  keep[p] = k;
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
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int tiles_y = (H + TILE_H - 1) / TILE_H;

  ccl_local<<<dim3(tiles_x, tiles_y, B), dim3(TILE_W, TILE_H), 0, s>>>(
      dd, vv, L, S, H, W, max_diff);

  const int n_vert = H * (tiles_x - 1);
  const int n_total = n_vert + W * (tiles_y - 1);
  const int threads = 256;
  if (n_total > 0)
    ccl_boundary<<<dim3((n_total + threads - 1) / threads, B), threads, 0,
                   s>>>(dd, vv, L, H, W, n_vert, n_total, max_diff);

  const int n_pix = H * W;
  const dim3 grid((n_pix + threads - 1) / threads, B);
  ccl_count<<<grid, threads, 0, s>>>(L, S, n_pix);
  ccl_keep<<<grid, threads, 0, s>>>(vv, L, S, (uint8_t*)keep, n_pix,
                                    max_size);
  return (int)cudaGetLastError();
}
