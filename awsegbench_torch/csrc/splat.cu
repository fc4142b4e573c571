// Rain/snow splat: the union coverage mask of up to N capsules (rain streaks
// are segments with radius 0.5 or 1.5, snow flakes are circles with radius
// 1 or 4). Two kernels, one hit test:
//
// * splat_tiles_kernel, one body for K3 and K4. K3, a batch of images,
//   replaces the TPU kernel awsegbench/ops/splat.py::_splat_kernel_batched
//   (pallas_call in splat_coverage_batched), which held one image's mask in
//   VMEM and merged 40×256 windows of 32 drops at a time after an XLA-side
//   compaction and y-sort of the valid drops. K4, one image of at most
//   1 Mpx (padded as the TPU dispatch pads), replaces _splat_kernel_windowed
//   (pallas_call in splat_coverage_pallas); it is the same launch with
//   B = 1. Blocks on Hopper run in parallel and in no order, and the mask
//   write is the cost, so each pixel is written exactly once and nothing
//   zero-fills the mask first: one block per (tile, image) culls the
//   image's N drop slots (valid, and the inflated box meets the tile),
//   compacts the kept drops into shared memory with a warp ballot (the
//   union is order-free), lets each warp test the pixels of one kept
//   drop's box at a time (a lane a pixel), marking hits in a byte map of
//   the tile in shared memory, and then stores the tile with one 16-byte
//   store per 4 columns (scalar stores when W % 4 != 0). A tile that keeps
//   no drop stores zeros and tests nothing. All blocks of a batch fit the
//   card at once, so a block's stores wait for its cull and tests: large
//   tiles (fewer culls of the params) measured fastest (PERF.md §6).
// * splat_tiled_kernel (K5), one image above 1 Mpx. Replaces _splat_kernel
//   (pallas_call in splat_coverage_pallas): tile-parallel with a per-tile
//   bounding-box cull. One block per 32×32 tile walks the drops in chunks
//   of 256 (one per thread), keeps those whose box meets the tile in shared
//   memory, tests its pixels against them and writes every pixel of the
//   tile once, so the mask needs no zero-fill. The TPU's 256×512 tiles were
//   a VMEM layout; 32×32 keeps 2048 blocks in flight at 2048×1024.
//
// The hit test is _segment_coverage's (awsegbench/weather/corruption.py),
// in its operation order, and computes the exact union d2 <= r² (the TPU's
// windowed kernel equals it under its drop-size contract, which every
// production draw meets). A pixel the drop covers lies inside its box
// inflated by r plus one pixel, so the culls drop no hit. This file is
// built with -fmad=false: a contracted multiply-add would round
// differently and move some `d2 <= r*r` decisions, and the mask must equal
// its plain version bit for bit.
//
// Bound on the H100: the mask write (H·W·4 bytes per image) dominates; the
// drops touch a few hundred pixels each, so both kernels are memory-bound.
// Each K3/K4 block also reads the image's N·32 bytes of params (from L2
// after the first block of the image).
//
// params: [B, N, 8] (K3, K4 with B = 1) or [N, 8] (K5) f32 rows (ax, ay,
// bx, by, radius, valid, 0, 0) in pixel coordinates; mask: [B, H, W] or
// [H, W] f32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// K3/K4's tiles (rows, columns), measured by scripts/tune_splat_tiles.py:
// 128×64 for a batch, 16×128 for one image (where the batch's tiles would
// give 64 blocks to 132 SMs).
#ifndef SPLAT_BATCH_ROWS
#define SPLAT_BATCH_ROWS 128
#define SPLAT_BATCH_COLS 64
#endif
#ifndef SPLAT_IMAGE_ROWS
#define SPLAT_IMAGE_ROWS 16
#define SPLAT_IMAGE_COLS 128
#endif
constexpr int kThreads = 256;  // K3, K4: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCull = 512;     // drop slots culled per round (2 a thread)
constexpr int kTile = 32;          // K5: 32×32 pixels per block
constexpr int kTileThreads = 256;  // K5: 8 rows of 32 at a time

// The drop's bounding box inflated by r plus one pixel (unclipped).
struct Box {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ Box drop_box(const float* prm) {
  const float ax = prm[0], ay = prm[1], bx = prm[2], by = prm[3], r = prm[4];
  return {(int)floorf(fminf(ax, bx) - r) - 1, (int)ceilf(fmaxf(ax, bx) + r) + 1,
          (int)floorf(fminf(ay, by) - r) - 1, (int)ceilf(fmaxf(ay, by) + r) + 1};
}

__device__ __forceinline__ bool hit(float px, float py, float ax, float ay,
                                    float bx, float by, float r) {
  const float dx = bx - ax;
  const float dy = by - ay;
  const float len2 = dx * dx + dy * dy;
  float t = len2 > 0.f ? ((px - ax) * dx + (py - ay) * dy) / fmaxf(len2, 1e-8f)
                       : 0.f;
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float cx = ax + t * dx;
  const float cy = ay + t * dy;
  const float ex = px - cx;
  const float ey = py - cy;
  return ex * ex + ey * ey <= r * r;
}

// A kept drop: the capsule and its inflated box.
struct Kept {
  float ax, ay, bx, by, r;
  Box box;
};

// K3/K4's shared state: the kept drops of the tile and its byte map.
template <int TR, int TC>
struct TileState {
  Kept kept[kCull];
  int n_kept;
  __align__(16) unsigned char map[TR][TC];
};

// Keeps slots d0 .. d0 + kCull - 1 of the image's drops that are valid and
// whose inflated box meets the tile [tx0, tx1] × [ty0, ty1]. Each thread
// loads its slots' rows first; then every lane takes part in each ballot
// (the union is order-free, so the compaction may reorder the drops).
template <class State>
__device__ __forceinline__ void cull(State& st,
                                     const float* __restrict__ prm_img,
                                     int d0, int n, int tx0, int tx1,
                                     int ty0, int ty1) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) st.n_kept = 0;
  __syncthreads();
  constexpr int kPer = kCull / kThreads;
  float v[kPer][5] = {};  // ax, ay, bx, by, r
  bool valid[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int d = d0 + k * kThreads + tid;
    valid[k] = false;
    if (d < n) {  // one 16-byte and one 8-byte load of the 32-byte row
      const float* prm = prm_img + (size_t)d * 8;
      const float4 seg = *reinterpret_cast<const float4*>(prm);
      const float2 rv = *reinterpret_cast<const float2*>(prm + 4);
      v[k][0] = seg.x, v[k][1] = seg.y, v[k][2] = seg.z, v[k][3] = seg.w;
      v[k][4] = rv.x;
      valid[k] = rv.y > 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const Box bx = drop_box(v[k]);
    const bool keep = valid[k] && bx.x1 >= tx0 && bx.x0 <= tx1 &&
                      bx.y1 >= ty0 && bx.y0 <= ty1;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&st.n_kept, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep)
      st.kept[base + __popc(ballot & ((1u << lane) - 1u))] =
          Kept{v[k][0], v[k][1], v[k][2], v[k][3], v[k][4], bx};
  }
  __syncthreads();
}

// Marks in the map the pixels of the tile [tx0, tx1] × [ty0, ty1] that the
// kept drops cover: warp w takes drops w, w + 8, ..., a lane a pixel of the
// drop's box clipped to the tile, walked in row-major order 32 pixels a
// step (no division in the loop).
template <class State>
__device__ __forceinline__ void cover(State& st, int tx0, int tx1, int ty0,
                                      int ty1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < st.n_kept; s += kWarps) {
    const Kept kd = st.kept[s];
    const int x0 = max(kd.box.x0, tx0), x1 = min(kd.box.x1, tx1);
    const int y0 = max(kd.box.y0, ty0), y1 = min(kd.box.y1, ty1);
    if (x0 > x1 || y0 > y1) continue;
    // (n + 0.5) / bw in f32 floors to n / bw exactly for these small n
    const int bw = x1 - x0 + 1;
    const float inv_bw = 1.f / (float)bw;
    const int step_y = (int)(32.5f * inv_bw), step_x = 32 - step_y * bw;
    const int ly = (int)(((float)lane + 0.5f) * inv_bw);
    int yy = y0 + ly, xx = x0 + lane - ly * bw;
    while (yy <= y1) {
      if (hit((float)xx, (float)yy, kd.ax, kd.ay, kd.bx, kd.by, kd.r))
        st.map[yy - ty0][xx - tx0] = 1;  // every store writes the same 1
      xx += step_x;
      yy += step_y;
      if (xx > x1) xx -= bw, ++yy;
    }
  }
}

// K3 and K4: one block per (TR×TC tile, image). The block culls the
// image's drop slots (kCull at a time), marks the tile's covered pixels in
// the map, then each thread turns 4 bytes of the map at a time into one
// 16-byte store of the mask (scalar stores when W % 4 != 0).
template <int TR, int TC>
__global__ void __launch_bounds__(kThreads)
    splat_tiles_kernel(const float* __restrict__ params,
                       float* __restrict__ mask, int n, int h, int w) {
  static_assert(TC % 16 == 0, "map rows are whole 16-byte words");
  constexpr int kWords = TR * TC / 4;  // 4-column words of the tile
  __shared__ TileState<TR, TC> st;
  const int tx0 = blockIdx.x * TC, ty0 = blockIdx.y * TR;
  const int tx1 = min(tx0 + TC, w) - 1, ty1 = min(ty0 + TR, h) - 1;
  const float* prm_img = params + (size_t)blockIdx.z * n * 8;
  float* m = mask + (size_t)blockIdx.z * h * w;
  const int tid = threadIdx.x;
  unsigned* words = reinterpret_cast<unsigned*>(&st.map[0][0]);
  for (int q = tid; q < kWords; q += kThreads) words[q] = 0u;
  for (int d0 = 0; d0 < n; d0 += kCull) {
    cull(st, prm_img, d0, n, tx0, tx1, ty0, ty1);  // its barriers order the
    cover(st, tx0, tx1, ty0, ty1);                  // zeroing before marks
    __syncthreads();  // the map is marked; the next round rewrites kept
  }
  if (n <= 0) __syncthreads();  // the zeroed map, when no round ran

  const bool vec = (w & 3) == 0 &&
                   (reinterpret_cast<size_t>(mask) & 15) == 0;
  for (int q = tid; q < kWords; q += kThreads) {
    const int ry = q / (TC / 4), rx = 4 * (q % (TC / 4));
    const int y = ty0 + ry, x = tx0 + rx;
    if (y > ty1 || x > tx1) continue;
    const uchar4 c = *reinterpret_cast<const uchar4*>(&words[q]);
    const float f[4] = {c.x ? 1.f : 0.f, c.y ? 1.f : 0.f, c.z ? 1.f : 0.f,
                        c.w ? 1.f : 0.f};
    float* dst = m + (size_t)y * w + x;
    if (vec) {  // W % 4 == 0: all 4 columns lie in the row
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j <= tx1) dst[j] = f[j];
    }
  }
}

template <int TR, int TC>
int launch_tiles(const float* params, float* mask, int b, int n, int h,
                 int w, cudaStream_t stream) {
  const dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, b);
  splat_tiles_kernel<TR, TC><<<grid, kThreads, 0, stream>>>(params, mask, n,
                                                            h, w);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kTileThreads)
    splat_tiled_kernel(const float* __restrict__ params,
                       float* __restrict__ mask, int n, int h, int w) {
  __shared__ float kept[kTileThreads][5];
  __shared__ int n_kept;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int col = tx0 + (tid & (kTile - 1));
  const int row0 = ty0 + tid / kTile;
  constexpr int kRows = kTile * kTile / kTileThreads;
  bool covered[kRows] = {};

  for (int d0 = 0; d0 < n; d0 += kTileThreads) {
    if (tid == 0) n_kept = 0;
    __syncthreads();
    const int d = d0 + tid;
    if (d < n) {  // cull: keep valid drops whose box meets the tile
      const float* prm = params + (size_t)d * 8;
      const Box bx = drop_box(prm);
      if (prm[5] > 0.f && bx.x1 >= tx0 && bx.x0 < tx0 + kTile &&
          bx.y1 >= ty0 && bx.y0 < ty0 + kTile) {
        const int slot = atomicAdd(&n_kept, 1);  // the union is order-free
#pragma unroll
        for (int k = 0; k < 5; ++k) kept[slot][k] = prm[k];
      }
    }
    __syncthreads();
    for (int s = 0; s < n_kept; ++s) {
      const float *kp = kept[s];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        covered[k] = covered[k] || hit((float)col, (float)(row0 + 8 * k),
                                       kp[0], kp[1], kp[2], kp[3], kp[4]);
    }
    __syncthreads();  // kept is rewritten by the next chunk
  }
  if (col < w) {
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (row0 + 8 * k < h)
        mask[(size_t)(row0 + 8 * k) * w + col] = covered[k] ? 1.0f : 0.0f;
  }
}

}  // namespace

// K3 and K4: params [b, n, 8] → mask [b, h, w] (K4: b = 1); writes every
// pixel, so the mask needs no zero-fill.
extern "C" int splat_tiles_launch(const void* params, void* mask, int b,
                                  int n, int h, int w, void* stream) {
  return b == 1 ? launch_tiles<SPLAT_IMAGE_ROWS, SPLAT_IMAGE_COLS>(
                      (const float*)params, (float*)mask, b, n, h, w,
                      (cudaStream_t)stream)
                : launch_tiles<SPLAT_BATCH_ROWS, SPLAT_BATCH_COLS>(
                      (const float*)params, (float*)mask, b, n, h, w,
                      (cudaStream_t)stream);
}

// K5: params [n, 8] → mask [h, w]; writes every pixel.
extern "C" int splat_tiled_launch(const void* params, void* mask, int n,
                                  int h, int w, void* stream) {
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  splat_tiled_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
      (const float*)params, (float*)mask, n, h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
