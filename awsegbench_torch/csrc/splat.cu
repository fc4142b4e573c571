// Rain/snow splat: the union coverage mask of up to N capsules (rain streaks
// are segments with radius 0.5 or 1.5, snow flakes are circles with radius
// 1 or 4). Three kernels, one hit test:
//
// * splat_kernel (K3), a batch of images. Replaces the TPU kernel
//   awsegbench/ops/splat.py::_splat_kernel_batched (pallas_call in
//   splat_coverage_batched). The TPU kernel held one image's mask in VMEM
//   and merged 40×256 windows of 32 drops at a time, after an XLA-side
//   compaction and y-sort of the valid drops so its sequential loop could
//   stop early. Blocks on Hopper run in parallel and in no order, so none
//   of that is needed: the wrapper zeroes the mask, then one block per
//   (drop slot, image) covers the drop's bounding box, inflated by r plus
//   one pixel and clipped to the image, and stores 1.0f where a pixel is
//   hit. Every store writes the same value, so overlapping drops race
//   harmlessly. Slots marked invalid return at once.
// * splat_windowed_kernel (K4), one image of at most 1 Mpx (padded as the
//   TPU dispatch pads). Replaces _splat_kernel_windowed (pallas_call in
//   splat_coverage_pallas), whose idea it keeps: each drop touches only a
//   window around itself. The launch zero-fills the mask, then one block
//   per drop slot tests its bounding box, as K3 does for one image.
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
// production draw meets). This file is built with -fmad=false: a
// contracted multiply-add would round differently and move some
// `d2 <= r*r` decisions, and the mask must equal its plain version bit for
// bit.
//
// Bound on the H100: the mask write (H·W·4 bytes per image) dominates; the
// drops touch a few hundred pixels each, so all three are memory-bound.
//
// params: [B, N, 8] (K3) or [N, 8] (K4, K5) f32 rows (ax, ay, bx, by,
// radius, valid, 0, 0) in pixel coordinates; mask: [B, H, W] or [H, W] f32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;      // K3, K4
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

// Stores 1.0f at every pixel of the [h, w] mask m that the drop covers.
__device__ __forceinline__ void cover_drop(const float* __restrict__ prm,
                                           float* __restrict__ m, int h,
                                           int w) {
  if (!(prm[5] > 0.f)) return;
  const Box bx = drop_box(prm);
  const int x0 = max(0, bx.x0), x1 = min(w - 1, bx.x1);
  const int y0 = max(0, bx.y0), y1 = min(h - 1, bx.y1);
  if (x0 > x1 || y0 > y1) return;
  const int bw = x1 - x0 + 1;
  const int npx = bw * (y1 - y0 + 1);
  for (int e = threadIdx.x; e < npx; e += blockDim.x) {
    const int yy = y0 + e / bw, xx = x0 + e % bw;
    if (hit((float)xx, (float)yy, prm[0], prm[1], prm[2], prm[3], prm[4]))
      m[(size_t)yy * w + xx] = 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    splat_kernel(const float* __restrict__ params, float* __restrict__ mask,
                 int n, int h, int w) {
  cover_drop(params + ((size_t)blockIdx.y * n + blockIdx.x) * 8,
             mask + (size_t)blockIdx.y * h * w, h, w);
}

__global__ void __launch_bounds__(kThreads)
    splat_windowed_kernel(const float* __restrict__ params,
                          float* __restrict__ mask, int h, int w) {
  cover_drop(params + (size_t)blockIdx.x * 8, mask, h, w);
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

// K3: params [b, n, 8] → mask [b, h, w], zeroed by the caller.
extern "C" int splat_launch(const void* params, void* mask, int b, int n,
                            int h, int w, void* stream) {
  const dim3 grid(n, b);
  splat_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)params, (float*)mask, n, h, w);
  return (int)cudaGetLastError();
}

// K4: params [n, 8] → mask [h, w]; zero-fills the mask itself.
extern "C" int splat_windowed_launch(const void* params, void* mask, int n,
                                     int h, int w, void* stream) {
  int rc = (int)cudaMemsetAsync(mask, 0, (size_t)h * w * sizeof(float),
                                (cudaStream_t)stream);
  if (rc || n == 0) return rc;
  splat_windowed_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)params, (float*)mask, h, w);
  return (int)cudaGetLastError();
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
