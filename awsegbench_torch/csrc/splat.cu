// Batched rain/snow splat: the union coverage mask of up to N capsules per
// image (rain streaks are segments with radius 0.5 or 1.5, snow flakes are
// circles with radius 1 or 4).
//
// Replaces the TPU kernel awsegbench/ops/splat.py::_splat_kernel_batched
// (pallas_call in splat_coverage_batched). The TPU kernel held one image's
// mask in VMEM and merged 40×256 windows of 32 drops at a time, after an
// XLA-side compaction and y-sort of the valid drops so its sequential loop
// could stop early. Blocks on Hopper run in parallel and in no order, so
// none of that is needed: the wrapper zeroes the mask, then one block per
// (drop slot, image) covers the drop's bounding box, inflated by r plus one
// pixel and clipped to the image, and stores 1.0f where a pixel is hit.
// Every store writes the same value, so overlapping drops race harmlessly.
// Slots marked invalid return at once.
//
// The hit test is _segment_coverage's (awsegbench/weather/corruption.py),
// in its operation order. This file is built with -fmad=false: a contracted
// multiply-add would round differently and move some `d2 <= r*r` decisions,
// and the mask must equal its plain version bit for bit.
//
// Bound on the H100: the mask write (B·H·W·4 bytes) dominates; the drops
// touch a few hundred pixels each, so it is memory-bound.
//
// params: [B, N, 8] f32 rows (ax, ay, bx, by, radius, valid, 0, 0) in pixel
// coordinates; mask: [B, H, W] f32, zeroed by the caller.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    splat_kernel(const float* __restrict__ params, float* __restrict__ mask,
                 int n, int h, int w) {
  const float* prm = params + ((size_t)blockIdx.y * n + blockIdx.x) * 8;
  if (!(prm[5] > 0.f)) return;
  const float ax = prm[0], ay = prm[1], bx = prm[2], by = prm[3], r = prm[4];

  const int x0 = max(0, (int)floorf(fminf(ax, bx) - r) - 1);
  const int x1 = min(w - 1, (int)ceilf(fmaxf(ax, bx) + r) + 1);
  const int y0 = max(0, (int)floorf(fminf(ay, by) - r) - 1);
  const int y1 = min(h - 1, (int)ceilf(fmaxf(ay, by) + r) + 1);
  if (x0 > x1 || y0 > y1) return;
  const int bw = x1 - x0 + 1;
  const int npx = bw * (y1 - y0 + 1);

  const float dx = bx - ax;
  const float dy = by - ay;
  const float len2 = dx * dx + dy * dy;
  const float rr = r * r;
  float* m = mask + (size_t)blockIdx.y * h * w;

  for (int e = threadIdx.x; e < npx; e += kThreads) {
    const int yy = y0 + e / bw, xx = x0 + e % bw;
    const float px = (float)xx, py = (float)yy;
    float t = len2 > 0.f
                  ? ((px - ax) * dx + (py - ay) * dy) / fmaxf(len2, 1e-8f)
                  : 0.f;
    t = fminf(fmaxf(t, 0.f), 1.f);
    const float cx = ax + t * dx;
    const float cy = ay + t * dy;
    const float ex = px - cx;
    const float ey = py - cy;
    const float d2 = ex * ex + ey * ey;
    if (d2 <= rr) m[(size_t)yy * w + xx] = 1.0f;
  }
}

}  // namespace

extern "C" int splat_launch(const void* params, void* mask, int b, int n,
                            int h, int w, void* stream) {
  const dim3 grid(n, b);
  splat_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)params, (float*)mask, n, h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
