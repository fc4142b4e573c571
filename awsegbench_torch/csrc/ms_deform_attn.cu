// Multi-scale deformable attention sampling (K11), forward only:
//
//   out[b, q, h, :] = Σ_l Σ_p attn[b, q, h, l, p] ·
//                     bilinear(value_l[b, :, :, h, :], loc[b, q, h, l, p])
//
// Mask2Former's pixel decoder (models/mask2former.py) calls it once per
// encoder layer; the TPU package has no such kernel. A sampling location
// (x, y) ∈ [0, 1]² on level l of size H_l × W_l is read at pixel
// (x·W_l − 0.5, y·H_l − 0.5), bilinear over the four neighbours, a
// neighbour outside the map reading zero (grid_sample's align_corners=False
// with zero padding; a point with no neighbour inside adds nothing).
//
// Layout, all contiguous: value [B, S, M, D] in bf16 or f32 (S the levels'
// H_l·W_l summed, level l starting at Σ_{k<l} H_k·W_k), loc [B, Lq, M, L,
// P, 2] f32 (x, y), attn [B, Lq, M, L, P] f32 (softmaxed over L·P), out
// [B, Lq, M, D] in value's dtype. D % 8 == 0, L ≤ 4.
//
// Design: one thread per (query, head, 8 channels), so that at M = 8, D =
// 32 one warp is one query and every tap is a 16-byte load (bf16; two for
// f32) of 8 neighbouring channels; the four lanes of a head read the same
// location and weight (one broadcast load). Neighbouring queries of a block
// sample neighbouring pixels, so most taps hit L1/L2: the kernel is bound by
// the gather, not by HBM. The bilinear weights and the sum are f32; the
// output is rounded once. Locations stay f32: in bf16 a location on a
// 256-wide map is off by up to a pixel.
//
// Bound on the H100 at Mask2Former-R50's 1024×2048 batch of 4 (Lq = S =
// 43,008, M = 8, D = 32, L = 3, P = 4): value 88 MB, locations 132 MB,
// weights 66 MB read once, the output 88 MB written: 374 MB, 0.11 ms at
// 3.35 TB/s (portbench/counts/mask2former.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// 8 channels of one tap, widened to f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ms_deform_attn_kernel(const T* __restrict__ value,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn, T* __restrict__ out,
                          int64_t n_threads, int lq, int s, int m, int d,
                          int n_levels, int n_points, Levels lv) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_threads) return;
  const int groups = d / 8;                 // 8-channel groups of a head
  const int c0 = (int)(t % groups) * 8;
  const int64_t qh = t / groups;            // (b, q, h)
  const int h = (int)(qh % m);
  const int64_t bq = qh / m;                // (b, q)
  const int64_t b = bq / lq;
  const T* vbase = value + (size_t)b * s * m * d + (size_t)h * d + c0;
  const size_t pix_stride = (size_t)m * d;  // one pixel of one level
  const int lp = n_levels * n_points;
  const float* lrow = loc + (size_t)qh * lp * 2;
  const float* arow = attn + (size_t)qh * lp;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int l = 0; l < n_levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const T* vl = vbase + (size_t)lv.start[l] * pix_stride;
#pragma unroll 4
    for (int p = 0; p < n_points; ++p) {
      const int k = l * n_points + p;
      const float2 xy = __ldg(reinterpret_cast<const float2*>(lrow) + k);
      const float a = __ldg(arow + k);
      const float y = xy.y * hl - 0.5f, x = xy.x * wl - 0.5f;
      if (!(y > -1.f && x > -1.f && y < (float)hl && x < (float)wl)) continue;
      const float yf = floorf(y), xf = floorf(x);
      const int y0 = (int)yf, x0 = (int)xf;
      const float ly = y - yf, lx = x - xf, hy = 1.f - ly, hx = 1.f - lx;
      const float wt[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
      const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
      const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
      float tap[8], val[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) val[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (ys[c] < 0 || xs[c] < 0 || ys[c] > hl - 1 || xs[c] > wl - 1)
          continue;
        load8(vl + ((size_t)ys[c] * wl + xs[c]) * pix_stride, tap);
#pragma unroll
        for (int i = 0; i < 8; ++i) val[i] = fmaf(wt[c], tap[i], val[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(a, val[i], acc[i]);
    }
  }
  store8(out + (size_t)qh * d + c0, acc);
}

template <typename T>
int launch(const void* value, const void* loc, const void* attn, void* out,
           int b, int s, int lq, int m, int d, int n_levels, int n_points,
           const Levels& lv, cudaStream_t stream) {
  const int64_t n = (int64_t)b * lq * m * (d / 8);
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  ms_deform_attn_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, n, lq,
      s, m, d, n_levels, n_points, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// hw: the levels' (H_l, W_l), n_levels pairs. Returns a CUDA error code.
extern "C" int ms_deform_attn_launch(const void* value, const void* loc,
                                     const void* attn, void* out, int b,
                                     int s, int lq, int m, int d,
                                     int n_levels, int n_points,
                                     const int* hw, int is_bf16,
                                     void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || d % 8 != 0 || n_points < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != s) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(value, loc, attn, out, b, s, lq, m, d,
                                 n_levels, n_points, lv, st);
  return launch<float>(value, loc, attn, out, b, s, lq, m, d, n_levels,
                       n_points, lv, st);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
