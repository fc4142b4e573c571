// The neighbourhood stack's adjoint: dpp [B, h, w, 81, C] → dP [B, h, w, 9,
// C], each clamped neighbour's gradient added back to the coarse cell it
// was gathered from (the transpose of the gather that K7, K8, K9 and K10
// make of P: pp[(3ky+dy)·9 + 3dx+kx, c] = P[b, clamp(i+dy-1), clamp(j+dx-1),
// ky, kx, c]). Both train backwards (K8, K10) run it on their dpp.
//
// The JAX package leaves this transpose to XLA's autodiff of its gather
// (awsegbench/ops/headkernels.py::_neighbor_pp); the port's plain version
// is ops/headkernels_train.py::_neighbor_pp_adjoint, in f32.
//
// A gather, not a scatter: each thread owns V channels of one dP element
// (b, i, j, ky, kx) and sums its sources in f32 in the plain version's
// order, so the result is bit-equal to _neighbor_pp_adjoint(dpp) rounded
// to dpp's dtype: along x first for each source row (the centre dx = 1,
// the left neighbour's dx = 0, the right neighbour's dx = 2, then the
// clamped edge terms), then those row sums along y in the same order.
//
// Bound on the H100: bytes. Every dpp element is read once (by the one dP
// element it feeds) and dP written once: at the seg head's B = 8, 16×32,
// C = 256 in bf16, 170 + 19 MB, 0.056 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// V values at p as floats (16-byte vector loads for V > 1), and back.
__device__ __forceinline__ void load(const float* p, float (&x)[1]) {
  x[0] = *p;
}
__device__ __forceinline__ void load(const bf16* p, float (&x)[1]) {
  x[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load(const bf16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store(float* p, const float (&x)[1]) {
  *p = x[0];
}
__device__ __forceinline__ void store(bf16* p, const float (&x)[1]) {
  *p = __float2bfloat16_rn(x[0]);
}
__device__ __forceinline__ void store(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store(bf16* p, const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k + 1]))
            << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int V>
__device__ __forceinline__ void add(float (&s)[V], const float (&t)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] += t[k];
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pp_adjoint(const T* __restrict__ dpp, T* __restrict__ dP, int B, int h,
               int w, int C) {
  const int cv = C / V;
  const size_t n = (size_t)B * h * w * 9 * cv;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int c = (int)(e % cv) * V;
  size_t rest = e / cv;
  const int tap = (int)(rest % 9);
  rest /= 9;
  const int j = (int)(rest % w);
  rest /= w;
  const int i = (int)(rest % h);
  const int b = (int)(rest / h);
  const int ky = tap / 3, kx = tap - 3 * ky;

  // dpp of cell (ii, jj), neighbour (dy, dx) of this tap, channels c..
  auto src = [&](int ii, int jj, int dy, int dx) {
    return dpp + ((((size_t)b * h + ii) * w + jj) * 81 +
                  (3 * ky + dy) * 9 + 3 * dx + kx) * C + c;
  };
  // the x pass: what row ii's cells gathered from column j at offset dy
  auto xsum = [&](int ii, int dy, float (&s)[V]) {
    float t[V];
    load(src(ii, j, dy, 1), s);
    if (j < w - 1) { load(src(ii, j + 1, dy, 0), t); add(s, t); }
    if (j > 0) { load(src(ii, j - 1, dy, 2), t); add(s, t); }
    if (j == 0) { load(src(ii, 0, dy, 0), t); add(s, t); }
    if (j == w - 1) { load(src(ii, w - 1, dy, 2), t); add(s, t); }
  };
  float acc[V], t[V];
  xsum(i, 1, acc);
  if (i < h - 1) { xsum(i + 1, 0, t); add(acc, t); }
  if (i > 0) { xsum(i - 1, 2, t); add(acc, t); }
  if (i == 0) { xsum(0, 0, t); add(acc, t); }
  if (i == h - 1) { xsum(h - 1, 2, t); add(acc, t); }
  store(dP + e * V, acc);
}

template <typename T, int V>
int launch(const void* dpp, void* dP, int B, int h, int w, int C,
           cudaStream_t stream) {
  const size_t n = (size_t)B * h * w * 9 * (C / V);
  if (n == 0) return 0;
  pp_adjoint<T, V><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>((const T*)dpp, (T*)dP, B, h, w, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dpp [B, h, w, 81, C] → dP [B, h, w, 9, C], both f32 or both bf16 (is_bf16).
// 16-byte loads where C allows (8 bf16 or 4 f32 channels a thread) and both
// pointers are 16-byte aligned, else one channel a thread.
extern "C" int pp_adjoint_launch(const void* dpp, void* dP, int B, int h,
                                 int w, int C, int is_bf16, void* stream) {
  if (B < 1 || h < 1 || w < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const bool aligned =
      (((uintptr_t)dpp | (uintptr_t)dP) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return aligned && C % 8 == 0 ? launch<bf16, 8>(dpp, dP, B, h, w, C, s)
                                 : launch<bf16, 1>(dpp, dP, B, h, w, C, s);
  return aligned && C % 4 == 0 ? launch<float, 4>(dpp, dP, B, h, w, C, s)
                               : launch<float, 1>(dpp, dP, B, h, w, C, s);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
