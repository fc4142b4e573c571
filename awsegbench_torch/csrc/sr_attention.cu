// Spatial-reduction attention forward: out = softmax(q·kᵀ·scale)·v.
//
// Replaces the TPU kernel awsegbench/ops/attention.py::_attn_kernel
// (pallas_call in _sr_attention_forward). That kernel held the whole
// [TQ, M] score tile and the whole K/V block in VMEM (M ≤ 4096). A Hopper
// block has at most 227 KB of shared memory and far fewer registers, so
// this kernel streams K/V through shared memory in 64-row tiles and keeps
// an online softmax (running max, running sum, rescaled f32 accumulator of
// D values in registers), updated 16 keys at a time. Shared memory is
// bounded for every M and the scores never leave registers.
//
// Layout: q [G, N, D], k/v [G, M, D], out [G, N, D], all contiguous, in
// bf16 or f32 (out in q's dtype). All arithmetic is f32.
//
// Bound on the H100: at the MiT-B0 shapes (D = 32, M = 512) the work is
// 4·N·M·D flops per (g) against 4·(N + M)·D bytes of bf16 traffic, about
// M = 512 flops per byte when N ≫ M: compute-bound. This first version
// runs the products on the CUDA cores in f32 (one thread per query row,
// K/V tiles broadcast from shared memory), so it is far from the
// tensor-core bound; a wgmma version is later work.
//
// Grid: (ceil(N/64), G); block: 64 threads, one query row each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTQ = 64;  // query rows per block
constexpr int kTK = 64;  // key/value rows per shared tile
constexpr int kKC = 16;  // keys scored per step of the online softmax

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTQ)
    sr_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int n,
                        int m, float scale) {
  __shared__ float ks[kTK][D];
  __shared__ float vs[kTK][D];

  const int g = blockIdx.y;
  const int row = blockIdx.x * kTQ + threadIdx.x;
  const bool live = row < n;
  const T* qrow = q + ((size_t)g * n + (live ? row : 0)) * D;
  const T* kg = k + (size_t)g * m * D;
  const T* vg = v + (size_t)g * m * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f32(qrow[d]);
    acc[d] = 0.f;
  }
  float run_max = -INFINITY;
  float run_sum = 0.f;

  for (int t0 = 0; t0 < m; t0 += kTK) {
    const int rows = min(kTK, m - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < rows * D; i += kTQ) {
      ks[i / D][i % D] = to_f32(kg[(size_t)t0 * D + i]);
      vs[i / D][i % D] = to_f32(vg[(size_t)t0 * D + i]);
    }
    __syncthreads();

    // kKC keys at a time: their scores stay in registers, and the unrolled
    // body stays small enough to compile quickly.
#pragma unroll 1
    for (int j0 = 0; j0 < rows; j0 += kKC) {
      float s[kKC];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        if (j0 + j < rows) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot += qr[d] * ks[j0 + j][d];
          s[j] = dot * scale;
          chunk_max = fmaxf(chunk_max, s[j]);
        }
      }
      const float new_max = fmaxf(run_max, chunk_max);
      const float alpha = expf(run_max - new_max);  // 0 on the first chunk
      run_sum *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        if (j0 + j < rows) {
          const float p = expf(s[j] - new_max);
          run_sum += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += p * vs[j0 + j][d];
        }
      }
      run_max = new_max;
    }
  }

  if (live) {
    T* orow = out + ((size_t)g * n + row) * D;
    const float inv = 1.f / run_sum;
#pragma unroll
    for (int d = 0; d < D; ++d) store(orow + d, acc[d] * inv);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out, int g,
                 int n, int m, int d, float scale, cudaStream_t stream) {
  const dim3 grid((n + kTQ - 1) / kTQ, g);
  if (d == 32) {
    sr_attention_kernel<T, 32><<<grid, kTQ, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, n, m, scale);
  } else if (d == 64) {
    sr_attention_kernel<T, 64><<<grid, kTQ, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, n, m, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sr_attention_launch(const void* q, const void* k, const void* v,
                                   void* out, int g, int n, int m, int d,
                                   int is_bf16, float scale, void* stream) {
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, out, g, n, m, d, scale,
                                       (cudaStream_t)stream);
  return launch_typed<float>(q, k, v, out, g, n, m, d, scale,
                             (cudaStream_t)stream);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
