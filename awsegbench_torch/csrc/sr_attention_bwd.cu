// Spatial-reduction attention backward: given out = softmax(q·kᵀ·scale)·v
// and dO, computes
//   P  = softmax(q·kᵀ·scale)                       (recomputed, never stored)
//   dP = dO·vᵀ,  delta = rowsum(P∘dP) = dO·out
//   dS = P∘(dP − delta)·scale
//   dq = dS·k,  dk = dSᵀ·q,  dv = Pᵀ·dO.
//
// Replaces the TPU kernel awsegbench/ops/attention.py::_attn_bwd_kernel
// (pallas_call in _sr_attention_backward). That kernel ran one grid step per
// (head-group, q-tile) in order on one core and summed dk/dv across the
// q-tiles in a revisited output block. Hopper blocks run in parallel and in
// no order, so this file splits the work into three kernels and keeps the
// sums deterministic (no float atomics: two runs give equal gradients):
//
//  1. attn_bwd_dq: one thread per query row (as the forward, K/V streamed
//     through shared memory). Pass 1 is the forward's online softmax: the
//     row max m, the row sum l and the f32 output o, whence delta = dO·o
//     (equal to rowsum(P∘dP), one pass fewer). Pass 2 recomputes
//     P = exp(s − m)/l and dP per key and accumulates dq. It also writes
//     (m, l, delta) per row for kernel 2.
//  2. attn_bwd_dkdv: one thread per key row; the block walks one split of
//     the query rows (q and dO tiles streamed through shared memory) and
//     writes f32 partial dk/dv for that split. Splitting N gives the card
//     enough blocks at MiT stage 1, where G = 8 and M = 512 leave only 64
//     key tiles.
//  3. attn_bwd_reduce: sums the splits' partials in split order.
//
// Rounding follows the TPU kernel: in bf16 mode the matmul operands are
// bf16 (q, k, v, dO as given; dS rounded before dq and dk, P rounded before
// dv), every sum is f32, dq is stored in q's dtype and dk/dv in f32.
//
// Bound on the H100: the five products of the TPU kernel are 10·N·M·D flops
// per head-group (166 GFLOP over the 8 MiT-B0 attention layers at B=8
// 512×1024), about 0.17 ms at the bf16 tensor-core rate; the bytes (q, dO,
// dq at N×D, k, v, dk, dv at M×D) are a few tens of MB. Compute-bound.
// This first version does 2·N·M·D + 3·N·M·D + 4·N·M·D multiply-adds on the
// CUDA cores in f32 (pass 1, pass 2, kernel 2), far from that bound; moving
// the products onto the tensor cores is later work.
//
// Layout: q, dO, dq [G, N, D]; k, v [G, M, D]; all contiguous; D ∈ {32, 64}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTQ = 64;  // query rows per block (kernel 1) / per tile (2)
constexpr int kTK = 64;  // key rows per tile (kernel 1) / per block (2)
constexpr int kKC = 16;  // keys scored per step of the online softmax

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// The value a matmul operand of the TPU kernel takes: bf16 in bf16 mode.
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTQ)
    attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                T* __restrict__ dq, float* __restrict__ stats, int n, int m,
                float scale) {
  __shared__ float ks[kTK][D];
  __shared__ float vs[kTK][D];

  const int g = blockIdx.y;
  const int row = blockIdx.x * kTQ + threadIdx.x;
  const bool live = row < n;
  const size_t qoff = ((size_t)g * n + (live ? row : 0)) * D;
  const T* kg = k + (size_t)g * m * D;
  const T* vg = v + (size_t)g * m * D;

  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f32(q[qoff + d]);
    dor[d] = to_f32(dout[qoff + d]);
    acc[d] = 0.f;
  }

  // Pass 1: the forward's online softmax (row max, row sum, f32 output).
  float run_max = -INFINITY, run_sum = 0.f;
  for (int t0 = 0; t0 < m; t0 += kTK) {
    const int rows = min(kTK, m - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += kTQ) {
      ks[i / D][i % D] = to_f32(kg[(size_t)t0 * D + i]);
      vs[i / D][i % D] = to_f32(vg[(size_t)t0 * D + i]);
    }
    __syncthreads();
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
      const float alpha = expf(run_max - new_max);
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
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) delta += dor[d] * acc[d];
  delta /= run_sum;

  // Pass 2: P and dP per key, dq = Σ_j dS_j·k_j (acc reused).
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int t0 = 0; t0 < m; t0 += kTK) {
    const int rows = min(kTK, m - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += kTQ) {
      ks[i / D][i % D] = to_f32(kg[(size_t)t0 * D + i]);
      vs[i / D][i % D] = to_f32(vg[(size_t)t0 * D + i]);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < rows; ++j) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot += qr[d] * ks[j][d];
        dp += dor[d] * vs[j][d];
      }
      const float p = expf(dot * scale - run_max) / run_sum;
      const float ds = round_like(p * (dp - delta) * scale, q);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += ds * ks[j][d];
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) store(dq + qoff + d, acc[d]);
    const size_t r = (size_t)g * n + row;
    const size_t gn = (size_t)gridDim.y * n;
    stats[r] = run_max;
    stats[gn + r] = run_sum;
    stats[2 * gn + r] = delta;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTK)
    attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ stats, float* __restrict__ pk,
                  float* __restrict__ pv, int n, int m, int split_rows,
                  float scale) {
  __shared__ float qs[kTQ][D];
  __shared__ float dos[kTQ][D];
  __shared__ float ms[kTQ], ls[kTQ], dls[kTQ];

  const int G = gridDim.z, g = blockIdx.z, split = blockIdx.y;
  const int key = blockIdx.x * kTK + threadIdx.x;
  const bool live = key < m;
  const size_t koff = ((size_t)g * m + (live ? key : 0)) * D;
  const size_t gn = (size_t)G * n;

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = to_f32(k[koff + d]);
    vr[d] = to_f32(v[koff + d]);
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  const int i0 = split * split_rows, i1 = min(n, i0 + split_rows);
  for (int t0 = i0; t0 < i1; t0 += kTQ) {
    const int rows = min(kTQ, i1 - t0);
    const size_t base = ((size_t)g * n + t0) * D;
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += kTK) {
      qs[i / D][i % D] = to_f32(q[base + i]);
      dos[i / D][i % D] = to_f32(dout[base + i]);
    }
    if (threadIdx.x < rows) {
      const size_t r = (size_t)g * n + t0 + threadIdx.x;
      ms[threadIdx.x] = stats[r];
      ls[threadIdx.x] = stats[gn + r];
      dls[threadIdx.x] = stats[2 * gn + r];
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < rows; ++i) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot += qs[i][d] * kr[d];
        dp += dos[i][d] * vr[d];
      }
      const float p = expf(dot * scale - ms[i]) / ls[i];
      const float ds = round_like(p * (dp - dls[i]) * scale, q);
      const float pr = round_like(p, q);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] += pr * dos[i][d];
        dk[d] += ds * qs[i][d];
      }
    }
  }

  if (live) {
    const size_t off = (size_t)split * G * m * D + koff;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      pk[off + d] = dk[d];
      pv[off + d] = dv[d];
    }
  }
}

// out[x] = Σ_s part[s][x], s in order.
__global__ void attn_bwd_reduce(const float* __restrict__ pk,
                                const float* __restrict__ pv,
                                float* __restrict__ dk, float* __restrict__ dv,
                                size_t count, int splits) {
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < count;
       x += (size_t)gridDim.x * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += pk[(size_t)s * count + x];
      sv += pv[(size_t)s * count + x];
    }
    dk[x] = sk;
    dv[x] = sv;
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, const void* dout,
                 void* dq, float* stats, float* pk, float* pv, float* dk,
                 float* dv, int g, int n, int m, int split_rows, float scale,
                 cudaStream_t stream) {
  const int splits = (n + split_rows - 1) / split_rows;
  attn_bwd_dq<T, D><<<dim3((n + kTQ - 1) / kTQ, g), kTQ, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, stats, n,
      m, scale);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd_dkdv<T, D><<<dim3((m + kTK - 1) / kTK, splits, g), kTK, 0,
                        stream>>>((const T*)q, (const T*)k, (const T*)v,
                                  (const T*)dout, stats, pk, pv, n, m,
                                  split_rows, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t count = (size_t)g * m * D;
  const size_t want = (count + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  attn_bwd_reduce<<<blocks, 256, 0, stream>>>(pk, pv, dk, dv, count, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch from the caller: stats [3, G, N] f32; pk, pv [splits, G, M, D] f32
// with splits = ceil(N / split_rows), split_rows a multiple of 64.
extern "C" int sr_attention_bwd_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       void* dq, void* stats, void* pk,
                                       void* pv, void* dk, void* dv, int g,
                                       int n, int m, int d, int is_bf16,
                                       int split_rows, float scale,
                                       void* stream) {
  if (split_rows <= 0 || split_rows % kTQ) return (int)cudaErrorInvalidValue;
  float *st = (float*)stats, *a = (float*)pk, *b = (float*)pv;
  float *ok = (float*)dk, *ov = (float*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (d == 32)
      return launch_typed<__nv_bfloat16, 32>(q, k, v, dout, dq, st, a, b, ok,
                                             ov, g, n, m, split_rows, scale, s);
    if (d == 64)
      return launch_typed<__nv_bfloat16, 64>(q, k, v, dout, dq, st, a, b, ok,
                                             ov, g, n, m, split_rows, scale, s);
  } else {
    if (d == 32)
      return launch_typed<float, 32>(q, k, v, dout, dq, st, a, b, ok, ov, g, n,
                                     m, split_rows, scale, s);
    if (d == 64)
      return launch_typed<float, 64>(q, k, v, dout, dq, st, a, b, ok, ov, g, n,
                                     m, split_rows, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
