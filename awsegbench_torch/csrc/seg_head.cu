// Fused faithful segmentation head, eval mode:
//   logits = conv1x1(relu(BN(conv3x3(upsample_xr(f))))) per fine pixel.
//
// Replaces the TPU kernel awsegbench/ops/headkernels.py::_seg_kernel
// (pallas_call in seg_head_fused). Per coarse cell (b, i, j) it computes the
// r×r fine tile
//   fine[p,q,c] = Σ_b Ax[q,b] · (Σ_a Ay[p,a] · pp[a·9+b, c])
//   hidden      = relu(fine·a1[c] + c1[c])          (conv bias + BN folded)
//   logits[p,q] = hidden · wp + bp
// where pp[(3ky+dy)·9 + 3dx+kx, c] = P[b, i+dy-1, j+dx-1, ky, kx, c] are the
// coarse partial products P = f·W1 of the 3×3 neighbourhood (clamped at the
// coarse edges, which is the bilinear clamp). The TPU kernel ran one
// [r², 81]×[81, C] matmul against kron(Ay, Ax); staged in f32 that table is
// 330 KB, more than a Hopper block's shared memory, so this kernel uses the
// factorisation (two 9-tap passes) with the [r, 9] tables in shared memory
// and registers. It also gathers the 3×3 neighbourhood itself from P, so
// the 9× larger pp tensor is never written to device memory.
//
// The full-resolution 256-channel hidden never leaves the SM: C is walked in
// slices of kCS channels, each slice's pp block [81, kCS] and y-pass result
// [r, 9, kCS] live in shared memory, and the nc logits of each of a thread's
// four fine pixels accumulate in registers.
//
// bf16 mode rounds where the TPU kernel does: bf16 operands (P, wp), f32
// accumulation, hidden rounded to bf16 before the 1×1, f32 logits + bp,
// output rounded to bf16. One place differs, forced by the factorisation:
// the TPU kernel rounds the products of kron(Ay, Ax) to bf16, and a product
// of two factors cannot be rounded inside two separate passes. The tables
// hold multiples of 1/(2r), so up to r = 8 the products are exact in bf16
// and the two kernels agree bit for bit; at r = 32 the TPU kernel's rounded
// table moves some outputs by one bf16 step, and this kernel stays the
// closer of the two to the f32 head (tests/test_torch_ops.py,
// test_seg_head_bf16_against_jax).
//
// Bound on the H100: the work is about 15.6 kflop per output pixel
// (1296 y-pass + 4608 x-pass + 2·C·nc = 9728 for the 1×1) against 2·nc
// bytes written, so it is compute-bound. This first version runs all of it
// on the CUDA cores in f32; moving the 1×1 and the passes onto the tensor
// cores (wgmma) is later work.
//
// Grid: (w, h, B); block: 256 threads = 8 warps; lane = fine column q, warp
// wy owns fine rows wy, wy+8, wy+16, wy+24. Requires r ≤ 32, C % kCS == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCS = 16;    // channels per shared slice
constexpr int kRMax = 32;  // largest upsample factor
constexpr int kRows = 4;   // fine rows per thread (kRMax / 8 warps)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    seg_head_kernel(const T* __restrict__ P,      // [B, h, w, 9, C]
                    const float* __restrict__ ay,  // [r, 9]  cols 3ky+dy
                    const float* __restrict__ ax,  // [r, 9]  cols 3dx+kx
                    const float* __restrict__ a1,  // [C]
                    const float* __restrict__ c1,  // [C]
                    const T* __restrict__ wp,      // [C, NC]
                    const float* __restrict__ bp,  // [NC]
                    T* __restrict__ out,           // [B, h·r, w·r, NC]
                    int h, int w, int C, int r) {
  __shared__ float pp_s[81][kCS];
  __shared__ float t_s[kRMax][9][kCS];
  __shared__ float ay_s[kRMax][9];
  __shared__ float wp_s[kCS][NC];
  __shared__ float a1_s[kCS], c1_s[kCS];

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wy = tid >> 5;
  const int q = lane;

  for (int e = tid; e < r * 9; e += kThreads) ay_s[e / 9][e % 9] = ay[e];
  float axr[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) axr[t] = q < r ? ax[q * 9 + t] : 0.f;

  float acc[kRows][NC];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[t][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCS) {
    __syncthreads();  // the previous slice is no longer read
    for (int e = tid; e < 81 * kCS; e += kThreads) {
      const int row = e / kCS, c = e % kCS;
      const int a = row / 9, bb = row % 9;
      const int ky = a / 3, dy = a % 3, dx = bb / 3, kx = bb % 3;
      const int yi = min(max(i + dy - 1, 0), h - 1);
      const int xj = min(max(j + dx - 1, 0), w - 1);
      const size_t src =
          ((((size_t)b * h + yi) * w + xj) * 9 + ky * 3 + kx) * C + c0 + c;
      pp_s[row][c] = to_f32(P[src]);
    }
    for (int e = tid; e < kCS * NC; e += kThreads)
      wp_s[e / NC][e % NC] = to_f32(wp[(size_t)(c0 + e / NC) * NC + e % NC]);
    if (tid < kCS) {
      a1_s[tid] = a1[c0 + tid];
      c1_s[tid] = c1[c0 + tid];
    }
    __syncthreads();

    // y-pass: t_s[p][bb][c] = Σ_a Ay[p,a] · pp[a·9+bb][c]
    for (int e = tid; e < r * 9 * kCS; e += kThreads) {
      const int p = e / (9 * kCS), rem = e % (9 * kCS);
      const int bb = rem / kCS, c = rem % kCS;
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < 9; ++a) s += ay_s[p][a] * pp_s[a * 9 + bb][c];
      t_s[p][bb][c] = s;
    }
    __syncthreads();

    // x-pass, affine + ReLU, 1×1 accumulation
    if (q < r) {
#pragma unroll 1
      for (int c = 0; c < kCS; ++c) {
        const float sa = a1_s[c], sc = c1_s[c];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int p = wy + 8 * t;
          if (p < r) {
            float fine = 0.f;
#pragma unroll
            for (int bb = 0; bb < 9; ++bb) fine += axr[bb] * t_s[p][bb][c];
            const float hid = round_like(fmaxf(fine * sa + sc, 0.f), P);
#pragma unroll
            for (int k = 0; k < NC; ++k) acc[t][k] += hid * wp_s[c][k];
          }
        }
      }
    }
  }

  if (q < r) {
    const int H = h * r, W = w * r;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int p = wy + 8 * t;
      if (p < r) {
        T* o = out + (((size_t)b * H + i * r + p) * W + j * r + q) * NC;
#pragma unroll
        for (int k = 0; k < NC; ++k) store(o + k, acc[t][k] + bp[k]);
      }
    }
  }
}

template <typename T>
int launch_typed(const void* P, const float* ay, const float* ax,
                 const float* a1, const float* c1, const void* wp,
                 const float* bp, void* out, int B, int h, int w, int C, int r,
                 int nc, cudaStream_t stream) {
  if (r < 1 || r > kRMax || C % kCS != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(w, h, B);
  if (nc == 19) {
    seg_head_kernel<T, 19><<<grid, kThreads, 0, stream>>>(
        (const T*)P, ay, ax, a1, c1, (const T*)wp, bp, (T*)out, h, w, C, r);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_head_launch(const void* P, const void* ay, const void* ax,
                               const void* a1, const void* c1, const void* wp,
                               const void* bp, void* out, int B, int h, int w,
                               int C, int r, int nc, int is_bf16,
                               void* stream) {
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(
        P, (const float*)ay, (const float*)ax, (const float*)a1,
        (const float*)c1, wp, (const float*)bp, out, B, h, w, C, r, nc,
        (cudaStream_t)stream);
  return launch_typed<float>(P, (const float*)ay, (const float*)ax,
                             (const float*)a1, (const float*)c1, wp,
                             (const float*)bp, out, B, h, w, C, r, nc,
                             (cudaStream_t)stream);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
