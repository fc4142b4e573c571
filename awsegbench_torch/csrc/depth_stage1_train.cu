// Fused faithful depth head, stage 1, train mode: forward (K9) and backward
// (K10) of the core
//   fine[p,q,c] = Σ_b Ax[q,b] · Σ_a Ay[p,a] · pp[a·9+b, c]   (upsample∘conv3×3)
//   z = fine·a1[c] + c1[c]                 (BN with batch statistics, folded)
//   d1 = keep(y,x,c) ? relu(z)·(1/keep) : 0  (counter-hash dropout)
// per coarse cell, where pp[(3ky+dy)·9 + 3dx+kx, c] = P[b, i+dy-1, j+dx-1,
// ky, kx, c] are the clamped 3×3 neighbourhood's coarse partial products
// P = f·W1. It is the train seg head's core (seg_head_train.cu) without
// the 1×1: the forward writes the post-dropout hidden d1 [B, H, W, C], and
// conv2 runs on it as a library convolution.
//
// Replaces the TPU kernels awsegbench/ops/depthkernels_train.py::
// _d1_fwd_kernel and ::_d1_bwd_kernel (pallas_calls in _core_fwd_impl and
// _core_bwd_impl).
//
// The dropout mask is the seg head's: keep iff mix32(idx ^ seed_b) >=
// round(rate·2³²), idx = (y·W + x)·C + c per image, seed_b = seed ^
// mix32(b·0x7FEB352D), mix32 the lowbias32 mixer in uint32 (wrap-around
// multiplies, logical shifts). The backward regenerates it; nothing is
// stored.
//
// Two designs each, chosen by the dtype (ops/depthkernels_train.py), as
// the seg head's:
// - 'mma_bf16': K9 is the seg head's forward body (seg_head_mma.cuh) with
//   its hidden epilogue: one mma.sync GEMM against the bf16 kron table (the
//   TPU kernel's own operands), the affine, ReLU and hash dropout in
//   registers, d1 stored in bf16 where K7 applies its 1×1. K10 is the seg
//   head's backward body (seg_bwd_mma.cuh) without the 1×1: it recomputes
//   fine with the forward's own fine_tile, so the ReLU and the mask decide
//   as K9 did, and runs the phase transpose dpp = kronᵀ·bf16(dfine) on the
//   tensor cores, 16 channels a warp.
// - 'simt_f32': the exact two 9-tap passes on the CUDA cores.
//   Forward (d1_fwd): one block per coarse cell. The block walks C in
//   32-channel slices: it gathers the cell's pp slice, runs the y-pass into
//   shared memory with [r, 9] tables, then each warp takes every 8th fine
//   column q (its Ax rows in registers) and each lane one channel, so a
//   warp stores 32 neighbouring channels of one pixel.
//   Backward (d1_bwd): one block per coarse cell, one thread per channel
//   (128 on the main path). A thread recomputes its channel's r×r fine
//   values and mask and accumulates in registers everything that sums over
//   the cell's pixels: da1 = Σ dz·fine, dc1 = Σ dz and the phase-table
//   transpose dpp[:, c] (81 values), where dz = [z > 0]·mask·dd1. The block
//   stages one fine row of dd1 (r pixels × 128 channels) at a time in
//   shared memory, read with neighbouring threads on neighbouring channels.
// The TPU kernel added da1/dc1 into one block that its in-order grid
// revisited; here each block writes its partial row and d1_reduce adds the
// rows in block order (deterministic, no float atomics). dpp [B, h, w, 81,
// C] goes to device memory; pp_adjoint.cu scatters it back to P.
//
// Rounding follows the TPU kernels: bf16 mode reads P and dd1 as bf16,
// multiplies the bf16 kron table, and stores d1 and dpp as bf16, with f32
// sums between; dfine = dz·a1 is rounded to bf16 before the transpose.
//
// Bound on the H100 (B = 8, 512×1024, C = 128): the forward writes d1,
// 1.07 GB in bf16 (0.32 ms at 3.35 TB/s) for about 12 GFLOP of phase passes
// (103 GFLOP as the kron GEMM); the backward reads dd1 (1.07 GB) and writes
// dpp (85 MB), about 0.35 ms. Both are bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_bwd_mma.cuh"
#include "seg_head_mma.cuh"

namespace {

constexpr int kThreads = 256;  // forward: 8 warps
constexpr int kCS = 32;        // channels per slice (forward): a warp's lanes
constexpr int kRMax = 32;      // largest upsample factor
constexpr int kQ = kRMax / 8;  // fine columns per warp (forward)
constexpr int kCB = 128;       // channels per group (backward: one per thread)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// seed[0] ^ mix32((b0 + b) · M1): image b's stream of the counter hash,
// where b0 = seed[1] is the global index of the batch's first row (0 on
// one device; rank · local batch on a data-parallel rank).
__device__ __forceinline__ uint32_t image_seed(const int* seed, int b) {
  return (uint32_t)seed[0] ^ mix32((uint32_t)(seed[1] + b) * 0x7FEB352Du);
}

__device__ __forceinline__ bool keep_bit(uint32_t bseed, int y, int x, int c,
                                         int W, int C, uint32_t thresh) {
  const uint32_t idx = (uint32_t)((y * W + x) * C + c);
  return mix32(idx ^ bseed) >= thresh;
}

// Gathers the 81 neighbourhood rows of channels [c0, c0 + width) of coarse
// cell (b, i, j) into dst[row · width + cc], zero past C.
template <typename T>
__device__ __forceinline__ void gather_pp(const T* __restrict__ P, float* dst,
                                          int b, int i, int j, int h, int w,
                                          int C, int c0, int width,
                                          int nthreads) {
  for (int e = threadIdx.x; e < 81 * width; e += nthreads) {
    const int row = e / width, cc = e % width;
    const int a = row / 9, bb = row % 9;
    const int ky = a / 3, dy = a % 3, dx = bb / 3, kx = bb % 3;
    const int yi = min(max(i + dy - 1, 0), h - 1);
    const int xj = min(max(j + dx - 1, 0), w - 1);
    dst[e] = c0 + cc < C
                 ? to_f32(P[((((size_t)b * h + yi) * w + xj) * 9 + ky * 3 +
                             kx) * C + c0 + cc])
                 : 0.f;
  }
}

// ---------------------------------------------------------------- K9

template <typename T>
__global__ void __launch_bounds__(kThreads)
    d1_fwd(const T* __restrict__ P, const float* __restrict__ ay,
           const float* __restrict__ ax, const float* __restrict__ a1,
           const float* __restrict__ c1, const int* __restrict__ seed,
           uint32_t thresh, float inv_keep, int drop, T* __restrict__ out,
           int h, int w, int C, int r) {
  __shared__ float pp_s[81 * kCS];
  __shared__ float t_s[kRMax][9][kCS];
  __shared__ float ay_s[kRMax][9];

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = h * r, W = w * r;
  const uint32_t bseed = image_seed(seed, b);

  for (int e = tid; e < r * 9; e += kThreads) ay_s[e / 9][e % 9] = ay[e];
  float axr[kQ][9];  // Ax rows of this warp's fine columns q = warp + 8k
#pragma unroll
  for (int k = 0; k < kQ; ++k)
#pragma unroll
    for (int t = 0; t < 9; ++t)
      axr[k][t] = warp + 8 * k < r ? ax[(warp + 8 * k) * 9 + t] : 0.f;

  for (int c0 = 0; c0 < C; c0 += kCS) {
    __syncthreads();  // the previous slice is no longer read
    gather_pp(P, pp_s, b, i, j, h, w, C, c0, kCS, kThreads);
    __syncthreads();

    // y-pass: t_s[p][bb][c] = Σ_a Ay[p,a] · pp[a·9+bb][c]
    for (int e = tid; e < r * 9 * kCS; e += kThreads) {
      const int p = e / (9 * kCS), rem = e % (9 * kCS);
      const int bb = rem / kCS, c = rem % kCS;
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < 9; ++a) s += ay_s[p][a] * pp_s[(a * 9 + bb) * kCS + c];
      t_s[p][bb][c] = s;
    }
    __syncthreads();

    // x-pass, affine + ReLU, dropout, store
    const int c = c0 + lane;
    if (c < C) {
      const float sa = a1[c], sc = c1[c];
#pragma unroll 1
      for (int p = 0; p < r; ++p) {
        float tp[9];
#pragma unroll
        for (int bb = 0; bb < 9; ++bb) tp[bb] = t_s[p][bb][lane];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const int q = warp + 8 * k;
          if (q < r) {
            float fine = 0.f;
#pragma unroll
            for (int bb = 0; bb < 9; ++bb) fine += axr[k][bb] * tp[bb];
            float u = fmaxf(fine * sa + sc, 0.f);
            if (drop)
              u = keep_bit(bseed, i * r + p, j * r + q, c, W, C, thresh)
                      ? u * inv_keep
                      : 0.f;
            store(out + (((size_t)b * H + i * r + p) * W + j * r + q) * C + c,
                  u);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- K10

// Dynamic shared memory: pp [81][kCB] then one dd1 row [r][kCB], f32.
template <typename T>
__global__ void __launch_bounds__(kCB)
    d1_bwd(const T* __restrict__ P, const float* __restrict__ ay,
           const float* __restrict__ ax, const float* __restrict__ a1,
           const float* __restrict__ c1, const T* __restrict__ dd1,
           const int* __restrict__ seed, uint32_t thresh, float inv_keep,
           int drop, T* __restrict__ dpp, float* __restrict__ part, int h,
           int w, int C, int r) {
  extern __shared__ float smem[];
  float* pp_s = smem;             // [81][kCB]
  float* dd_s = smem + 81 * kCB;  // [r][kCB]
  __shared__ float ay_s[kRMax][9], ax_s[kRMax][9];

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = h * r, W = w * r;
  const uint32_t bseed = image_seed(seed, b);
  const size_t blk = ((size_t)b * h + i) * w + j;
  float* prow = part + blk * 2 * C;

  for (int e = tid; e < r * 9; e += kCB) {
    ay_s[e / 9][e % 9] = ay[e];
    ax_s[e / 9][e % 9] = ax[e];
  }

  for (int c0 = 0; c0 < C; c0 += kCB) {
    __syncthreads();  // the previous group's pp is no longer read
    gather_pp(P, pp_s, b, i, j, h, w, C, c0, kCB, kCB);
    const int c = c0 + tid;
    const bool active = c < C;
    const float sa = active ? a1[c] : 0.f, sc = active ? c1[c] : 0.f;
    float dacc[81];
#pragma unroll
    for (int e = 0; e < 81; ++e) dacc[e] = 0.f;
    float da = 0.f, dc = 0.f;

#pragma unroll 1
    for (int p = 0; p < r; ++p) {
      __syncthreads();  // pp is gathered; the previous dd1 row is consumed
      const T* drow = dd1 + (((size_t)b * H + i * r + p) * W + j * r) * C + c0;
#pragma unroll 4
      for (int e = tid; e < r * kCB; e += kCB) {
        const int q = e / kCB, cc = e % kCB;
        dd_s[e] = c0 + cc < C ? to_f32(drow[(size_t)q * C + cc]) : 0.f;
      }
      __syncthreads();
      if (!active) continue;

      float t[9], tq[9];
#pragma unroll
      for (int bb = 0; bb < 9; ++bb) {
        float s = 0.f;
#pragma unroll
        for (int a = 0; a < 9; ++a) s += ay_s[p][a] * pp_s[(a * 9 + bb) * kCB + tid];
        t[bb] = s;
        tq[bb] = 0.f;
      }
#pragma unroll 2
      for (int q = 0; q < r; ++q) {
        float fine = 0.f;
#pragma unroll
        for (int bb = 0; bb < 9; ++bb) fine += ax_s[q][bb] * t[bb];
        const float z = fine * sa + sc;
        float du = dd_s[q * kCB + tid];
        if (drop)
          du = keep_bit(bseed, i * r + p, j * r + q, c, W, C, thresh)
                   ? du * inv_keep
                   : 0.f;
        const float dz = z > 0.f ? du : 0.f;
        da += dz * fine;
        dc += dz;
        const float df = round_like(dz * sa, P);
#pragma unroll
        for (int bb = 0; bb < 9; ++bb) tq[bb] += ax_s[q][bb] * df;
      }
#pragma unroll
      for (int a = 0; a < 9; ++a)
#pragma unroll
        for (int bb = 0; bb < 9; ++bb) dacc[a * 9 + bb] += ay_s[p][a] * tq[bb];
    }

    if (active) {
      T* drow = dpp + blk * 81 * C + c;
#pragma unroll
      for (int e = 0; e < 81; ++e) store(drow + (size_t)e * C, dacc[e]);
      prow[c] = da;
      prow[C + c] = dc;
    }
  }
}

// out[x] = Σ_row part[row][x], rows in order: a block takes 32 columns, its
// 8 warps take every 8th row, and the 8 warp sums add in warp order.
__global__ void __launch_bounds__(256)
    d1_reduce(const float* __restrict__ part, float* __restrict__ out,
              int rows, int cols) {
  __shared__ float s[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols)
    for (int row = warp; row < rows; row += 8)
      acc += part[(size_t)row * cols + col];
  s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += s[k][lane];
    out[col] = t;
  }
}

size_t bwd_smem(int r) { return (size_t)(81 + r) * kCB * sizeof(float); }

template <typename T>
int fwd_typed(const void* P, const float* ay, const float* ax, const float* a1,
              const float* c1, const int* seed, uint32_t thresh,
              float inv_keep, int drop, void* out, int B, int h, int w, int C,
              int r, cudaStream_t stream) {
  d1_fwd<T><<<dim3(w, h, B), kThreads, 0, stream>>>(
      (const T*)P, ay, ax, a1, c1, seed, thresh, inv_keep, drop, (T*)out, h,
      w, C, r);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_typed(const void* P, const float* ay, const float* ax, const float* a1,
              const float* c1, const void* dd1, const int* seed,
              uint32_t thresh, float inv_keep, int drop, void* dpp,
              float* part, float* sums, int B, int h, int w, int C, int r,
              cudaStream_t stream) {
  const size_t smem = bwd_smem(r);
  int rc = (int)cudaFuncSetAttribute(
      d1_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  d1_bwd<T><<<dim3(w, h, B), kCB, smem, stream>>>(
      (const T*)P, ay, ax, a1, c1, (const T*)dd1, seed, thresh, inv_keep,
      drop, (T*)dpp, part, h, w, C, r);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  d1_reduce<<<(2 * C + 31) / 32, 256, 0, stream>>>(part, sums, B * h * w,
                                                   2 * C);
  return (int)cudaGetLastError();
}

bool shapes_ok(int r, int C) { return r >= 1 && r <= kRMax && C >= 1; }

}  // namespace

// Forward: P [B, h, w, 9, C] in f32 or bf16; ay, ax [r, 9], a1, c1 [C] f32;
// seed int32 [1] on the device; out d1 [B, h·r, w·r, C] in P's dtype. bf16
// needs C % 16 == 0 and 16-byte aligned P and out.
extern "C" int d1_fwd_launch(const void* P, const void* ay, const void* ax,
                             const void* a1, const void* c1, const void* seed,
                             unsigned thresh, float inv_keep, int drop,
                             void* out, int B, int h, int w, int C, int r,
                             int is_bf16, void* stream) {
  if (!shapes_ok(r, C)) return (int)cudaErrorInvalidValue;
  const float *fay = (const float*)ay, *fax = (const float*)ax;
  const float *fa1 = (const float*)a1, *fc1 = (const float*)c1;
  if (is_bf16) {
    const seg_mma::Params prm{
        (const seg_mma::bf16*)P, fay, fax, fa1, fc1, nullptr, nullptr,
        (const int*)seed, thresh, inv_keep, (seg_mma::bf16*)out, h, w, C, r,
        0};
    const cudaStream_t s = (cudaStream_t)stream;
    return (int)(drop ? seg_mma::launch_hidden<true>(prm, B, s)
                      : seg_mma::launch_hidden<false>(prm, B, s));
  }
  return fwd_typed<float>(P, fay, fax, fa1, fc1, (const int*)seed, thresh,
                          inv_keep, drop, out, B, h, w, C, r,
                          (cudaStream_t)stream);
}

// Backward: + dd1 [B, h·r, w·r, C] in P's dtype; writes dpp [B, h, w, 81, C]
// in P's dtype and sums [2C] f32 = (da1 | dc1); part is f32 scratch
// [B·h·w, 2C]. bf16 also takes kron, the [r², 96] bf16 kron table (unused
// in f32), and needs C % 16 == 0 and 16-byte aligned P, dd1, dpp, kron.
extern "C" int d1_bwd_launch(const void* P, const void* ay, const void* ax,
                             const void* a1, const void* c1, const void* dd1,
                             const void* seed, unsigned thresh,
                             float inv_keep, int drop, void* dpp, void* part,
                             void* sums, const void* kron, int B, int h,
                             int w, int C, int r, int is_bf16, void* stream) {
  if (!shapes_ok(r, C)) return (int)cudaErrorInvalidValue;
  const float *fay = (const float*)ay, *fax = (const float*)ax;
  const float *fa1 = (const float*)a1, *fc1 = (const float*)c1;
  if (is_bf16) {
    const seg_bwd::Params prm{
        (const seg_mma::bf16*)P, (const seg_mma::bf16*)kron, fa1, fc1,
        nullptr, (const seg_mma::bf16*)dd1, (const int*)seed, thresh,
        inv_keep, (seg_mma::bf16*)dpp, (float*)part, h, w, C, r, 0};
    int rc = (int)seg_bwd::launch<false>(prm, B, drop != 0,
                                         (cudaStream_t)stream);
    if (rc) return rc;
    d1_reduce<<<(2 * C + 31) / 32, 256, 0, (cudaStream_t)stream>>>(
        (const float*)part, (float*)sums, B * h * w, 2 * C);
    return (int)cudaGetLastError();
  }
  return bwd_typed<float>(P, fay, fax, fa1, fc1, dd1, (const int*)seed, thresh,
                          inv_keep, drop, dpp, (float*)part, (float*)sums, B,
                          h, w, C, r, (cudaStream_t)stream);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
