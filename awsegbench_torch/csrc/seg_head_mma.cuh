// The bf16 tensor-core body ('mma_bf16') of the faithful heads' forward,
// shared by K2 (seg_head.cu, eval mode), K7 (seg_head_train.cu, train mode:
// batch-statistic affine and counter-hash dropout) and K9
// (depth_stage1_train.cu: K7 without the 1×1, storing the post-dropout
// hidden d1 in bf16; kHidden). Its fine_tile, affine and keeps are also
// the backward body's (seg_bwd_mma.cuh), so K8 and K10 recompute fine and
// take the ReLU and dropout decisions as K7 and K9 did.
//
// Per coarse cell (b, i, j) it computes what the TPU kernels compute
// (awsegbench/ops/headkernels.py::_seg_kernel, headkernels_train.py::
// _seg_train_fwd_kernel), as two products on mma.sync m16n8k16:
//   fine[r², C]    = bf16(kron(Ay, Ax))[r², 96] · pp[96, C]      (f32 sums)
//   u              = relu(fine·a1 + c1)   (K7: · 1/keep where the hash keeps,
//                                           0 where it drops)
//   logits[r², nc] = bf16(u) · wp[C, ncp] + bp, stored in bf16
// pp[(3ky+dy)·9 + 3dx+kx, c] = P[b, i+dy-1, j+dx-1, ky, kx, c] is the clamped
// 3×3 neighbourhood of the coarse partial products; its 81 rows are padded
// to K = 96 with zeros, and the class axis to ncp = 8·⌈nc/8⌉ with zero
// columns of wp (classes ≥ nc are not stored).
//
// Rounding is the TPU kernel's: the A operand is bf16(Ay[p,a]·Ax[q,b]), the
// f32 product of two table entries rounded once to bf16, which is how the
// TPU kernel rounds its f32 kron table, so both kernels multiply the same
// bf16 operands. The table is never stored: each thread makes its A
// fragments in registers from the two [r, 9] tables in shared memory, once
// per 32 rows, and they serve every channel slice.
//
// Block: one coarse cell, 4 warps, 3 blocks an SM (one block's gather
// overlaps the others' products). The cell's pp [96, C] is gathered by
// cp.async into shared memory (rows padded to C + 8 bf16, so the 8 rows an
// ldmatrix phase reads fall on distinct bank groups), with wpᵀ [ncp, C],
// a1 and c1. A warp takes 32 of the cell's r² rows at a time (two 16-row
// m-tiles, so each pp fragment loaded by ldmatrix feeds two mma) and walks
// C in 16-channel slices: 6 k-steps of the phase product give the slice's
// fine values in f32 accumulators; affine, ReLU and the dropout run on
// them in registers, and two neighbouring 8-channel accumulator tiles,
// packed to bf16, are the A fragment of the 1×1 (FlashAttention-2's trick,
// attention_mma.cuh). The logits accumulate in f32 over the slices. The
// full-resolution hidden never leaves the registers; pp is never written to
// device memory.
//
// Bound on the H100 at B = 8, 512×1024, C = 256, nc = 19 (24 padded):
// 2·4.19e6 pixels·(96·256 + 256·24) ≈ 258 GFLOP, 0.26 ms at 989 TFLOP/s;
// the output is 159 MB (0.048 ms). K7's hash costs about 8.8 ALU-pipe and
// 2.3 IMAD instructions per hidden element (1.07e9; scripts/seg_head_sass.py
// counts them), its own floor on the ALU pipe (about 0.57 ms). Measured on an H100 (PERF.md): about 1.0 ms
// for K2 and 1.6 ms for K7. Two blocks of 8 warps, one block, two
// independent 16-channel slices a step (8 product chains a warp) and logits
// staged through shared memory for coalesced stores each moved K2 by 5% or
// less, and the bodies do not spill: wgmma, with pp as its shared-memory
// operand, is the next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

// Everything below has internal linkage (the unnamed namespace): seg_head.cu
// and seg_head_train.cu are loaded into one process as two libraries, and a
// function-local static of a template with external linkage is one object
// per process (a unique symbol), so the libraries would share launch_nt's
// record of the shared memory granted to their separate kernels.
namespace seg_mma {
namespace {

using attn_mma::bf16;
using attn_mma::cp_async16;
using attn_mma::ldsm_x4_t;
using attn_mma::mma;
using attn_mma::pack_bf16;

// 4 warps a block, 3 blocks an SM: 170 registers a thread (65,536 / 384),
// which K2's body at 19 classes fits without spilling (168).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;
constexpr int kRMax = 32;      // largest upsample factor
constexpr int kK = 96;         // the 81 kron columns, padded to 6 k-steps
constexpr int kPad = 8;        // bf16 of padding per shared row
constexpr int kNCMax = 32;     // largest class count (4 n-tiles)

// lowbias32 in uint32 (wrap-around multiplies, logical shifts).
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

struct Params {
  const bf16* P;     // [B, h, w, 9, C]
  const float* ay;   // [r, 9], columns 3ky+dy
  const float* ax;   // [r, 9], columns 3dx+kx
  const float* a1;   // [C]
  const float* c1;   // [C]
  const bf16* wp;    // [C, nc]
  const float* bp;   // [nc]
  const int* seed;   // [1] (K7's dropout), or null
  uint32_t thresh;   // drop iff mix32(idx ^ seed_b) < thresh
  float inv_keep;    // 1 / (1 − rate)
  bf16* out;         // [B, h·r, w·r, nc]
  int h, w, C, r, nc;
};

// Dynamic shared memory: a1, c1 (f32), then pp [96][C + kPad] and wpᵀ
// [8·NT][C + kPad] (bf16).
inline size_t smem_bytes(int C, int nt) {
  return (size_t)2 * C * sizeof(float) +
         (size_t)(kK + 8 * nt) * (C + kPad) * sizeof(bf16);
}

// Column k of the kron table's row (p, q), before the caller's rounding to
// bf16: Ay[p, k / 9]·Ax[q, k % 9] in f32 (ayp = Ay[p], axq = Ax[q]), 0 in
// the padding columns.
__device__ __forceinline__ float kron(const float* ayp, const float* axq,
                                      int k) {
  return k < 81 ? ayp[k / 9] * axq[k % 9] : 0.f;
}

// z = fine·a + c, the batch-stat (or eval) affine, as every bf16 body forms
// it: K7's ReLU and K8's/K10's z > 0 decide on this one expression.
__device__ __forceinline__ float affine(float fine, float a, float c) {
  return fine * a + c;
}

// The counter hash's keep bit of hidden element idx (K7, K8, K9, K10).
__device__ __forceinline__ bool keeps(uint32_t idx, uint32_t bseed,
                                      uint32_t thresh) {
  return mix32(idx ^ bseed) >= thresh;
}

// The phase product of one 16-channel slice: fine[mt][nt] = the kron rows
// of m-tile mt (A fragments af) · pp[:, c0 + 8nt ..], pp's B fragments read
// from shared memory ([kK][stride] bf16) by ldmatrix, the six k-steps in
// order. K7, K9 and the backward body (seg_bwd_mma.cuh) all form fine
// here, so with the same A fragments they get the same f32 sums.
template <int MT>
__device__ __forceinline__ void fine_tile(float (&fine)[MT][2][4],
                                          const uint32_t (&af)[MT][kK / 16][4],
                                          const bf16* pp_s, int stride,
                                          int c0, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      fine[mt][nt][0] = fine[mt][nt][1] = fine[mt][nt][2] = fine[mt][nt][3] =
          0.f;
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks) {
    uint32_t bfr[4];  // pp rows 16ks.., channels c0..c0+7 and +8..+15
    ldsm_x4_t(bfr, pp_s + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              stride + c0 + (lane >> 4) * 8);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma(fine[mt][0], af[mt][ks], bfr[0], bfr[1]);
      mma(fine[mt][1], af[mt][ks], bfr[2], bfr[3]);
    }
  }
}

// kHidden (K9): no 1×1; the post-dropout hidden is stored in bf16 into
// out [B, h·r, w·r, C] instead of the logits (NT is then unused).
template <int NT, bool kDrop, bool kHidden = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks) seg_head_mma(const Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ay_s[kRMax][9], ax_s[kRMax][9];
  const int C = prm.C, r = prm.r, stride = C + kPad;
  float* a1_s = reinterpret_cast<float*>(smem);
  float* c1_s = a1_s + C;
  bf16* pp_s = reinterpret_cast<bf16*>(c1_s + C);  // [kK][stride]
  bf16* wp_s = pp_s + kK * stride;                  // [8·NT][stride]: wpᵀ

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;

  // the cell's neighbourhood, 16 bytes (8 channels) per copy
  const int chunks = C / 8;
  for (int e = tid; e < 81 * chunks; e += kThreads) {
    const int row = e / chunks, cc = e - row * chunks;
    const int a = row / 9, bb = row - 9 * a;
    const int ky = a / 3, dy = a - 3 * ky, dx = bb / 3, kx = bb - 3 * dx;
    const int yi = min(max(i + dy - 1, 0), prm.h - 1);
    const int xj = min(max(j + dx - 1, 0), prm.w - 1);
    cp_async16(pp_s + row * stride + cc * 8,
               prm.P + ((((size_t)b * prm.h + yi) * prm.w + xj) * 9 +
                        ky * 3 + kx) * C + cc * 8,
               16);
  }
  attn_mma::cp_async_commit();
  for (int e = tid; e < (kK - 81) * chunks; e += kThreads) {
    const int row = 81 + e / chunks, cc = e % chunks;
    *reinterpret_cast<uint4*>(pp_s + row * stride + cc * 8) =
        make_uint4(0, 0, 0, 0);
  }
  if constexpr (!kHidden)
    for (int e = tid; e < 8 * NT * C; e += kThreads) {
      const int n = e / C, k = e - n * C;
      wp_s[n * stride + k] =
          n < prm.nc ? prm.wp[(size_t)k * prm.nc + n] : __float2bfloat16(0.f);
    }
  for (int e = tid; e < C; e += kThreads) {
    a1_s[e] = prm.a1[e];
    c1_s[e] = prm.c1[e];
  }
  for (int e = tid; e < r * 9; e += kThreads) {
    ay_s[e / 9][e % 9] = prm.ay[e];
    ax_s[e / 9][e % 9] = prm.ax[e];
  }
  uint32_t bseed = 0;
  if constexpr (kDrop) bseed = image_seed(prm.seed, b);
  attn_mma::cp_async_wait<0>();
  __syncthreads();

  const int rr = r * r;
  const int W = prm.w * r;
  // (K9) image b's first element of d1; base[][] + c is the rest
  [[maybe_unused]] const size_t img = (size_t)b * prm.h * r * W * C;

#pragma unroll 1
  for (int m0 = 32 * warp; m0 < rr; m0 += 32 * (kThreads / 32)) {
    // A fragments of the kron table for rows m0 + 16mt + gr + 8hf, and
    // (K7) the hash index of each row's channel 0
    uint32_t af[2][kK / 16][4];
    uint32_t base[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + 16 * mt + gr + 8 * hf;
        const bool ok = m < rr;
        const int p = ok ? m / r : 0, q = ok ? m - (m / r) * r : 0;
        base[mt][hf] = ((uint32_t)(i * r + p) * (uint32_t)W +
                        (uint32_t)(j * r + q)) * (uint32_t)C;
#pragma unroll
        for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int k = 16 * ks + 8 * half + 2 * tg;
            af[mt][ks][hf + 2 * half] =
                ok ? pack_bf16(kron(ay_s[p], ax_s[q], k),
                               kron(ay_s[p], ax_s[q], k + 1))
                   : 0u;
          }
      }

    float lg[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        lg[mt][nt][0] = lg[mt][nt][1] = lg[mt][nt][2] = lg[mt][nt][3] = 0.f;

#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += 16) {
      float fine[2][2][4];
      fine_tile<2>(fine, af, pp_s, stride, c0, lane);

      // affine, ReLU, dropout; packed to bf16 they are the 1×1's A
      uint32_t ha[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = c0 + 8 * nt + 2 * tg;
        const float2 sa = *reinterpret_cast<const float2*>(a1_s + c);
        const float2 sc = *reinterpret_cast<const float2*>(c1_s + c);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float u0 = fmaxf(affine(fine[mt][nt][2 * hf], sa.x, sc.x), 0.f);
            float u1 = fmaxf(affine(fine[mt][nt][2 * hf + 1], sa.y, sc.y),
                             0.f);
            const uint32_t idx = base[mt][hf] + (uint32_t)c;
            if constexpr (kDrop) {
              u0 = keeps(idx, bseed, prm.thresh) ? u0 * prm.inv_keep : 0.f;
              u1 = keeps(idx + 1u, bseed, prm.thresh) ? u1 * prm.inv_keep
                                                      : 0.f;
            }
            ha[mt][hf + 2 * nt] = pack_bf16(u0, u1);
            if constexpr (kHidden) {  // K9: d1 at the pixel's channel c
              if (m0 + 16 * mt + gr + 8 * hf < rr)
                *reinterpret_cast<uint32_t*>(prm.out + img + idx) =
                    ha[mt][hf + 2 * nt];
            }
          }
      }

      if constexpr (kHidden) continue;
      // the 1×1: B fragments of wp rows c0.., read from wpᵀ
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* wr = wp_s + (8 * nt + gr) * stride + c0 + 2 * tg;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(lg[mt][nt], ha[mt], b0, b1);
      }
    }

    if constexpr (kHidden) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + 16 * mt + gr + 8 * hf;
        if (m >= rr) continue;
        const int p = m / r, q = m - p * r;
        bf16* o = prm.out + (((size_t)b * prm.h * r + i * r + p) * W +
                             j * r + q) * prm.nc;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * nt + 2 * tg + e;
            if (k < prm.nc)
              o[k] = __float2bfloat16_rn(lg[mt][nt][2 * hf + e] + prm.bp[k]);
          }
      }
  }
}

template <int NT, bool kDrop, bool kHidden = false>
cudaError_t launch_nt(const Params& prm, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(prm.C, kHidden ? 0 : NT);
  // Above 48 KB a kernel must ask for its shared memory; asked once per
  // instantiation, not on every launch.
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        seg_head_mma<NT, kDrop, kHidden>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  seg_head_mma<NT, kDrop, kHidden>
      <<<dim3(prm.w, prm.h, B), kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// Launches the body for 1 ≤ nc ≤ 32 (NT = ⌈nc/8⌉ n-tiles of classes),
// 1 ≤ r ≤ 32 and C % 16 == 0; P must be 16-byte aligned.
template <bool kDrop>
cudaError_t launch(const Params& prm, int B, cudaStream_t stream) {
  if (prm.r < 1 || prm.r > kRMax || prm.C % 16 != 0 || prm.nc < 1 ||
      prm.nc > kNCMax || ((uintptr_t)prm.P & 15) != 0)
    return cudaErrorInvalidValue;
  switch ((prm.nc + 7) / 8) {
    case 1: return launch_nt<1, kDrop>(prm, B, stream);
    case 2: return launch_nt<2, kDrop>(prm, B, stream);
    case 3: return launch_nt<3, kDrop>(prm, B, stream);
    default: return launch_nt<4, kDrop>(prm, B, stream);
  }
}

// K9's body: the hidden into out [B, h·r, w·r, C] (wp, bp, nc unused), for
// 1 ≤ r ≤ 32 and C % 16 == 0; P and out must be 16-byte aligned.
template <bool kDrop>
cudaError_t launch_hidden(const Params& prm, int B, cudaStream_t stream) {
  if (prm.r < 1 || prm.r > kRMax || prm.C % 16 != 0 ||
      ((uintptr_t)prm.P & 15) != 0 || ((uintptr_t)prm.out & 15) != 0)
    return cudaErrorInvalidValue;
  return launch_nt<1, kDrop, true>(prm, B, stream);
}

}  // namespace
}  // namespace seg_mma
