// The bf16 tensor-core body ('mma_bf16') of the train heads' backward,
// shared by K8 (seg_head_train.cu: the seg head, with the 1×1) and K10
// (depth_stage1_train.cu: the depth head's stage 1, without it).
//
// Per coarse cell (b, i, j) it computes what the TPU kernels compute
// (awsegbench/ops/headkernels_train.py::_seg_train_bwd_kernel,
// depthkernels_train.py::_d1_bwd_kernel), with their roundings:
//   fine  = bf16(kron)·bf16(pp)                 (f32 sums; K7's fine_tile)
//   z     = fine·a1 + c1;  keep = the counter hash, regenerated
//   K8:  v = bf16(keep ? relu(z)/keep : 0);  dv = bf16(dy)·bf16(wp)ᵀ
//        du = keep ? dv/keep : 0
//   K10: du = keep ? dd1/keep : 0
//   dz    = [z > 0]·du;  da1 = Σ dz·fine;  dc1 = Σ dz;  dfine = bf16(dz·a1)
//   K8:  dwp = vᵀ·bf16(dy);  dbp = Σ dy
//   dpp   = bf16(kron)ᵀ·dfine, stored in bf16
// on mma.sync m16n8k16 (f32 accumulators). The kron table has r² rows and
// 81 columns padded to K = 96; a cell has r² fine pixels (1024 at r = 32).
//
// One ReLU decision: fine is formed exactly as the forward body forms it
// (seg_head_mma.cuh: the same fine_tile, A = the kron rows, B = pp, the same
// six k-steps in order), and z by the same affine(), so the backward's
// z > 0 and keep bits are K7's (K9's) own. The kron rows come from a
// [r², 96] bf16 table in device memory that holds bf16(Ay[p,a]·Ax[q,b]),
// the f32 product rounded once: the values K7 makes in registers.
//
// Block: 8 warps and one group of 128 channels of one coarse cell (a seg
// cell of 256 channels is two blocks), 2 blocks an SM (128 registers). A
// warp owns 16 channels and walks the cell's fine pixels 16 at a time. The
// cell's pp [96, 128] stays in shared memory; the block stages each step's
// 16 kron rows and dd1 (K10) tile by cp.async, double-buffered; K8's dy
// rows (nc bf16, 2-byte aligned) go through registers, loaded a step
// ahead, and feed dbp on the way. Per step a warp:
//   fine [16 px × 16 ch] = kron rows · pp (12 mma),
//   K8: dv [16 × 16] = dy tile · wpᵀ (wpᵀ's B fragments held in registers),
//   the element work in registers (z, keep, dz, da1, dc1, dfine, v),
//   dppᵀ [16 ch × 96] += dfineᵀ · kron rows (12 mma) and, K8, dwp [16 ch ×
//   8·NT] += vᵀ · dy tile: dfine and v leave the accumulators as packed
//   bf16 pairs, and movmatrix.trans turns each 8×8 block into the A
//   fragment of the transposed product.
// dppᵀ (48 f32), dwp, da1 and dc1 stay in the warp's registers for the
// whole cell; no sum crosses warps. Pixels past r² have zero kron rows and
// zero dy/dd1, so they add exactly zero. At the end the warp shuffles da1
// and dc1 across its rows (fixed order), and the block writes its part of
// the cell's partial row (da1 | dc1 | K8: dwp [C, nc] | dbp) and stages
// dpp through shared memory for 16-byte stores. The ordered reduce of the
// .cu file adds the cells' rows in block order: no float atomics.
//
// Bound on the H100 (B = 8, 512×1024): K8 at C = 256 runs about 530 GFLOP
// on the tensor cores (fine, dpp, dv and dwp; 0.54 ms at 989 TFLOP/s) and
// K7's hash on 1.07e9 elements (about 0.57 ms, its ALU-pipe floor); K10 at
// C = 128 reads dd1 (1.07 GB) and writes dpp (85 MB), 0.35 ms by bytes.
// Measured (PERF.md): K8 about 3.9 ms, K10 1.6 ms. A step's ldmatrix
// traffic (22 a warp, 11 KB) is the busiest pipe by count, then the
// mma.sync products and the hash. 4 warps a block and 32 pixels a step
// (two m-tiles) took K10 to 1.47 ms but K8 to 4.6 ms; 4 warps at 16
// pixels, to 1.5 and 4.2–4.5 ms; this shape is kept for both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_head_mma.cuh"

// Internal linkage, as seg_head_mma.cuh (two libraries include it).
namespace seg_bwd {
namespace {

using seg_mma::bf16;
using seg_mma::affine;
using seg_mma::fine_tile;
using seg_mma::image_seed;
using seg_mma::keeps;
using seg_mma::kK;
using attn_mma::cp_async16;
using attn_mma::ldsm_x4;
using attn_mma::ldsm_x4_t;
using attn_mma::mma;
using attn_mma::pack_bf16;
using attn_mma::unpack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;
constexpr int kGroup = 16 * kWarps;  // channels a block takes
constexpr int kTile = 16;            // fine pixels a step
constexpr int kRMax = 32;
constexpr int kNCMax = 32;
constexpr int kPad = 8;              // bf16 of padding per shared row
constexpr int kKS = kK + kPad;       // kron rows: 208 bytes apart
constexpr int kGS = kGroup + kPad;   // pp, dd1 and dpp rows: 272 bytes
constexpr int kYS = 32 + kPad;       // dy rows (classes padded to 32): 80

struct Params {
  const bf16* P;      // [B, h, w, 9, C]
  const bf16* kron;   // [r², 96] bf16(Ay[p, k/9]·Ax[q, k%9]), 0 past 81
  const float* a1;    // [C]
  const float* c1;    // [C]
  const bf16* wp;     // [C, nc] (K8)
  const bf16* g;      // K8: dy [B, h·r, w·r, nc]; K10: dd1 [B, h·r, w·r, C]
  const int* seed;    // [1]
  uint32_t thresh;    // drop iff mix32(idx ^ seed_b) < thresh
  float inv_keep;     // 1 / (1 − rate)
  bf16* dpp;          // [B, h, w, 81, C]
  float* part;        // [B·h·w, cols]: da1 | dc1 (| dwp [C, nc] | dbp)
  int h, w, C, r, nc;
};

// The transpose of an 8×8 bf16 block held one packed pair a thread (row
// lane/4, columns 2(lane%4), +1), in the same layout.
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// The A fragment of Xᵀ [16 ch × 16 px] from X [16 px × 16 ch] held as the
// packed accumulator pairs x[hf][nt] (rows 8hf + lane/4, channels 8nt + ..).
__device__ __forceinline__ void transposed_a(uint32_t (&a)[4],
                                             const uint32_t (&x)[2][2]) {
  a[0] = transpose8(x[0][0]);
  a[1] = transpose8(x[0][1]);
  a[2] = transpose8(x[1][0]);
  a[3] = transpose8(x[1][1]);
}

// kSeg: K8 (dy, wp, dwp, dbp, NT = ⌈nc/8⌉ n-tiles of classes); else K10
// (dd1). kDrop: the hash dropout is on.
template <bool kSeg, int NT, bool kDrop>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    seg_bwd_mma(const Params prm) {
  constexpr int kGW = kSeg ? kYS : kGS;  // the g tile's row stride
  constexpr int kKY = (NT + 1) / 2;      // k-steps of dv (classes / 16)
  __shared__ __align__(16) bf16 pp_s[kK][kGS];
  __shared__ __align__(16) bf16 kron_s[2][kTile][kKS];
  __shared__ __align__(16) bf16 g_s[2][kTile][kGW];

  const int C = prm.C, r = prm.r, rr = r * r, W = prm.w * r;
  const int groups = (C + kGroup - 1) / kGroup;
  const int j = blockIdx.x, i = blockIdx.y;
  const int b = blockIdx.z / groups, grp = blockIdx.z - b * groups;
  const int cg0 = grp * kGroup, nch = min(kGroup, C - cg0) / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int lc = 16 * warp, c0 = cg0 + lc;  // the warp's 16 channels
  const bool active = lc < 8 * nch;
  const size_t cell = ((size_t)b * prm.h + i) * prm.w + j;

  // the cell's neighbourhood, channels [cg0, cg0 + 8·nch), zero elsewhere
  for (int e = tid; e < kK * (kGroup / 8); e += kThreads) {
    const int row = e / (kGroup / 8), cc = e - row * (kGroup / 8);
    bf16* dst = &pp_s[row][cc * 8];
    if (row < 81 && cc < nch) {
      const int a = row / 9, bb = row - 9 * a;
      const int ky = a / 3, dy = a - 3 * ky, dx = bb / 3, kx = bb - 3 * dx;
      const int yi = min(max(i + dy - 1, 0), prm.h - 1);
      const int xj = min(max(j + dx - 1, 0), prm.w - 1);
      cp_async16(dst, prm.P + ((((size_t)b * prm.h + yi) * prm.w + xj) * 9 +
                               ky * 3 + kx) * C + cg0 + cc * 8,
                 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  attn_mma::cp_async_commit();

  // K8's dy rows (nc bf16 a pixel) are 2-byte aligned only, no cp.async
  // source: each thread loads its two elements of step t's tile into
  // registers (dyn) a step before they go to shared memory, so the loads
  // are in flight during a step's products. Classes past nc are zeros.
  constexpr int kDyPer = kSeg ? kTile * 32 / kThreads : 1;
  bf16 dyn[kDyPer];
  // dbp: this thread's class (lane) summed over its rows of every tile
  // (rows warp + 8u), the 8 warps' sums added in warp order at the end
  float dbp = 0.f;
  auto load_dy = [&](int t) {
#pragma unroll
    for (int u = 0; u < kDyPer; ++u) {
      const int e = tid + u * kThreads, row = e >> 5, k = e & 31;
      const int m = kTile * t + row, p = m / r, q = m - p * r;
      dyn[u] = m < rr && k < prm.nc
                   ? prm.g[(((size_t)b * prm.h * r + i * r + p) * W + j * r +
                            q) * prm.nc + k]
                   : __float2bfloat16(0.f);
    }
  };
  // step t's 16 kron rows and g tile into buffer buf (cp.async, committed;
  // K8: dy from dyn, then step t + 1's dy loads issued)
  auto stage = [&](int t, int buf) {
    for (int e = tid; e < kTile * (kK / 8); e += kThreads) {
      const int row = e / (kK / 8), cc = e - row * (kK / 8);
      const int m = kTile * t + row;
      cp_async16(&kron_s[buf][row][cc * 8],
                 prm.kron + (size_t)(m < rr ? m : 0) * kK + cc * 8,
                 m < rr ? 16 : 0);
    }
    if constexpr (kSeg) {
#pragma unroll
      for (int u = 0; u < kDyPer; ++u) {
        const int e = tid + u * kThreads;
        g_s[buf][e >> 5][e & 31] = dyn[u];
        dbp += __bfloat162float(dyn[u]);
      }
      load_dy(t + 1);
    } else {
      for (int e = tid; e < kTile * (kGroup / 8); e += kThreads) {
        const int row = e / (kGroup / 8), cc = e - row * (kGroup / 8);
        const int m = kTile * t + row, p = m / r, q = m - p * r;
        const bool ok = m < rr && cc < nch;
        cp_async16(&g_s[buf][row][cc * 8],
                   ok ? prm.g + (((size_t)b * prm.h * r + i * r + p) * W +
                                 j * r + q) * C + cg0 + cc * 8
                      : prm.g,
                   ok ? 16 : 0);
      }
    }
    attn_mma::cp_async_commit();
  };

  // the warp's channels: a1, c1 (pairs 8nt + 2tg, +1) and, K8, the B
  // fragments of wpᵀ (k = class, n = channel 8nt + gr) for dv
  float2 sa[2], sc[2];
  uint32_t wpb[kSeg ? kKY : 1][2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = active ? c0 + 8 * nt + 2 * tg : 0;
    sa[nt] = *reinterpret_cast<const float2*>(prm.a1 + c);
    sc[nt] = *reinterpret_cast<const float2*>(prm.c1 + c);
    if constexpr (kSeg) {
      const bf16* wr =
          prm.wp + (size_t)(active ? c0 + 8 * nt + gr : 0) * prm.nc;
      const bf16 z = __float2bfloat16(0.f);
#pragma unroll
      for (int ks = 0; ks < kKY; ++ks)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = 16 * ks + 8 * half + 2 * tg;
          const bf16 lo = k < prm.nc ? wr[k] : z;
          const bf16 hi = k + 1 < prm.nc ? wr[k + 1] : z;
          wpb[ks][nt][half] = (uint32_t)__bfloat16_as_ushort(lo) |
                              ((uint32_t)__bfloat16_as_ushort(hi) << 16);
        }
    }
  }
  uint32_t bseed = 0;
  if constexpr (kDrop) bseed = image_seed(prm.seed, b);

  float dppt[kK / 8][4];  // dppᵀ: channels (gr, gr + 8) × kron columns
  float dwp[NT][4];       // K8: channels × classes 8nt + 2tg, +1
  float da[2][2], dc[2][2];
#pragma unroll
  for (int n = 0; n < kK / 8; ++n)
    dppt[n][0] = dppt[n][1] = dppt[n][2] = dppt[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    dwp[n][0] = dwp[n][1] = dwp[n][2] = dwp[n][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
    da[nt][0] = da[nt][1] = dc[nt][0] = dc[nt][1] = 0.f;

  const int steps = (rr + kTile - 1) / kTile;
  if constexpr (kSeg) load_dy(0);
  stage(0, 0);
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) stage(t + 1, buf ^ 1);
    else attn_mma::cp_async_commit();  // keeps the group count
    attn_mma::cp_async_wait<1>();
    __syncthreads();

    if (active) {
      // fine [16 px × 16 ch], as the forward forms it
      uint32_t af[1][kK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks)
        ldsm_x4(af[0][ks], attn_mma::a_ptr(kron_s[buf], 0, 16 * ks, lane));
      float fine[1][2][4];
      fine_tile<1>(fine, af, &pp_s[0][0], kGS, lc, lane);

      // K8: dv [16 px × 16 ch] = dy tile · wpᵀ
      float dv[2][4];
      if constexpr (kSeg) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKY; ++ks) {
          uint32_t ya[4];
          ldsm_x4(ya, attn_mma::a_ptr(g_s[buf], 0, 16 * ks, lane));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma(dv[nt], ya, wpb[ks][nt][0], wpb[ks][nt][1]);
        }
      }

      uint32_t dfp[2][2], vp[2][2];  // packed dfine, v: [hf][nt]
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = gr + 8 * hf;
        const int m = kTile * t + row, p = m / r, q = m - p * r;
        const uint32_t base =
            ((uint32_t)(i * r + p) * (uint32_t)W + (uint32_t)(j * r + q)) *
            (uint32_t)C;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int lcol = lc + 8 * nt + 2 * tg;
          const uint32_t idx = base + (uint32_t)(cg0 + lcol);
          float2 g2;
          if constexpr (!kSeg)
            g2 = unpack_bf16(
                *reinterpret_cast<const uint32_t*>(&g_s[buf][row][lcol]));
          float df[2], v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float f = fine[0][nt][2 * hf + e];
            const float z = affine(f, e ? sa[nt].y : sa[nt].x,
                                   e ? sc[nt].y : sc[nt].x);
            const bool keep =
                kDrop ? keeps(idx + (uint32_t)e, bseed, prm.thresh) : true;
            float du;
            if constexpr (kSeg) {
              const float u = fmaxf(z, 0.f);
              v[e] = kDrop ? (keep ? u * prm.inv_keep : 0.f) : u;
              const float d = dv[nt][2 * hf + e];
              du = kDrop ? (keep ? d * prm.inv_keep : 0.f) : d;
            } else {
              const float d = e ? g2.y : g2.x;
              du = kDrop ? (keep ? d * prm.inv_keep : 0.f) : d;
            }
            const float dz = z > 0.f ? du : 0.f;
            da[nt][e] += dz * f;
            dc[nt][e] += dz;
            df[e] = dz * (e ? sa[nt].y : sa[nt].x);
          }
          dfp[hf][nt] = pack_bf16(df[0], df[1]);
          if constexpr (kSeg) vp[hf][nt] = pack_bf16(v[0], v[1]);
        }
      }

      // dppᵀ += dfineᵀ · kron rows: B = the kron tile, its rows the k axis
      uint32_t at[4];
      transposed_a(at, dfp);
#pragma unroll
      for (int jj = 0; jj < kK / 16; ++jj) {
        uint32_t kb[4];
        ldsm_x4_t(kb, attn_mma::a_ptr(kron_s[buf], 0, 16 * jj, lane));
        mma(dppt[2 * jj], at, kb[0], kb[1]);
        mma(dppt[2 * jj + 1], at, kb[2], kb[3]);
      }
      // K8: dwp += vᵀ · dy tile
      if constexpr (kSeg) {
        transposed_a(at, vp);
#pragma unroll
        for (int jj = 0; jj < kKY; ++jj) {
          uint32_t yb[4];
          ldsm_x4_t(yb, attn_mma::a_ptr(g_s[buf], 0, 16 * jj, lane));
          mma(dwp[2 * jj], at, yb[0], yb[1]);
          if (2 * jj + 1 < NT) mma(dwp[2 * jj + 1], at, yb[2], yb[3]);
        }
      }
    }
    __syncthreads();
  }

  // da1, dc1: the warp's rows summed across its 8 row lanes, in order
  const int cols = kSeg ? 2 * C + C * prm.nc + prm.nc : 2 * C;
  float* prow = prm.part + cell * cols;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        da[nt][e] += __shfl_xor_sync(0xffffffffu, da[nt][e], s);
        dc[nt][e] += __shfl_xor_sync(0xffffffffu, dc[nt][e], s);
      }
  if (active && gr == 0)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * nt + 2 * tg + e;
        prow[c] = da[nt][e];
        prow[C + c] = dc[nt][e];
      }
  if constexpr (kSeg) {
    if (active)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * n + 2 * tg + e;
            if (k < prm.nc)
              prow[2 * C + (size_t)(c0 + gr + 8 * hf) * prm.nc + k] =
                  dwp[n][2 * hf + e];
          }
  }

  // dpp through shared memory (pp_s is no longer read): [81][channels];
  // K8's dbp partial sums in the rows past 81
  if constexpr (kSeg) {
    float* dbp_s = reinterpret_cast<float*>(&pp_s[88][0]);  // [8][32]
    dbp_s[tid] = dbp;
  }
  if (active)
#pragma unroll
    for (int n = 0; n < kK / 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * n + 2 * tg + e;
          if (k < 81)
            pp_s[k][lc + gr + 8 * hf] =
                __float2bfloat16_rn(dppt[n][2 * hf + e]);
        }
  __syncthreads();
  if constexpr (kSeg)
    if (grp == 0 && warp == 0 && lane < prm.nc) {
      const float* dbp_s = reinterpret_cast<const float*>(&pp_s[88][0]);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) acc += dbp_s[k * 32 + lane];
      prow[2 * C + C * prm.nc + lane] = acc;
    }
  bf16* drow = prm.dpp + cell * 81 * C + cg0;
  for (int e = tid; e < 81 * nch; e += kThreads) {
    const int row = e / nch, cc = e - row * nch;
    *reinterpret_cast<uint4*>(drow + (size_t)row * C + cc * 8) =
        *reinterpret_cast<const uint4*>(&pp_s[row][cc * 8]);
  }
}

template <bool kSeg, int NT, bool kDrop>
cudaError_t launch_t(const Params& prm, int B, cudaStream_t stream) {
  const int groups = (prm.C + kGroup - 1) / kGroup;
  seg_bwd_mma<kSeg, NT, kDrop>
      <<<dim3(prm.w, prm.h, B * groups), kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

// Launches the body (no reduce) for 1 ≤ r ≤ 32, C % 16 == 0 and, K8,
// 1 ≤ nc ≤ 32; P, kron, dpp and (K10) dd1 must be 16-byte aligned.
template <bool kSeg>
cudaError_t launch(const Params& prm, int B, bool drop, cudaStream_t stream) {
  auto misaligned = [](const void* p) { return ((uintptr_t)p & 15) != 0; };
  if (prm.r < 1 || prm.r > kRMax || prm.C < 16 || prm.C % 16 != 0 ||
      misaligned(prm.P) || misaligned(prm.kron) || misaligned(prm.dpp) ||
      (!kSeg && misaligned(prm.g)) ||
      (kSeg && (prm.nc < 1 || prm.nc > kNCMax)))
    return cudaErrorInvalidValue;
  if constexpr (!kSeg) {
    return drop ? launch_t<false, 1, true>(prm, B, stream)
                : launch_t<false, 1, false>(prm, B, stream);
  } else {
#define SEG_BWD_CASE(nt)                                  \
  return drop ? launch_t<true, nt, true>(prm, B, stream)  \
              : launch_t<true, nt, false>(prm, B, stream);
    switch ((prm.nc + 7) / 8) {
      case 1: SEG_BWD_CASE(1)
      case 2: SEG_BWD_CASE(2)
      case 3: SEG_BWD_CASE(3)
      default: SEG_BWD_CASE(4)
    }
#undef SEG_BWD_CASE
  }
}

}  // namespace
}  // namespace seg_bwd
