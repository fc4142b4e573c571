// Building blocks of the bf16 tensor-core attention kernels
// (sr_attention.cu, sr_attention_bwd.cu): mma.sync m16n8k16 with f32
// accumulators, ldmatrix fragment loads, cp.async copies of 64-row tiles
// into padded shared memory, and the base-2 exponential.
//
// Fragment layouts of mma.m16n8k16 for bf16 (PTX ISA), lane = 4·gr + tg:
//   A (16×16, row-major), 4 regs of bf16x2:
//     a0 (row gr, cols 2tg, 2tg+1)   a1 (row gr+8, cols 2tg, 2tg+1)
//     a2 (row gr, cols 8+2tg, +1)    a3 (row gr+8, cols 8+2tg, +1)
//   B (16×8, k × n), 2 regs: b0 (k 2tg, 2tg+1; n gr), b1 (k 8+2tg, +1; n gr)
//   C (16×8, f32), 4 floats: c0, c1 (row gr, cols 2tg, 2tg+1),
//                            c2, c3 (row gr+8, same cols)
// Two neighbouring C tiles (cols 0–7 and 8–15), rounded to bf16 and packed
// in pairs, are exactly the A fragment of that 16×16 block: scores turn
// into the next product's operand in registers (FlashAttention-2's trick).
//
// Shared tiles are [64][D + kPad] bf16. The 8 rows one ldmatrix phase reads
// are 80 (D = 32) or 144 (D = 64) bytes apart, which puts their 16-byte
// pieces on 8 distinct bank groups: no bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // rows of a shared tile (queries or keys)
constexpr int kPad = 8;       // bf16 of padding per shared row
constexpr int kThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr int kStages = 3;    // depth of the cp.async ring

template <int D, int R = kRows>
using Tile = bf16[R][D + kPad];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared; bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a·b on the tensor cores (16×16 bf16 · 16×8 bf16 → 16×8 f32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// The two bf16 of a packed pair as floats (low half first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

// 2^x on the special-function unit (one MUFU.EX2); 2^−∞ = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Where lane `lane` points ldmatrix for the 16×16 block at (row0, col0) of
// a tile. a_ptr: the four 8×8 matrices in the order (rows +0, cols +0),
// (+8, +0), (+0, +8), (+8, +8): plain, the A fragment of a row-major block;
// with .trans, the B fragments (b0, b1) of n-tiles col0 and col0 + 8 when
// the tile's rows are k. b_ptr: order (+0, +0), (+0, +8), (+8, +0),
// (+8, +8): plain, the B fragments (b0, b1) of n-tiles row0 and row0 + 8
// when the tile's rows are n and its columns k. T is a tile (Tile<D, R>).
template <class T>
__device__ __forceinline__ const bf16* a_ptr(const T& t, int row0, int col0,
                                             int lane) {
  return &t[row0 + (lane & 7) + ((lane >> 3) & 1) * 8][col0 + (lane >> 4) * 8];
}
template <class T>
__device__ __forceinline__ const bf16* b_ptr(const T& t, int row0, int col0,
                                             int lane) {
  return &t[row0 + (lane & 7) + (lane >> 4) * 8][col0 + ((lane >> 3) & 1) * 8];
}

// Rows [0, valid) of a [*, D] bf16 array into an R-row tile (cp.async, not
// yet committed); rows past `valid` are zero-filled.
template <int D, int R = kRows>
__device__ __forceinline__ void load_tile(Tile<D, R>& dst, const bf16* src,
                                          int valid) {
  constexpr int kChunks = D / 8;  // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = i * kThreads + threadIdx.x;
    const int r = c / kChunks, cc = c % kChunks;
    const bool ok = r < valid;
    cp_async16(&dst[r][cc * 8], src + (size_t)(ok ? r : 0) * D + cc * 8,
               ok ? 16 : 0);
  }
}

// Streams rows [0, rows) of a and b (each [*, D]) through the shared ring
// ta/tb, 64 rows at a time: body(stage, t0) runs once tile t0/64 has
// arrived in ring slot `stage`, while the next kStages − 1 tiles are in
// flight. Groups the caller committed before are complete when the first
// body runs. On return every copy has landed and the ring is free.
template <int D, class Body>
__device__ __forceinline__ void stream_tiles(Tile<D>* ta, Tile<D>* tb,
                                             const bf16* a, const bf16* b,
                                             int rows, Body&& body) {
  const int tiles = (rows + kRows - 1) / kRows;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      const int valid = min(kRows, rows - s * kRows);
      load_tile<D>(ta[s], a + (size_t)s * kRows * D, valid);
      load_tile<D>(tb[s], b + (size_t)s * kRows * D, valid);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (for this thread)
    __syncthreads();  // ... for every thread, and tile t − 1 is consumed
    const int next = t + kStages - 1;
    if (next < tiles) {
      const int valid = min(kRows, rows - next * kRows);
      load_tile<D>(ta[next % kStages], a + (size_t)next * kRows * D, valid);
      load_tile<D>(tb[next % kStages], b + (size_t)next * kRows * D, valid);
    }
    cp_async_commit();
    body(t % kStages, t * kRows);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// One 64-key tile of the online softmax for a warp's MT × 16 query rows
// (the forward, and pass 1 of the backward's dq kernel). qf: the rows' Q
// fragments, per 16-row m-tile; ks, vs: the key and value tile; t0: its
// first key; m: the number of keys; c = scale·log2(e). Per thread and
// m-tile: mx, the running row max of s·c; l, this thread's part of the row
// sum of the unrounded p (summed across the lane quad by the caller); o,
// the unnormalised output. P is rounded to bf16 for the PV product, as the
// TPU kernel does. Each K and V fragment loaded serves all MT m-tiles.
template <int D, int MT>
__device__ __forceinline__ void softmax_tile(
    const uint32_t (&qf)[MT][D / 16][4], const Tile<D>& ks, const Tile<D>& vs,
    int t0, int m, float c, int lane, float (&mx)[MT][2], float (&l)[MT][2],
    float (&o)[MT][D / 8][4]) {
  const int tg = lane & 3;
  float s[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, b_ptr(ks, 16 * p, 16 * kc, lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(s[mt][2 * p], qf[mt][kc], b[0], b[1]);
        mma(s[mt][2 * p + 1], qf[mt][kc], b[2], b[3]);
      }
    }
  }
  uint32_t pa[MT][4][4];  // P as the A fragments of keys 16j..16j+15
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (t0 + kRows > m) {  // ragged last tile: keys past m score −∞
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + 8 * i + 2 * tg + (e & 1) >= m) s[mt][i][e] = -INFINITY;
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[mt][i][0], s[mt][i][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[mt][i][2], s[mt][i][3]));
    }
    float mnew[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      mnew[h] = fmaxf(mx[mt][h], tmax[h] * c);  // finite: every tile has a key
      const float alpha = ex2(mx[mt][h] - mnew[h]);  // 0 on the first tile
      mx[mt][h] = mnew[h];
      l[mt][h] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[mt][j][2 * h] *= alpha;
        o[mt][j][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p0 = ex2(fmaf(s[mt][i][0], c, -mnew[0]));
      const float p1 = ex2(fmaf(s[mt][i][1], c, -mnew[0]));
      const float p2 = ex2(fmaf(s[mt][i][2], c, -mnew[1]));
      const float p3 = ex2(fmaf(s[mt][i][3], c, -mnew[1]));
      l[mt][0] += p0 + p1;
      l[mt][1] += p2 + p3;
      pa[mt][i / 2][(i & 1) * 2] = pack_bf16(p0, p1);
      pa[mt][i / 2][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t b[4];
      ldsm_x4_t(b, a_ptr(vs, 16 * j, 16 * p, lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(o[mt][2 * p], pa[mt][j], b[0], b[1]);
        mma(o[mt][2 * p + 1], pa[mt][j], b[2], b[3]);
      }
    }
  }
}

// Sum of a value over the lane quad that shares a row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Lets a kernel launch with `bytes` of dynamic shared memory: above 48 KB
// (the D = 64 rings) a kernel must ask for it. Below, nothing is asked: the
// runtime call would add its time to every launch on the main path (D = 32).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace attn_mma
