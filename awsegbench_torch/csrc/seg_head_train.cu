// Fused faithful segmentation head, train mode: forward (K7) and backward
// (K8) of the head's core
//   fine[p,q,c] = Σ_b Ax[q,b] · Σ_a Ay[p,a] · pp[a·9+b, c]   (upsample∘conv3×3)
//   z = fine·a1[c] + c1[c]                 (BN with batch statistics, folded)
//   v = keep(y,x,c) ? relu(z)·(1/keep) : 0  (counter-hash dropout)
//   logits = v · wp + bp                    (1×1)
// per coarse cell, where pp[(3ky+dy)·9 + 3dx+kx, c] = P[b, i+dy-1, j+dx-1,
// ky, kx, c] are the clamped 3×3 neighbourhood's coarse partial products
// P = f·W1 (as in seg_head.cu, K2).
//
// Replaces the TPU kernels awsegbench/ops/headkernels_train.py::
// _seg_train_fwd_kernel and ::_seg_train_bwd_kernel (pallas_calls in
// _seg_core_fwd and _seg_core_bwd).
//
// The dropout mask is a pure function of the element's position: keep iff
// mix32(idx ^ seed_b) >= round(rate·2³²), idx = (y·W + x)·C + c per image,
// seed_b = seed ^ mix32(b·0x7FEB352D), mix32 the lowbias32 mixer in uint32
// (wrap-around multiplies, logical shifts) — the same bits as the TPU
// kernels, the border strips and the plain version. So the backward
// regenerates the forward's mask and nothing is stored.
//
// Forward (seg_train_fwd): K2's design. The TPU kernel ran one
// [r², 81]×[81, C] matmul against kron(Ay, Ax); staged in f32 that table is
// 330 KB, more than a Hopper block's shared memory, so the kernel runs the
// two 9-tap passes with [r, 9] tables, walks C in 16-channel slices, and
// keeps each thread's 4 fine pixels × 19 logits in registers: the
// full-resolution 256-channel hidden never leaves the SM.
//
// Backward (seg_train_bwd): one block per coarse cell, one thread per
// channel (256 on the main path). A thread recomputes its channel's
// r×r fine values and mask, and accumulates in registers everything that
// sums over the cell's pixels for its channel: da1, dc1, dwp[c, :] and the
// phase-table transpose dpp[:, c] (81 values). The output gradient tile
// (r²×19) and the cell's pp (81×256) sit in shared memory and are read by
// all threads alike. The TPU kernel summed da1/dc1/dwp/dbp over a grid that
// ran in order; here each block writes its partial sums and seg_train_reduce
// adds the blocks' rows in block order (deterministic, no float atomics).
// dpp [B, h, w, 81, C] goes to device memory; its scatter back to P (the
// transpose of the neighbourhood gather) is plain PyTorch.
//
// Rounding follows the TPU kernels: bf16 mode feeds the matmuls bf16
// operands (P, wp, dy as given; the post-dropout hidden before the 1×1 and
// dwp; dfine before the phase transpose) with f32 sums. As in K2, the
// kron table's bf16 products cannot be rounded inside two passes (exact for
// r ≤ 8).
//
// Bound on the H100 (B = 8, 512×1024, C = 256, 19 classes): the forward is
// about 15.6 kflop per output pixel (1296 y-pass + 4608 x-pass + 9728 for
// the 1×1), 65.6 GFLOP; the backward about 31 kflop per pixel (the
// recompute, dy·wpᵀ, vᵀ·dy, the transposed passes), 131 GFLOP, plus the
// 170 MB dpp write in bf16. Both are compute-bound (≈0.07 and 0.13 ms at
// the bf16 tensor-core rate). This first version runs on the CUDA cores in
// f32, and the backward runs one 160 KB block per SM; tensor-core tiles
// (wgmma) and fusing the dpp scatter are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCS = 16;    // channels per shared slice (forward)
constexpr int kRMax = 32;  // largest upsample factor
constexpr int kRows = 4;   // fine rows per thread (forward: kRMax / 8 warps)
constexpr int kCB = 256;   // channels per group (backward: one per thread)

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

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// seed ^ mix32(b · M1): image b's stream.
__device__ __forceinline__ uint32_t image_seed(const int* seed, int b) {
  return (uint32_t)seed[0] ^ mix32((uint32_t)b * 0x7FEB352Du);
}

__device__ __forceinline__ bool keep_bit(uint32_t bseed, int y, int x, int c,
                                         int W, int C, uint32_t thresh) {
  const uint32_t idx = (uint32_t)((y * W + x) * C + c);
  return mix32(idx ^ bseed) >= thresh;
}

// Gathers the 81 neighbourhood rows of channels [c0, c0 + width) of coarse
// cell (b, i, j) into dst[row · stride + cc].
template <typename T>
__device__ __forceinline__ void gather_pp(const T* __restrict__ P, float* dst,
                                          int stride, int b, int i, int j,
                                          int h, int w, int C, int c0,
                                          int width) {
  for (int e = threadIdx.x; e < 81 * width; e += kThreads) {
    const int row = e / width, cc = e % width;
    const int a = row / 9, bb = row % 9;
    const int ky = a / 3, dy = a % 3, dx = bb / 3, kx = bb % 3;
    const int yi = min(max(i + dy - 1, 0), h - 1);
    const int xj = min(max(j + dx - 1, 0), w - 1);
    dst[row * stride + cc] =
        c0 + cc < C
            ? to_f32(P[((((size_t)b * h + yi) * w + xj) * 9 + ky * 3 + kx) * C +
                       c0 + cc])
            : 0.f;
  }
}

// ---------------------------------------------------------------- K7

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    seg_train_fwd(const T* __restrict__ P, const float* __restrict__ ay,
                  const float* __restrict__ ax, const float* __restrict__ a1,
                  const float* __restrict__ c1, const T* __restrict__ wp,
                  const float* __restrict__ bp, const int* __restrict__ seed,
                  uint32_t thresh, float inv_keep, int drop,
                  T* __restrict__ out, int h, int w, int C, int r) {
  __shared__ float pp_s[81][kCS];
  __shared__ float t_s[kRMax][9][kCS];
  __shared__ float ay_s[kRMax][9];
  __shared__ float wp_s[kCS][NC];
  __shared__ float a1_s[kCS], c1_s[kCS];

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wy = tid >> 5;
  const int q = lane;
  const int H = h * r, W = w * r;
  const uint32_t bseed = image_seed(seed, b);

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
    gather_pp(P, &pp_s[0][0], kCS, b, i, j, h, w, C, c0, kCS);
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

    // x-pass, affine + ReLU, dropout, 1×1 accumulation
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
            float u = fmaxf(fine * sa + sc, 0.f);
            if (drop)
              u = keep_bit(bseed, i * r + p, j * r + q, c0 + c, W, C, thresh)
                      ? u * inv_keep
                      : 0.f;
            const float hid = round_like(u, P);
#pragma unroll
            for (int k = 0; k < NC; ++k) acc[t][k] += hid * wp_s[c][k];
          }
        }
      }
    }
  }

  if (q < r) {
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

// ---------------------------------------------------------------- K8

// Dynamic shared memory: dy tile [r·r][NC] then pp [81][kCB], f32.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
    seg_train_bwd(const T* __restrict__ P, const float* __restrict__ ay,
                  const float* __restrict__ ax, const float* __restrict__ a1,
                  const float* __restrict__ c1, const T* __restrict__ wp,
                  const T* __restrict__ dy, const int* __restrict__ seed,
                  uint32_t thresh, float inv_keep, int drop,
                  T* __restrict__ dpp, float* __restrict__ part, int h, int w,
                  int C, int r) {
  extern __shared__ float smem[];
  float* dy_s = smem;              // [r·r][NC]
  float* pp_s = smem + r * r * NC;  // [81][kCB]
  __shared__ float ay_s[kRMax][9], ax_s[kRMax][9];

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = h * r, W = w * r;
  const uint32_t bseed = image_seed(seed, b);
  const size_t blk = ((size_t)b * h + i) * w + j;
  const int stride = 2 * C + C * NC + NC;
  float* prow = part + blk * stride;

  for (int e = tid; e < r * 9; e += kThreads) {
    ay_s[e / 9][e % 9] = ay[e];
    ax_s[e / 9][e % 9] = ax[e];
  }
  for (int e = tid; e < r * r * NC; e += kThreads) {
    const int pix = e / NC, k = e % NC;
    const int p = pix / r, q = pix % r;
    dy_s[e] = to_f32(dy[(((size_t)b * H + i * r + p) * W + j * r + q) * NC + k]);
  }
  __syncthreads();
  if (tid < NC) {  // dbp: this cell's Σ over pixels, in pixel order
    float s = 0.f;
    for (int pix = 0; pix < r * r; ++pix) s += dy_s[pix * NC + tid];
    prow[2 * C + C * NC + tid] = s;
  }

  for (int c0 = 0; c0 < C; c0 += kCB) {
    __syncthreads();  // the previous group's pp is no longer read
    gather_pp(P, pp_s, kCB, b, i, j, h, w, C, c0, kCB);
    __syncthreads();
    const int c = c0 + tid;
    if (c >= C) continue;

    float wpr[NC], dwp[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      wpr[k] = to_f32(wp[(size_t)c * NC + k]);
      dwp[k] = 0.f;
    }
    float dacc[81];
#pragma unroll
    for (int e = 0; e < 81; ++e) dacc[e] = 0.f;
    const float sa = a1[c], sc = c1[c];
    float da = 0.f, dc = 0.f;

#pragma unroll 1
    for (int p = 0; p < r; ++p) {
      float t[9], tq[9];
#pragma unroll
      for (int bb = 0; bb < 9; ++bb) {
        float s = 0.f;
#pragma unroll
        for (int a = 0; a < 9; ++a) s += ay_s[p][a] * pp_s[(a * 9 + bb) * kCB + tid];
        t[bb] = s;
        tq[bb] = 0.f;
      }
#pragma unroll 1
      for (int q = 0; q < r; ++q) {
        float fine = 0.f;
#pragma unroll
        for (int bb = 0; bb < 9; ++bb) fine += ax_s[q][bb] * t[bb];
        const float z = fine * sa + sc;
        float u = fmaxf(z, 0.f);
        bool keep = true;
        if (drop) {
          keep = keep_bit(bseed, i * r + p, j * r + q, c, W, C, thresh);
          u = keep ? u * inv_keep : 0.f;
        }
        const float v = round_like(u, P);
        const float* dyp = dy_s + (p * r + q) * NC;
        float dyr[NC];
        float dv = 0.f;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          dyr[k] = dyp[k];
          dv += dyr[k] * wpr[k];
        }
#pragma unroll
        for (int k = 0; k < NC; ++k) dwp[k] += v * dyr[k];
        const float du = drop ? (keep ? dv * inv_keep : 0.f) : dv;
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

    T* drow = dpp + blk * 81 * C + c;
#pragma unroll
    for (int e = 0; e < 81; ++e) store(drow + (size_t)e * C, dacc[e]);
    prow[c] = da;
    prow[C + c] = dc;
#pragma unroll
    for (int k = 0; k < NC; ++k) prow[2 * C + c * NC + k] = dwp[k];
  }
}

// out[x] = Σ_row part[row][x], rows in order: a block takes 32 columns, its
// 8 warps take every 8th row, and the 8 warp sums add in warp order.
__global__ void __launch_bounds__(kThreads)
    seg_train_reduce(const float* __restrict__ part, float* __restrict__ out,
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

constexpr int kNC = 19;

size_t bwd_smem(int r) { return (size_t)(r * r * kNC + 81 * kCB) * sizeof(float); }

template <typename T>
int fwd_typed(const void* P, const float* ay, const float* ax, const float* a1,
              const float* c1, const void* wp, const float* bp, const int* seed,
              uint32_t thresh, float inv_keep, int drop, void* out, int B,
              int h, int w, int C, int r, cudaStream_t stream) {
  seg_train_fwd<T, kNC><<<dim3(w, h, B), kThreads, 0, stream>>>(
      (const T*)P, ay, ax, a1, c1, (const T*)wp, bp, seed, thresh, inv_keep,
      drop, (T*)out, h, w, C, r);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_typed(const void* P, const float* ay, const float* ax, const float* a1,
              const float* c1, const void* wp, const void* dy, const int* seed,
              uint32_t thresh, float inv_keep, int drop, void* dpp, float* part,
              float* sums, int B, int h, int w, int C, int r,
              cudaStream_t stream) {
  const size_t smem = bwd_smem(r);
  int rc = (int)cudaFuncSetAttribute(seg_train_bwd<T, kNC>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  seg_train_bwd<T, kNC><<<dim3(w, h, B), kThreads, smem, stream>>>(
      (const T*)P, ay, ax, a1, c1, (const T*)wp, (const T*)dy, seed, thresh,
      inv_keep, drop, (T*)dpp, part, h, w, C, r);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int cols = 2 * C + C * kNC + kNC;
  seg_train_reduce<<<(cols + 31) / 32, kThreads, 0, stream>>>(
      part, sums, B * h * w, cols);
  return (int)cudaGetLastError();
}

bool shapes_ok(int r, int C, int nc) {
  return r >= 1 && r <= kRMax && C % kCS == 0 && nc == kNC;
}

}  // namespace

// Forward: P [B, h, w, 9, C], wp [C, 19] in P's dtype; ay, ax [r, 9], a1, c1
// [C], bp [19] f32; seed int32 [1] on the device; out [B, h·r, w·r, 19].
extern "C" int seg_train_fwd_launch(const void* P, const void* ay,
                                    const void* ax, const void* a1,
                                    const void* c1, const void* wp,
                                    const void* bp, const void* seed,
                                    unsigned thresh, float inv_keep, int drop,
                                    void* out, int B, int h, int w, int C,
                                    int r, int nc, int is_bf16, void* stream) {
  if (!shapes_ok(r, C, nc)) return (int)cudaErrorInvalidValue;
  const float *fay = (const float*)ay, *fax = (const float*)ax;
  const float *fa1 = (const float*)a1, *fc1 = (const float*)c1;
  if (is_bf16)
    return fwd_typed<__nv_bfloat16>(P, fay, fax, fa1, fc1, wp, (const float*)bp,
                                    (const int*)seed, thresh, inv_keep, drop,
                                    out, B, h, w, C, r, (cudaStream_t)stream);
  return fwd_typed<float>(P, fay, fax, fa1, fc1, wp, (const float*)bp,
                          (const int*)seed, thresh, inv_keep, drop, out, B, h,
                          w, C, r, (cudaStream_t)stream);
}

// Backward: + dy [B, h·r, w·r, 19] in P's dtype; writes dpp [B, h, w, 81, C]
// in P's dtype and sums [2C + 19C + 19] f32 = (da1 | dc1 | dwp [C, 19] |
// dbp); part is f32 scratch [B·h·w, 2C + 19C + 19].
extern "C" int seg_train_bwd_launch(const void* P, const void* ay,
                                    const void* ax, const void* a1,
                                    const void* c1, const void* wp,
                                    const void* dy, const void* seed,
                                    unsigned thresh, float inv_keep, int drop,
                                    void* dpp, void* part, void* sums, int B,
                                    int h, int w, int C, int r, int nc,
                                    int is_bf16, void* stream) {
  if (!shapes_ok(r, C, nc)) return (int)cudaErrorInvalidValue;
  const float *fay = (const float*)ay, *fax = (const float*)ax;
  const float *fa1 = (const float*)a1, *fc1 = (const float*)c1;
  if (is_bf16)
    return bwd_typed<__nv_bfloat16>(P, fay, fax, fa1, fc1, wp, dy,
                                    (const int*)seed, thresh, inv_keep, drop,
                                    dpp, (float*)part, (float*)sums, B, h, w, C,
                                    r, (cudaStream_t)stream);
  return bwd_typed<float>(P, fay, fax, fa1, fc1, wp, dy, (const int*)seed,
                          thresh, inv_keep, drop, dpp, (float*)part,
                          (float*)sums, B, h, w, C, r, (cudaStream_t)stream);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
