// Fused faithful segmentation head, train mode: forward (K7) and backward
// (K8) of the head's core
//   fine[p,q,c] = Σ_k kron(Ay, Ax)[p·r+q, k] · pp[k, c]    (upsample∘conv3×3)
//   z = fine·a1[c] + c1[c]                 (BN with batch statistics, folded)
//   v = keep(y,x,c) ? relu(z)·(1/keep) : 0  (counter-hash dropout)
//   logits = v · wp + bp                    (1×1)
// per coarse cell, where pp[(3ky+dy)·9 + 3dx+kx, c] = P[b, i+dy-1, j+dx-1,
// ky, kx, c] are the clamped 3×3 neighbourhood's coarse partial products
// P = f·W1 (as in seg_head.cu, K2). Classes: 1 ≤ nc ≤ 32, padded inside
// each kernel with zero columns of wp (and, in K8, of dy); only k < nc is
// stored. Shapes: 1 ≤ r ≤ 32, C % 16 == 0.
//
// Replaces the TPU kernels awsegbench/ops/headkernels_train.py::
// _seg_train_fwd_kernel and ::_seg_train_bwd_kernel (pallas_calls in
// _seg_core_fwd and _seg_core_bwd).
//
// The dropout mask is a pure function of the element's position: keep iff
// mix32(idx ^ seed_b) >= round(rate·2³²), idx = (y·W + x)·C + c per image,
// seed_b = seed ^ mix32(b·0x7FEB352D), mix32 the lowbias32 mixer in uint32
// (wrap-around multiplies, logical shifts; seg_head_mma.cuh) — the same
// bits as the TPU kernels, the border strips and the plain version. So the
// backward regenerates the forward's mask and nothing is stored.
//
// Forward (K7), two designs chosen by the dtype
// (ops/headkernels_train.py::_design), as K2's:
// - 'mma_bf16': K2's tensor-core body (seg_head_mma.cuh) with the hash
//   dropout switched on by its template flag: one GEMM against the bf16
//   kron table (the TPU kernel's own operands), the batch-stat affine, ReLU
//   and dropout in registers, the 1×1 on the tensor cores. The hash costs
//   about 9 ALU-pipe instructions per element of the full-resolution
//   hidden (scripts/seg_head_sass.py), this kernel's floor.
// - 'simt_f32' (seg_train_fwd): K2's CUDA-core design, the two 9-tap
//   passes with [r, 9] tables in 16-channel slices; each thread keeps its 4
//   fine pixels' logits in registers.
// Neither writes the full-resolution 256-channel hidden to device memory.
//
// Backward (K8), two designs chosen by the dtype, as the forward's:
// - 'mma_bf16': seg_bwd_mma.cuh on the tensor cores. It recomputes fine
//   with K7's own fine_tile against the bf16 kron table (so the ReLU and
//   the mask decide as K7 did), then dv = dy·wpᵀ, dwp = vᵀ·dy and the phase
//   transpose dpp = kronᵀ·bf16(dfine) as mma.sync products; 16 channels a
//   warp, the cell's pixels 16 at a time. Rounding as the TPU kernel: bf16
//   operands (P, wp, dy as given; the post-dropout hidden before dwp; dfine
//   before the transpose) with f32 sums.
// - 'simt_f32' (seg_train_bwd): one block per coarse cell, one thread per
//   channel. A thread recomputes its channel's r×r fine values with the
//   two exact 9-tap passes (as the simt_f32 forward) and its mask, and
//   accumulates in registers everything that sums over the cell's pixels
//   for its channel: da1, dc1, dwp[c, :] and the phase-table transpose
//   dpp[:, c]. The output gradient tile (r²×nc) and the cell's pp (81×256)
//   sit in shared memory and are read by all threads alike.
// The TPU kernel summed da1/dc1/dwp/dbp over a grid that ran in order;
// here each block writes its partial sums and seg_train_reduce adds the
// blocks' rows in block order (deterministic, no float atomics). dpp
// [B, h, w, 81, C] goes to device memory; pp_adjoint.cu scatters it back
// to P (the transpose of the neighbourhood gather).
//
// Bound on the H100 (B = 8, 512×1024, C = 256, 19 classes): the forward is
// about 15.6 kflop per output pixel factorised (65.6 GFLOP), 258 GFLOP as
// the kron GEMM with K = 96 and 24 padded classes (0.26 ms at the bf16
// tensor-core rate); the backward about 31 kflop per pixel factorised (the
// recompute, dy·wpᵀ, vᵀ·dy, the transposed passes), 131 GFLOP, about 530
// GFLOP as the tensor-core products, plus the 170 MB dpp write in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_bwd_mma.cuh"
#include "seg_head_mma.cuh"

namespace {

using seg_mma::image_seed;
using seg_mma::mix32;

constexpr int kThreads = 256;
constexpr int kCS = 16;    // channels per shared slice (forward)
constexpr int kRMax = 32;  // largest upsample factor
constexpr int kRows = 4;   // fine rows per thread (forward: kRMax / 8 warps)
constexpr int kCB = 256;   // channels per group (backward: one per thread)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------- K7, f32

// NCP = 8·⌈nc/8⌉ logits per pixel in registers; classes ≥ nc have zero
// weights and are not stored.
template <int NCP>
__global__ void __launch_bounds__(kThreads)
    seg_train_fwd(const float* __restrict__ P, const float* __restrict__ ay,
                  const float* __restrict__ ax, const float* __restrict__ a1,
                  const float* __restrict__ c1, const float* __restrict__ wp,
                  const float* __restrict__ bp, const int* __restrict__ seed,
                  uint32_t thresh, float inv_keep, int drop,
                  float* __restrict__ out, int h, int w, int C, int r,
                  int nc) {
  __shared__ float pp_s[81][kCS];
  __shared__ float t_s[kRMax][9][kCS];
  __shared__ float ay_s[kRMax][9];
  __shared__ float wp_s[kCS][NCP];
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

  float acc[kRows][NCP];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int k = 0; k < NCP; ++k) acc[t][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCS) {
    __syncthreads();  // the previous slice is no longer read
    gather_pp(P, &pp_s[0][0], kCS, b, i, j, h, w, C, c0, kCS);
    for (int e = tid; e < kCS * NCP; e += kThreads) {
      const int c = e / NCP, k = e % NCP;
      wp_s[c][k] = k < nc ? wp[(size_t)(c0 + c) * nc + k] : 0.f;
    }
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
#pragma unroll
            for (int k = 0; k < NCP; ++k) acc[t][k] += u * wp_s[c][k];
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
        float* o = out + (((size_t)b * H + i * r + p) * W + j * r + q) * nc;
#pragma unroll
        for (int k = 0; k < NCP; ++k)
          if (k < nc) o[k] = acc[t][k] + bp[k];
      }
    }
  }
}

// ---------------------------------------------------------------- K8

// What a K8 thread carries through its channel's pixels: the cell's shared
// tiles, its channel's weights, and the sums it accumulates.
template <int NCP>
struct Bwd {
  const float* dy_s;          // [r·r][NCP], zero columns past nc
  float wpr[NCP], dwp[NCP];   // wp[c, :] (zero past nc), Σ v·dy
  float sa, sc, da, dc;       // a1[c], c1[c], Σ dz·fine, Σ dz
  uint32_t bseed, thresh;
  float inv_keep;
  int drop;
};

// One fine pixel of the thread's channel c, given its recomputed fine
// value: dropout, dv = dy·wpᵀ, the sums of dwp, da1 and dc1; returns dfine
// (rounded to bf16 in bf16 mode, as the TPU kernel feeds it to the phase
// transpose).
template <typename T, int NCP>
__device__ __forceinline__ float bwd_pixel(Bwd<NCP>& s, float fine, int pix,
                                           uint32_t idx) {
  const float z = fine * s.sa + s.sc;
  float u = fmaxf(z, 0.f);
  bool keep = true;
  if (s.drop) {
    keep = mix32(idx ^ s.bseed) >= s.thresh;
    u = keep ? u * s.inv_keep : 0.f;
  }
  const float v = round_like(u, (const T*)nullptr);
  const float* dyp = s.dy_s + pix * NCP;
  float dyr[NCP];
  float dv = 0.f;
#pragma unroll
  for (int k = 0; k < NCP; ++k) {
    dyr[k] = dyp[k];
    dv += dyr[k] * s.wpr[k];
  }
#pragma unroll
  for (int k = 0; k < NCP; ++k) s.dwp[k] += v * dyr[k];
  const float du = s.drop ? (keep ? dv * s.inv_keep : 0.f) : dv;
  const float dz = z > 0.f ? du : 0.f;
  s.da += dz * fine;
  s.dc += dz;
  return round_like(dz * s.sa, (const T*)nullptr);
}

// f32: the two exact 9-tap passes, as the forward's simt_f32 design (y-pass
// per fine row, x-pass per pixel; the transpose likewise in two passes).
template <int NCP>
__device__ __forceinline__ void bwd_passes(Bwd<NCP>& s, const float* pp_s,
                                           const float (*ay_s)[9],
                                           const float (*ax_s)[9], int r,
                                           int i, int j, int W, int C, int c,
                                           float* __restrict__ drow) {
  const int tid = threadIdx.x;
  float dacc[81];
#pragma unroll
  for (int e = 0; e < 81; ++e) dacc[e] = 0.f;
#pragma unroll 1
  for (int p = 0; p < r; ++p) {
    float t[9], tq[9];
#pragma unroll
    for (int bb = 0; bb < 9; ++bb) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 9; ++a)
        acc += ay_s[p][a] * pp_s[(a * 9 + bb) * kCB + tid];
      t[bb] = acc;
      tq[bb] = 0.f;
    }
    const uint32_t idx0 = (uint32_t)(((i * r + p) * W + j * r) * C + c);
#pragma unroll 1
    for (int q = 0; q < r; ++q) {
      float fine = 0.f;
#pragma unroll
      for (int bb = 0; bb < 9; ++bb) fine += ax_s[q][bb] * t[bb];
      const float df = bwd_pixel<float>(s, fine, p * r + q,
                                        idx0 + (uint32_t)(q * C));
#pragma unroll
      for (int bb = 0; bb < 9; ++bb) tq[bb] += ax_s[q][bb] * df;
    }
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int bb = 0; bb < 9; ++bb) dacc[a * 9 + bb] += ay_s[p][a] * tq[bb];
  }
#pragma unroll
  for (int e = 0; e < 81; ++e) store(drow + (size_t)e * C, dacc[e]);
}

// NCP classes in registers (the instantiation bwd_ncp picks for nc; zero
// columns of dy and wp past nc). Dynamic shared memory: dy tile [r·r][NCP]
// then pp [81][kCB], f32. A block's partial row: da1 [C] | dc1 [C] |
// dwp [C, nc] | dbp [nc].
template <typename T, int NCP>
__global__ void __launch_bounds__(kThreads, 1)
    seg_train_bwd(const T* __restrict__ P, const float* __restrict__ ay,
                  const float* __restrict__ ax, const float* __restrict__ a1,
                  const float* __restrict__ c1, const T* __restrict__ wp,
                  const T* __restrict__ dy, const int* __restrict__ seed,
                  uint32_t thresh, float inv_keep, int drop,
                  T* __restrict__ dpp, float* __restrict__ part, int h, int w,
                  int C, int r, int nc) {
  extern __shared__ float smem[];
  float* dy_s = smem;                // [r·r][NCP]
  float* pp_s = smem + r * r * NCP;  // [81][kCB]
  __shared__ float ay_s[kRMax][9], ax_s[kRMax][9];

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = h * r, W = w * r;
  const size_t blk = ((size_t)b * h + i) * w + j;
  const int stride = 2 * C + C * nc + nc;
  float* prow = part + blk * stride;

  for (int e = tid; e < r * 9; e += kThreads) {
    ay_s[e / 9][e % 9] = ay[e];
    ax_s[e / 9][e % 9] = ax[e];
  }
  for (int e = tid; e < r * r * NCP; e += kThreads) {
    const int pix = e / NCP, k = e % NCP;
    const int p = pix / r, q = pix % r;
    dy_s[e] = k < nc ? to_f32(dy[(((size_t)b * H + i * r + p) * W + j * r +
                                  q) * nc + k])
                     : 0.f;
  }
  __syncthreads();
  if (tid < nc) {  // dbp: this cell's Σ over pixels, in pixel order
    float acc = 0.f;
    for (int pix = 0; pix < r * r; ++pix) acc += dy_s[pix * NCP + tid];
    prow[2 * C + C * nc + tid] = acc;
  }

  Bwd<NCP> s;
  s.dy_s = dy_s;
  s.bseed = image_seed(seed, b);
  s.thresh = thresh;
  s.inv_keep = inv_keep;
  s.drop = drop;
  for (int c0 = 0; c0 < C; c0 += kCB) {
    __syncthreads();  // the previous group's pp is no longer read
    gather_pp(P, pp_s, kCB, b, i, j, h, w, C, c0, kCB);
    __syncthreads();
    const int c = c0 + tid;
    const bool active = c < C;
    const int cc = active ? c : 0;
#pragma unroll
    for (int k = 0; k < NCP; ++k) {
      s.wpr[k] = k < nc ? to_f32(wp[(size_t)cc * nc + k]) : 0.f;
      s.dwp[k] = 0.f;
    }
    s.sa = a1[cc];
    s.sc = c1[cc];
    s.da = s.dc = 0.f;
    T* drow = dpp + blk * 81 * C + cc;
    if (!active) continue;
    bwd_passes(s, pp_s, ay_s, ax_s, r, i, j, W, C, c, drow);
    prow[c] = s.da;
    prow[C + c] = s.dc;
#pragma unroll
    for (int k = 0; k < NCP; ++k)
      if (k < nc) prow[2 * C + c * nc + k] = s.dwp[k];
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

template <int NCP>
int fwd_f32(const void* P, const float* ay, const float* ax, const float* a1,
            const float* c1, const void* wp, const float* bp, const int* seed,
            uint32_t thresh, float inv_keep, int drop, void* out, int B, int h,
            int w, int C, int r, int nc, cudaStream_t stream) {
  seg_train_fwd<NCP><<<dim3(w, h, B), kThreads, 0, stream>>>(
      (const float*)P, ay, ax, a1, c1, (const float*)wp, bp, seed, thresh,
      inv_keep, drop, (float*)out, h, w, C, r, nc);
  return (int)cudaGetLastError();
}

template <typename T, int NCP>
int bwd_typed(const void* P, const float* ay, const float* ax, const float* a1,
              const float* c1, const void* wp, const void* dy, const int* seed,
              uint32_t thresh, float inv_keep, int drop, void* dpp, float* part,
              float* sums, int B, int h, int w, int C, int r, int nc,
              cudaStream_t stream) {
  const size_t smem = (size_t)(r * r * NCP + 81 * kCB) * sizeof(float);
  int rc = (int)cudaFuncSetAttribute(seg_train_bwd<T, NCP>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  seg_train_bwd<T, NCP><<<dim3(w, h, B), kThreads, smem, stream>>>(
      (const T*)P, ay, ax, a1, c1, (const T*)wp, (const T*)dy, seed, thresh,
      inv_keep, drop, (T*)dpp, part, h, w, C, r, nc);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int cols = 2 * C + C * nc + nc;
  seg_train_reduce<<<(cols + 31) / 32, kThreads, 0, stream>>>(
      part, sums, B * h * w, cols);
  return (int)cudaGetLastError();
}

// The f32 K8 keeps a thread's rows of wp, dwp and dy in registers and does
// all their work for every class it was instantiated for, so the
// instantiation follows the class count: exactly 19 (Cityscapes, every
// configuration of the repo), else 8·⌈nc/8⌉ with zero columns past nc, as
// K2 and K7 pad.
template <typename T>
int bwd_ncp(const void* P, const float* ay, const float* ax, const float* a1,
            const float* c1, const void* wp, const void* dy, const int* seed,
            uint32_t thresh, float inv_keep, int drop, void* dpp, float* part,
            float* sums, int B, int h, int w, int C, int r, int nc,
            cudaStream_t stream) {
#define K8_CASE(n)                                                            \
  return bwd_typed<T, n>(P, ay, ax, a1, c1, wp, dy, seed, thresh, inv_keep,  \
                         drop, dpp, part, sums, B, h, w, C, r, nc, stream);
  if (nc == 19) K8_CASE(19)
  switch ((nc + 7) / 8) {
    case 1: K8_CASE(8)
    case 2: K8_CASE(16)
    case 3: K8_CASE(24)
    default: K8_CASE(32)
  }
#undef K8_CASE
}

bool shapes_ok(int r, int C, int nc) {
  return r >= 1 && r <= kRMax && C % kCS == 0 && nc >= 1 && nc <= 32;
}

}  // namespace

// Forward: P [B, h, w, 9, C], wp [C, nc] in one dtype (bf16 or f32); ay, ax
// [r, 9], a1, c1 [C], bp [nc] f32; seed int32 [1] on the device; out
// [B, h·r, w·r, nc] in P's dtype.
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    const seg_mma::Params prm{
        (const seg_mma::bf16*)P, fay, fax, fa1, fc1, (const seg_mma::bf16*)wp,
        (const float*)bp, (const int*)seed, thresh, inv_keep,
        (seg_mma::bf16*)out, h, w, C, r, nc};
    return (int)(drop ? seg_mma::launch<true>(prm, B, s)
                      : seg_mma::launch<false>(prm, B, s));
  }
  const float* fbp = (const float*)bp;
  const int* sd = (const int*)seed;
  switch ((nc + 7) / 8) {
    case 1: return fwd_f32<8>(P, fay, fax, fa1, fc1, wp, fbp, sd, thresh, inv_keep, drop, out, B, h, w, C, r, nc, s);
    case 2: return fwd_f32<16>(P, fay, fax, fa1, fc1, wp, fbp, sd, thresh, inv_keep, drop, out, B, h, w, C, r, nc, s);
    case 3: return fwd_f32<24>(P, fay, fax, fa1, fc1, wp, fbp, sd, thresh, inv_keep, drop, out, B, h, w, C, r, nc, s);
    default: return fwd_f32<32>(P, fay, fax, fa1, fc1, wp, fbp, sd, thresh, inv_keep, drop, out, B, h, w, C, r, nc, s);
  }
}

// Backward: + dy [B, h·r, w·r, nc] in P's dtype; writes dpp [B, h, w, 81, C]
// in P's dtype and sums [2C + nc·C + nc] f32 = (da1 | dc1 | dwp [C, nc] |
// dbp); part is f32 scratch [B·h·w, 2C + nc·C + nc]. bf16 runs the
// tensor-core body (seg_bwd_mma.cuh), which also takes kron, the [r², 96]
// bf16 kron table; f32 the CUDA-core body (kron unused).
extern "C" int seg_train_bwd_launch(const void* P, const void* ay,
                                    const void* ax, const void* a1,
                                    const void* c1, const void* wp,
                                    const void* dy, const void* seed,
                                    unsigned thresh, float inv_keep, int drop,
                                    void* dpp, void* part, void* sums,
                                    const void* kron, int B, int h, int w,
                                    int C, int r, int nc, int is_bf16,
                                    void* stream) {
  if (!shapes_ok(r, C, nc)) return (int)cudaErrorInvalidValue;
  const float *fay = (const float*)ay, *fax = (const float*)ax;
  const float *fa1 = (const float*)a1, *fc1 = (const float*)c1;
  if (is_bf16) {
    const seg_bwd::Params prm{
        (const seg_mma::bf16*)P, (const seg_mma::bf16*)kron, fa1, fc1,
        (const seg_mma::bf16*)wp, (const seg_mma::bf16*)dy, (const int*)seed,
        thresh, inv_keep, (seg_mma::bf16*)dpp, (float*)part, h, w, C, r, nc};
    int rc = (int)seg_bwd::launch<true>(prm, B, drop != 0,
                                        (cudaStream_t)stream);
    if (rc) return rc;
    const int cols = 2 * C + C * nc + nc;
    seg_train_reduce<<<(cols + 31) / 32, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)part, (float*)sums, B * h * w, cols);
    return (int)cudaGetLastError();
  }
  return bwd_ncp<float>(P, fay, fax, fa1, fc1, wp, dy, (const int*)seed, thresh,
                       inv_keep, drop, dpp, (float*)part, (float*)sums, B, h, w,
                       C, r, nc, (cudaStream_t)stream);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
