// Fused faithful segmentation head, eval mode (K2):
//   logits = conv1x1(relu(BN(conv3x3(upsample_xr(f))))) per fine pixel.
//
// Replaces the TPU kernel awsegbench/ops/headkernels.py::_seg_kernel
// (pallas_call in seg_head_fused). Per coarse cell (b, i, j) it computes the
// r×r fine tile
//   fine[p,q,c] = Σ_k kron(Ay, Ax)[p·r+q, k] · pp[k, c]   (k = a·9 + b)
//   hidden      = relu(fine·a1[c] + c1[c])          (conv bias + BN folded)
//   logits[p,q] = hidden · wp + bp
// where pp[(3ky+dy)·9 + 3dx+kx, c] = P[b, i+dy-1, j+dx-1, ky, kx, c] are the
// coarse partial products P = f·W1 of the 3×3 neighbourhood (clamped at the
// coarse edges, which is the bilinear clamp), gathered by the kernel itself,
// so the 9× larger pp tensor is never written to device memory. Classes:
// 1 ≤ nc ≤ 32, padded inside the kernel to 8·⌈nc/8⌉ with zero columns of wp
// and stored only below nc. Shapes: 1 ≤ r ≤ 32, C % 16 == 0.
//
// Two designs, chosen by the dtype (ops/headkernels.py::_design):
//
// - 'mma_bf16' (seg_head_mma.cuh): bf16 on the tensor cores. The phase
//   passes are one GEMM against the kron table, as on the TPU, whose bf16
//   entries bf16(Ay·Ax) are the TPU kernel's own operands; the affine, ReLU
//   and the 1×1 follow in registers. It rounds where the TPU kernel rounds:
//   bf16 operands, f32 sums, hidden to bf16 before the 1×1, f32 logits + bp,
//   output to bf16.
// - 'simt_f32' (below): f32 on the CUDA cores, kept because TF32 would break
//   f32 parity. Staged in f32 the kron table is 330 KB, more than a block's
//   shared memory, so it runs the factorisation, two 9-tap passes with the
//   [r, 9] tables, which is the same function in f32. C is walked in slices
//   of kCS channels (pp block [81, kCS] and y-pass result [r, 9, kCS] in
//   shared memory); the logits of a thread's four fine pixels accumulate in
//   registers. Grid (w, h, B); 8 warps; lane = fine column q, warp wy owns
//   fine rows wy, wy+8, wy+16, wy+24.
//
// Bound on the H100 (B = 8, 512×1024, C = 256, nc = 19): the factorised
// work is about 15.6 kflop per output pixel (65.6 GFLOP); the kron GEMM
// with K = 96 and 24 padded classes does 258 GFLOP, 0.26 ms at the bf16
// tensor-core rate; the output is 159 MB (0.048 ms). Compute-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "seg_head_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCS = 16;    // channels per shared slice
constexpr int kRMax = 32;  // largest upsample factor
constexpr int kRows = 4;   // fine rows per thread (kRMax / 8 warps)

// NCP = 8·⌈nc/8⌉ logits per pixel in registers; classes ≥ nc have zero
// weights and are not stored.
template <int NCP>
__global__ void __launch_bounds__(kThreads)
    seg_head_kernel(const float* __restrict__ P,   // [B, h, w, 9, C]
                    const float* __restrict__ ay,  // [r, 9]  cols 3ky+dy
                    const float* __restrict__ ax,  // [r, 9]  cols 3dx+kx
                    const float* __restrict__ a1,  // [C]
                    const float* __restrict__ c1,  // [C]
                    const float* __restrict__ wp,  // [C, nc]
                    const float* __restrict__ bp,  // [nc]
                    float* __restrict__ out,       // [B, h·r, w·r, nc]
                    int h, int w, int C, int r, int nc) {
  __shared__ float pp_s[81][kCS];
  __shared__ float t_s[kRMax][9][kCS];
  __shared__ float ay_s[kRMax][9];
  __shared__ float wp_s[kCS][NCP];
  __shared__ float a1_s[kCS], c1_s[kCS];

  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wy = tid >> 5;
  const int q = lane;

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
    for (int e = tid; e < 81 * kCS; e += kThreads) {
      const int row = e / kCS, c = e % kCS;
      const int a = row / 9, bb = row % 9;
      const int ky = a / 3, dy = a % 3, dx = bb / 3, kx = bb % 3;
      const int yi = min(max(i + dy - 1, 0), h - 1);
      const int xj = min(max(j + dx - 1, 0), w - 1);
      pp_s[row][c] =
          P[((((size_t)b * h + yi) * w + xj) * 9 + ky * 3 + kx) * C + c0 + c];
    }
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
            const float hid = fmaxf(fine * sa + sc, 0.f);
#pragma unroll
            for (int k = 0; k < NCP; ++k) acc[t][k] += hid * wp_s[c][k];
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
        float* o = out + (((size_t)b * H + i * r + p) * W + j * r + q) * nc;
#pragma unroll
        for (int k = 0; k < NCP; ++k)
          if (k < nc) o[k] = acc[t][k] + bp[k];
      }
    }
  }
}

template <int NCP>
int launch_f32(const void* P, const void* ay, const void* ax, const void* a1,
               const void* c1, const void* wp, const void* bp, void* out,
               int B, int h, int w, int C, int r, int nc,
               cudaStream_t stream) {
  seg_head_kernel<NCP><<<dim3(w, h, B), kThreads, 0, stream>>>(
      (const float*)P, (const float*)ay, (const float*)ax, (const float*)a1,
      (const float*)c1, (const float*)wp, (const float*)bp, (float*)out, h, w,
      C, r, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// P [B, h, w, 9, C] and wp [C, nc] in one dtype (bf16 or f32); ay, ax [r, 9],
// a1, c1 [C], bp [nc] f32; out [B, h·r, w·r, nc] in P's dtype.
extern "C" int seg_head_launch(const void* P, const void* ay, const void* ax,
                               const void* a1, const void* c1, const void* wp,
                               const void* bp, void* out, int B, int h, int w,
                               int C, int r, int nc, int is_bf16,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    seg_mma::Params prm{(const seg_mma::bf16*)P, (const float*)ay,
                        (const float*)ax, (const float*)a1, (const float*)c1,
                        (const seg_mma::bf16*)wp, (const float*)bp, nullptr,
                        0u, 1.f, (seg_mma::bf16*)out, h, w, C, r, nc};
    return (int)seg_mma::launch<false>(prm, B, s);
  }
  if (r < 1 || r > kRMax || C % kCS != 0 || nc < 1 || nc > 32)
    return (int)cudaErrorInvalidValue;
  switch ((nc + 7) / 8) {
    case 1: return launch_f32<8>(P, ay, ax, a1, c1, wp, bp, out, B, h, w, C, r, nc, s);
    case 2: return launch_f32<16>(P, ay, ax, a1, c1, wp, bp, out, B, h, w, C, r, nc, s);
    case 3: return launch_f32<24>(P, ay, ax, a1, c1, wp, bp, out, B, h, w, C, r, nc, s);
    default: return launch_f32<32>(P, ay, ax, a1, c1, wp, bp, out, B, h, w, C, r, nc, s);
  }
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
