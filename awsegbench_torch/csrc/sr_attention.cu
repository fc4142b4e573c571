// Spatial-reduction attention forward: out = softmax(q·kᵀ·scale)·v.
//
// Replaces the TPU kernel awsegbench/ops/attention.py::_attn_kernel
// (pallas_call in _sr_attention_forward). That kernel held the whole
// [TQ, M] score tile and the whole K/V block in VMEM (M ≤ 4096). A Hopper
// block has at most 227 KB of shared memory and far fewer registers, so
// both designs here stream K/V through shared memory in 64-row tiles with
// an online softmax (running max, running sum, rescaled f32 accumulator);
// shared memory is bounded for every M and the scores never leave
// registers.
//
// Layout: q [G, N, D], k/v [G, M, D], out [G, N, D], all contiguous, in
// bf16 or f32 (out in q's dtype); D ∈ {32, 64}.
//
// Bound on the H100 at the MiT-B0 shapes (D = 32, M = 512; 8 launches per
// step, 520 M scores): the products are 4·N·M·D flops, 66.6 GFLOP per step,
// 0.067 ms at the bf16 tensor-core peak; one exponential per score on the
// special-function unit (16 ex2 per SM per clock, about 3.9e12/s) is
// 0.133 ms. At D = 32 the exponential, not the matmul, is the floor.
//
// bf16: sr_attention_mma, on the tensor cores. A block of 4 warps takes 128
// query rows; each warp keeps the Q fragments of two 16-row m-tiles in
// registers, and every K or V fragment it loads serves both (half the
// ldmatrix and L2 traffic of one m-tile per warp). K and V stream through
// a 3-deep cp.async ring of padded 64-key tiles. Per tile: S = Q·Kᵀ with
// mma.sync m16n8k16 (K by ldmatrix), the online softmax in f32 registers
// (row max across the lane quad, one ex2 per score with scale·log2 e
// folded into one FMA), P rounded to bf16 in registers as the A operand of
// P·V (V by ldmatrix.trans). Numerics follow _attn_kernel: bf16 operands,
// f32 scores and sums, l summed from the unrounded p, P rounded to bf16
// before the AV product, the output divided by l once. Keys past M score
// −∞; rows past N are not stored. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py): 0.35 ms of device time per step, 5× the matmul bound
// and 2.6× the exponential floor; the first version below took 3.4 ms.
//
// f32: sr_attention_kernel, the first version, on the CUDA cores (one
// thread per query row, K/V tiles broadcast from shared memory, all f32):
// f32 on the tensor cores would be TF32, which the f32 parity checks
// (1e-5) do not allow.
//
// Grid: (ceil(N/128), G), 128 threads (bf16); (ceil(N/64), G), 64 (f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int kTQ = 64;  // query rows per block (f32)
constexpr int kTK = 64;  // key/value rows per shared tile (f32)
constexpr int kKC = 16;  // keys scored per step of the online softmax (f32)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

namespace am = attn_mma;

constexpr int kMT = 2;                    // 16-row m-tiles per warp
constexpr int kBlockRows = 4 * 16 * kMT;  // query rows per block

template <int D>
struct FwdSmem {
  am::Tile<D, kBlockRows> q;
  am::Tile<D> k[am::kStages];
  am::Tile<D> v[am::kStages];
};

template <int D>
__global__ void __launch_bounds__(am::kThreads)
    sr_attention_mma(const am::bf16* __restrict__ q,
                     const am::bf16* __restrict__ k,
                     const am::bf16* __restrict__ v, am::bf16* __restrict__ out,
                     int n, int m, float c) {
  extern __shared__ __align__(16) unsigned char smem[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(smem);
  const int g = blockIdx.y, row0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  am::load_tile<D, kBlockRows>(sm.q, q + ((size_t)g * n + row0) * D,
                               min(kBlockRows, n - row0));
  am::cp_async_commit();

  uint32_t qf[kMT][D / 16][4];
  float mx[kMT][2], l[kMT][2] = {}, o[kMT][D / 8][4] = {};
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) mx[mt][0] = mx[mt][1] = -INFINITY;
  am::stream_tiles<D>(
      sm.k, sm.v, k + (size_t)g * m * D, v + (size_t)g * m * D, m,
      [&](int stage, int t0) {
        if (t0 == 0) {  // the Q tile landed with the first K/V tile
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc)
              am::ldsm_x4(qf[mt][kc], am::a_ptr(sm.q, 16 * (kMT * warp + mt),
                                                16 * kc, lane));
        }
        am::softmax_tile<D, kMT>(qf, sm.k[stage], sm.v[stage], t0, m, c, lane,
                                 mx, l, o);
      });

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lsum = am::quad_sum(l[mt][h]);
      const int row = row0 + 16 * (kMT * warp + mt) + lane / 4 + 8 * h;
      if (row < n) {
        am::bf16* orow = out + ((size_t)g * n + row) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[mt][j][2 * h] / lsum,
                                    o[mt][j][2 * h + 1] / lsum);
      }
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int g,
               int n, int m, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(FwdSmem<D>);
  cudaError_t rc = am::allow_smem(sr_attention_mma<D>, smem);
  if (rc) return (int)rc;
  sr_attention_mma<D><<<dim3((n + kBlockRows - 1) / kBlockRows, g),
                        am::kThreads, smem,
                        stream>>>((const am::bf16*)q, (const am::bf16*)k,
                                  (const am::bf16*)v, (am::bf16*)out, n, m,
                                  scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int g,
               int n, int m, int d, float scale, cudaStream_t stream) {
  const dim3 grid((n + kTQ - 1) / kTQ, g);
  if (d == 32) {
    sr_attention_kernel<float, 32><<<grid, kTQ, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, n, m,
        scale);
  } else if (d == 64) {
    sr_attention_kernel<float, 64><<<grid, kTQ, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, n, m,
        scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 runs sr_attention_mma, f32 sr_attention_kernel.
extern "C" int sr_attention_launch(const void* q, const void* k, const void* v,
                                   void* out, int g, int n, int m, int d,
                                   int is_bf16, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) return launch_f32(q, k, v, out, g, n, m, d, scale, s);
  if (d == 32) return launch_mma<32>(q, k, v, out, g, n, m, scale, s);
  if (d == 64) return launch_mma<64>(q, k, v, out, g, n, m, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
