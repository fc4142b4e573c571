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
//  1. dq: per 64-row query tile, K/V streamed through shared memory. Pass 1
//     is the forward's online softmax: the row max m, the row sum l and the
//     f32 output o, whence delta = dO·o/l (equal to rowsum(P∘dP), one pass
//     fewer). Pass 2 recomputes P and dP per key and accumulates dq. It
//     also writes (m, l, delta) per row for kernel 2.
//  2. dk/dv: per 64-key tile and split of the query rows (q and dO tiles
//     streamed through shared memory); writes f32 partial dk/dv for that
//     split. Splitting N gives the card enough blocks at MiT stage 1, where
//     G = 8 and M = 512 leave only 64 key tiles.
//  3. attn_bwd_reduce: sums the splits' partials in split order.
//
// Rounding follows the TPU kernel: in bf16 mode the matmul operands are
// bf16 (q, k, v, dO as given; dS rounded before dq and dk, P rounded before
// dv), every sum is f32, dq is stored in q's dtype and dk/dv in f32.
//
// Bound on the H100: the five products of the TPU kernel are 10·N·M·D flops
// per head-group (166 GFLOP over the 8 MiT-B0 attention layers at B=8
// 512×1024), 0.168 ms at the bf16 tensor-core peak; the bytes (q, dO, dq at
// N×D, k, v, dk, dv at M×D) are a few tens of MB. This decomposition does
// nine products (pass 1 two, pass 2 three, kernel 2 four: 300 GFLOP,
// 0.30 ms at the peak) and one exponential per score in each of pass 1,
// pass 2 and kernel 2: 3 × 520 M on the special-function unit (about
// 3.9e12 ex2/s) is 0.40 ms, its floor (saving the forward's log-sum-exp
// would leave two exponentials and seven products). Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py): 1.1–1.2 ms of device time per step
// in bf16, 3× that floor; the first version (CUDA cores, f32 arithmetic) took
// 13.2 ms on the same bf16 inputs.
//
// bf16 (attn_bwd_dq_mma, attn_bwd_dkdv_mma): every product on the tensor
// cores with mma.sync m16n8k16, 4 warps × 16 rows per block, operands by
// ldmatrix from padded tiles filled by a 3-deep cp.async ring.
//  1. Q and dO fragments stay in registers. Pass 1 is the forward's tile
//     body (attention_mma.cuh). Pass 2, per 16 keys: S = Q·Kᵀ and
//     dP = dO·Vᵀ, P = 2^(S·c − lse) with c = scale·log2 e and
//     lse = m + log2 l, dS rounded to bf16 in registers as the A operand of
//     dq += dS·K (K by ldmatrix.trans). m is kept in units of S·c.
//  2. K and V fragments stay in registers; Q, dO and the split's stats
//     stream through the ring (the stats as lse and delta, +∞ past the
//     split so P = 0 there). Per 16 queries: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, Pᵀ and
//     dSᵀ as above, dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q (ldmatrix.trans).
// f32 (attn_bwd_dq, attn_bwd_dkdv): the first version on the CUDA cores,
// one thread per query row (1) or key row (2), all f32: f32 on the tensor
// cores would be TF32, which the f32 parity checks do not allow.
//
// Layout: q, dO, dq [G, N, D]; k, v [G, M, D]; all contiguous; D ∈ {32, 64}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int kTQ = 64;  // query rows per block (kernel 1) / per tile (2)
constexpr int kTK = 64;  // key rows per tile (kernel 1) / per block (2)
constexpr int kKC = 16;  // keys scored per step of the online softmax

__device__ __forceinline__ float to_f32(float x) { return x; }
// The value a matmul operand of the TPU kernel takes (f32 in f32 mode).
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

namespace am = attn_mma;

template <int D>
struct DqSmem {
  am::Tile<D> q, dout;
  am::Tile<D> k[am::kStages], v[am::kStages];
};

template <int D>
__global__ void __launch_bounds__(am::kThreads)
    attn_bwd_dq_mma(const am::bf16* __restrict__ q,
                    const am::bf16* __restrict__ k,
                    const am::bf16* __restrict__ v,
                    const am::bf16* __restrict__ dout,
                    am::bf16* __restrict__ dq, float* __restrict__ stats,
                    int n, int m, float scale, float c) {
  extern __shared__ __align__(16) unsigned char smem[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem);
  const int g = blockIdx.y, row0 = blockIdx.x * kTQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tg = lane % 4;
  const size_t qoff = ((size_t)g * n + row0) * D;
  am::load_tile<D>(sm.q, q + qoff, min(kTQ, n - row0));
  am::load_tile<D>(sm.dout, dout + qoff, min(kTQ, n - row0));
  am::cp_async_commit();
  const am::bf16* kg = k + (size_t)g * m * D;
  const am::bf16* vg = v + (size_t)g * m * D;

  // Pass 1: the forward's online softmax (row max, row sum, f32 output).
  // One 16-row m-tile per warp: softmax_tile's arrays have an m-tile index.
  uint32_t qf[1][D / 16][4], df[D / 16][4];
  float mx[1][2] = {{-INFINITY, -INFINITY}}, l[1][2] = {},
        o[1][D / 8][4] = {};
  am::stream_tiles<D>(sm.k, sm.v, kg, vg, m, [&](int stage, int t0) {
    if (t0 == 0) {  // the Q and dO tiles landed with the first K/V tile
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        am::ldsm_x4(qf[0][kc], am::a_ptr(sm.q, 16 * warp, 16 * kc, lane));
        am::ldsm_x4(df[kc], am::a_ptr(sm.dout, 16 * warp, 16 * kc, lane));
      }
    }
    am::softmax_tile<D, 1>(qf, sm.k[stage], sm.v[stage], t0, m, c, lane, mx, l,
                           o);
  });

  // delta = rowsum(dO∘o)/l: dO's A fragments hold the same (row, column)
  // pairs as o's accumulators (a0/a1 ↔ o[2kc], a2/a3 ↔ o[2kc + 1]).
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    float2 d[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = am::unpack_bf16(df[kc][r]);
    const float(&o0)[4] = o[0][2 * kc], (&o1)[4] = o[0][2 * kc + 1];
    part[0] += d[0].x * o0[0] + d[0].y * o0[1] + d[2].x * o1[0] + d[2].y * o1[1];
    part[1] += d[1].x * o0[2] + d[1].y * o0[3] + d[3].x * o1[2] + d[3].y * o1[3];
  }
  float delta[2], lse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[0][h] = am::quad_sum(l[0][h]);
    delta[h] = am::quad_sum(part[h]) / l[0][h];
    lse[h] = mx[0][h] + log2f(l[0][h]);
  }

  // Pass 2, 16 keys at a time: P and dP, dq += dS·K.
  float acc[D / 8][4] = {};
  am::stream_tiles<D>(sm.k, sm.v, kg, vg, m, [&](int stage, int t0) {
    const am::Tile<D>& ks = sm.k[stage];
    const am::Tile<D>& vs = sm.v[stage];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t0 + 16 * j >= m) break;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b[4];
        am::ldsm_x4(b, am::b_ptr(ks, 16 * j, 16 * kc, lane));
        am::mma(s[0], qf[0][kc], b[0], b[1]);
        am::mma(s[1], qf[0][kc], b[2], b[3]);
        am::ldsm_x4(b, am::b_ptr(vs, 16 * j, 16 * kc, lane));
        am::mma(dp[0], df[kc], b[0], b[1]);
        am::mma(dp[1], df[kc], b[2], b[3]);
      }
      uint32_t da[4];  // dS as the A fragment of these 16 keys
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 16 * j + 8 * i + 2 * tg + (e & 1);
          const float p =
              key < m ? am::ex2(fmaf(s[i][e], c, -lse[e / 2])) : 0.f;
          ds[e] = p * (dp[i][e] - delta[e / 2]) * scale;
        }
        da[2 * i] = am::pack_bf16(ds[0], ds[1]);
        da[2 * i + 1] = am::pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t b[4];
        am::ldsm_x4_t(b, am::a_ptr(ks, 16 * j, 16 * p, lane));
        am::mma(acc[2 * p], da, b[0], b[1]);
        am::mma(acc[2 * p + 1], da, b[2], b[3]);
      }
    }
  });

  const size_t gn = (size_t)gridDim.y * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= n) continue;
    const size_t r = (size_t)g * n + row;
    am::bf16* out = dq + r * D + 2 * tg;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    if (tg == 0) {
      stats[r] = mx[0][h];
      stats[gn + r] = l[0][h];
      stats[2 * gn + r] = delta[h];
    }
  }
}

template <int D>
struct DkdvSmem {
  am::Tile<D> k, v;
  am::Tile<D> q[am::kStages], dout[am::kStages];
  float lse[am::kStages][kTQ], delta[am::kStages][kTQ];
};

template <int D>
__global__ void __launch_bounds__(am::kThreads)
    attn_bwd_dkdv_mma(const am::bf16* __restrict__ q,
                      const am::bf16* __restrict__ k,
                      const am::bf16* __restrict__ v,
                      const am::bf16* __restrict__ dout,
                      const float* __restrict__ stats, float* __restrict__ pk,
                      float* __restrict__ pv, int n, int m, int split_rows,
                      float scale, float c) {
  extern __shared__ __align__(16) unsigned char smem[];
  DkdvSmem<D>& sm = *reinterpret_cast<DkdvSmem<D>*>(smem);
  const int G = gridDim.z, g = blockIdx.z, split = blockIdx.y;
  const int key0 = blockIdx.x * kTK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tg = lane % 4;
  const size_t koff = ((size_t)g * m + key0) * D;
  am::load_tile<D>(sm.k, k + koff, min(kTK, m - key0));
  am::load_tile<D>(sm.v, v + koff, min(kTK, m - key0));
  am::cp_async_commit();

  const int i0 = split * split_rows, rows = min(n, i0 + split_rows) - i0;
  const size_t gn = (size_t)G * n;
  const float* st = stats + (size_t)g * n + i0;
  // The stats of query tile t, fetched into registers by threads 0–63 one
  // tile ahead and staged in shared memory as lse = m + log2 l (+∞ past the
  // split, so P = 0 there) and delta.
  auto fetch = [&](int t, float (&r)[3]) {
    const int i = t * kTQ + threadIdx.x;
    const bool ok = threadIdx.x < kTQ && i < rows;
    r[0] = ok ? st[i] : INFINITY;
    r[1] = ok ? st[gn + i] : 1.f;
    r[2] = ok ? st[2 * gn + i] : 0.f;
  };
  auto stage_stats = [&](int slot, const float (&r)[3]) {
    if (threadIdx.x < kTQ) {
      sm.lse[slot][threadIdx.x] = r[0] + log2f(r[1]);
      sm.delta[slot][threadIdx.x] = r[2];
    }
  };
  float next[3];
  fetch(0, next);
  stage_stats(0, next);
  fetch(1, next);

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const size_t qoff = ((size_t)g * n + i0) * D;
  am::stream_tiles<D>(sm.q, sm.dout, q + qoff, dout + qoff, rows,
                      [&](int stage, int t0) {
    const int t = t0 / kTQ;
    if (t == 0) {  // the K and V tiles landed with the first Q/dO tile
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        am::ldsm_x4(kf[kc], am::a_ptr(sm.k, 16 * warp, 16 * kc, lane));
        am::ldsm_x4(vf[kc], am::a_ptr(sm.v, 16 * warp, 16 * kc, lane));
      }
    }
    // Tile t + 1's stats go to their slot, whose last reader (tile
    // t + 1 − kStages) is done; the barrier before tile t + 1 publishes them.
    stage_stats((t + 1) % am::kStages, next);
    fetch(t + 2, next);

    const am::Tile<D>& qs = sm.q[stage];
    const am::Tile<D>& dos = sm.dout[stage];
    const float* lses = sm.lse[stage];
    const float* deltas = sm.delta[stage];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t0 + 16 * j >= rows) break;
      float s[2][4] = {}, dp[2][4] = {};  // rows: keys; columns: queries
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b[4];
        am::ldsm_x4(b, am::b_ptr(qs, 16 * j, 16 * kc, lane));
        am::mma(s[0], kf[kc], b[0], b[1]);
        am::mma(s[1], kf[kc], b[2], b[3]);
        am::ldsm_x4(b, am::b_ptr(dos, 16 * j, 16 * kc, lane));
        am::mma(dp[0], vf[kc], b[0], b[1]);
        am::mma(dp[1], vf[kc], b[2], b[3]);
      }
      uint32_t pa[4], da[4];  // Pᵀ and dSᵀ as A fragments of these queries
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 16 * j + 8 * i + 2 * tg;
        const float2 ls = *reinterpret_cast<const float2*>(lses + col);
        const float2 dl = *reinterpret_cast<const float2*>(deltas + col);
        const float p0 = am::ex2(fmaf(s[i][0], c, -ls.x));
        const float p1 = am::ex2(fmaf(s[i][1], c, -ls.y));
        const float p2 = am::ex2(fmaf(s[i][2], c, -ls.x));
        const float p3 = am::ex2(fmaf(s[i][3], c, -ls.y));
        pa[2 * i] = am::pack_bf16(p0, p1);
        pa[2 * i + 1] = am::pack_bf16(p2, p3);
        da[2 * i] = am::pack_bf16(p0 * (dp[i][0] - dl.x) * scale,
                                  p1 * (dp[i][1] - dl.y) * scale);
        da[2 * i + 1] = am::pack_bf16(p2 * (dp[i][2] - dl.x) * scale,
                                      p3 * (dp[i][3] - dl.y) * scale);
      }
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t b[4];
        am::ldsm_x4_t(b, am::a_ptr(dos, 16 * j, 16 * p, lane));
        am::mma(dv[2 * p], pa, b[0], b[1]);
        am::mma(dv[2 * p + 1], pa, b[2], b[3]);
        am::ldsm_x4_t(b, am::a_ptr(qs, 16 * j, 16 * p, lane));
        am::mma(dk[2 * p], da, b[0], b[1]);
        am::mma(dk[2 * p + 1], da, b[2], b[3]);
      }
    }
  });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 16 * warp + lane / 4 + 8 * h;
    if (key >= m) continue;
    const size_t off =
        (((size_t)split * G + g) * m + key) * D + 2 * tg;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(pk + off + 8 * j) =
          make_float2(dk[j][2 * h], dk[j][2 * h + 1]);
      *reinterpret_cast<float2*>(pv + off + 8 * j) =
          make_float2(dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

int launch_reduce(float* pk, float* pv, float* dk, float* dv, size_t count,
                  int splits, cudaStream_t stream) {
  const size_t want = (count + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  attn_bwd_reduce<<<blocks, 256, 0, stream>>>(pk, pv, dk, dv, count, splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               void* dq, float* stats, float* pk, float* pv, float* dk,
               float* dv, int g, int n, int m, int split_rows, float scale,
               cudaStream_t stream) {
  const int splits = (n + split_rows - 1) / split_rows;
  attn_bwd_dq<float, D><<<dim3((n + kTQ - 1) / kTQ, g), kTQ, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (float*)dq, stats, n, m, scale);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd_dkdv<float, D><<<dim3((m + kTK - 1) / kTK, splits, g), kTK, 0,
                            stream>>>((const float*)q, (const float*)k,
                                      (const float*)v, (const float*)dout,
                                      stats, pk, pv, n, m, split_rows, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_reduce(pk, pv, dk, dv, (size_t)g * m * D, splits, stream);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, float* stats, float* pk, float* pv, float* dk,
               float* dv, int g, int n, int m, int split_rows, float scale,
               cudaStream_t stream) {
  const int splits = (n + split_rows - 1) / split_rows;
  const float c = scale * 1.4426950408889634f;
  const size_t smem1 = sizeof(DqSmem<D>), smem2 = sizeof(DkdvSmem<D>);
  int rc = (int)am::allow_smem(attn_bwd_dq_mma<D>, smem1);
  if (rc) return rc;
  rc = (int)am::allow_smem(attn_bwd_dkdv_mma<D>, smem2);
  if (rc) return rc;
  attn_bwd_dq_mma<D><<<dim3((n + kTQ - 1) / kTQ, g), am::kThreads, smem1,
                       stream>>>((const am::bf16*)q, (const am::bf16*)k,
                                 (const am::bf16*)v, (const am::bf16*)dout,
                                 (am::bf16*)dq, stats, n, m, scale, c);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  attn_bwd_dkdv_mma<D><<<dim3((m + kTK - 1) / kTK, splits, g), am::kThreads,
                         smem2, stream>>>(
      (const am::bf16*)q, (const am::bf16*)k, (const am::bf16*)v,
      (const am::bf16*)dout, stats, pk, pv, n, m, split_rows, scale, c);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_reduce(pk, pv, dk, dv, (size_t)g * m * D, splits, stream);
}

}  // namespace

// Scratch from the caller: stats [3, G, N] f32; pk, pv [splits, G, M, D] f32
// with splits = ceil(N / split_rows), split_rows a multiple of 64. bf16 runs
// the tensor-core kernels, f32 the CUDA-core ones.
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
  if (d != 32 && d != 64) return (int)cudaErrorInvalidValue;
  auto launch = is_bf16 ? (d == 32 ? launch_mma<32> : launch_mma<64>)
                        : (d == 32 ? launch_f32<32> : launch_f32<64>);
  return launch(q, k, v, dout, dq, st, a, b, ok, ov, g, n, m, split_rows,
                scale, s);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
