// Train-mode BatchNorm with its epilogue (K13) and its gradient (K14):
//
//   mean = Σx / n,  var = max(Σx² / n − mean², 0),  r = rsqrt(var + eps)
//   y    = act((x − mean) · (r · weight) + bias [+ residual])
//
// with n the element count of a channel (the global batch's, under a
// data-parallel mesh), act the identity or ReLU. Every BN of the train
// step calls it (models/heads.py BatchNorm in train mode): DeepLabV3+'s
// ResNet-50, ASPP, decoder and depth head, and SegFormer's depth head
// after K9. It replaces no Pallas kernel: on the TPU, XLA fused the BN
// into the convolutions around it. Eager PyTorch ran it as a cast to f32,
// two f32 means, three broadcast f32 passes, a cast back, the residual add
// and the ReLU, and autograd's backward about twice as many f32 passes; it
// kept an f32 copy of every activation for the backward.
//
// Semantics are Flax nn.BatchNorm's train mode: f32 statistics by the fast
// variance E[x²] − E[x]², clamped at 0 (not Welford, not the unbiased
// variance), the normalisation in f32 in the order (x − mean)·mul + bias
// with mul = r·weight, then + residual, then ReLU, rounded once to x's
// dtype. The gradient is autodiff's through that formula: with
// x̂ = (x − mean)·r and g' the upstream gradient masked where y ≤ 0 (ReLU),
//
//   dbias = Σg',  dweight = Σg'·x̂,  dresidual = g',
//   dx    = weight · r · (g' − Σg'/n − x̂ · Σg'x̂/n),
//
// the last term dropped in a channel whose variance was clamped, as the
// clamp's gradient gives.
//
// Passes, each an entry point's phase so that a data-parallel mesh can sum
// the per-channel sums over the ranks between them (outside the kernels):
//
//   K13 phase 1  read x; per channel (Σx, Σx²) into sums[2, C]
//       phase 2  read x [and the residual]; write y and stats[4, C]
//                (mean, var, r, 1 where var was not clamped else 0)
//   K14 phase 1  read dy, y (ReLU only) and x; per channel (Σg'x̂, Σg') into
//                sums[2, C] and (dweight, dbias) into dwb[2, C] in x's dtype
//       phase 2  read them again; write dx [and dresidual = g']
//
// Phase 1 is a block-partial reduction into `work` ([chunks, 2, C] f32,
// `bn_train_workspace` values) and a finishing step that sums the chunks in
// a fixed order: two runs give bit-identical statistics (no float atomics).
//
// Layout, x's dtype bf16 or f32 everywhere (weight and bias too; the
// statistics and sums f32): x, residual, y, dy, dx and dresidual dense in
// one layout, [outer, C, inner] — channels innermost (inner 1: the
// channels-last activations of the NHWC models, and ASPP's pooled
// [N, C, 1, 1]) or channel-major (a contiguous NCHW tensor: ASPP's
// projection after its concatenation).
//
// Design: bound by bytes; the least traffic is two passes each way, about
// 6 bytes an element forward (2 more with a residual) and 14 backward
// (2 more for dresidual) in bf16. Channels innermost with C % 8 == 0,
// C ≤ 2048 and 16-byte aligned pointers (every cell's BN but ASPP's
// projection): one 16-byte vector of 8 channels a thread, every load and
// store 16 bytes (two for f32), as K12. The reduction block holds 8
// channel groups (64 channels) × 32 rows, four vectors in flight a thread;
// its grid is (C / 64 channel slices) × chunks of rows, sized from the
// shape: about 8 blocks an SM, each thread walking at least 8 rows, at
// most 256 chunks. The apply and gradient passes stride over the tensor in
// one wave from the occupancy API, each thread's 8 channels fixed, their
// per-channel constants in registers. Anything else takes scalar kernels
// that find each element's channel by division.
//
// Bound on the H100 at the stem, bf16 [8, 64, 256, 512] with ReLU: K13
// moves 403 MB (0.120 ms at 3.35 TB/s), K14 940 MB (0.281 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSliceGroups = 8;   // channel groups a reduction block holds
constexpr int kMaxGroups = 256;   // channel groups an apply block holds
constexpr int kMinRows = 8;       // rows a reduction thread walks at least
constexpr int kMaxChunks = 256;   // chunks of rows of a reduction
constexpr int kUnroll = 4;        // vectors in flight a reduction thread
constexpr int kLanes = 8;         // lanes of one column of the finishing step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// 8 elements, widened to f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// ---------------------------------------------------------------- phase 1

// K13's sums: a += x, b += x·x.
template <typename T>
struct XSums {
  const T* x;

  __device__ __forceinline__ void prologue(int, int) {}
  __device__ __forceinline__ void vec(int64_t e, float* a, float* b) const {
    float v[8];
    load8(x + e, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] += v[i];
      b[i] += __fmul_rn(v[i], v[i]);
    }
  }
  __device__ __forceinline__ void one(int64_t e, float& a, float& b) const {
    const float v = to_f(x[e]);
    a += v;
    b += __fmul_rn(v, v);
  }
};

// K14's sums: a += g'·x̂, b += g', g' = dy masked where y ≤ 0 (y null: no
// ReLU).
template <typename T>
struct GradSums {
  const T* dy;
  const T* y;
  const T* x;
  const float* stats;
  int c;
  float m[8], r[8];

  __device__ __forceinline__ void prologue(int c0, int k) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < k) {
        m[i] = stats[c0 + i];
        r[i] = stats[2 * c + c0 + i];
      }
  }
  __device__ __forceinline__ void vec(int64_t e, float* a, float* b) const {
    float g[8], xv[8];
    load8(dy + e, g);
    load8(x + e, xv);
    if (y != nullptr) {
      float yv[8];
      load8(y + e, yv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (yv[i] <= 0.f) g[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] += __fmul_rn(g[i], __fmul_rn(xv[i] - m[i], r[i]));
      b[i] += g[i];
    }
  }
  __device__ __forceinline__ void one(int64_t e, float& a, float& b) const {
    float g = to_f(dy[e]);
    if (y != nullptr && to_f(y[e]) <= 0.f) g = 0.f;
    a += __fmul_rn(g, __fmul_rn(to_f(x[e]) - m[0], r[0]));
    b += g;
  }
};

// Channels innermost, C = 8·groups. Block (slice, chunk): its threads are
// slice_groups channel groups × rows_per_iter rows; the chunk's rows are
// [chunk·chunk_rows, +chunk_rows). Writes the block's partial sums of the
// slice's channels to part[chunk][2][C].
template <typename Op>
__global__ void __launch_bounds__(kThreads)
    reduce_nhwc8(Op op, int64_t rows, int c, int slice_groups,
                 int64_t chunk_rows, float* __restrict__ part) {
  __shared__ float sm[2][kThreads * 8];
  const int groups = c / 8;
  const int rows_per_iter = blockDim.x / slice_groups;
  const int gl = threadIdx.x % slice_groups, rl = threadIdx.x / slice_groups;
  const int g = blockIdx.x * slice_groups + gl;
  float a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = b[i] = 0.f;
  if (g < groups && rl < rows_per_iter) {
    op.prologue(g * 8, 8);
    const int64_t r0 = (int64_t)blockIdx.y * chunk_rows;
    const int64_t r1 = r0 + chunk_rows < rows ? r0 + chunk_rows : rows;
    const int64_t step = rows_per_iter;
    int64_t r = r0 + rl;
    for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        op.vec((r + u * step) * c + g * 8, a, b);
    }
    for (; r < r1; r += step) op.vec(r * c + g * 8, a, b);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sm[0][threadIdx.x * 8 + i] = a[i];
    sm[1][threadIdx.x * 8 + i] = b[i];
  }
  __syncthreads();
  // column (s, col) of the slice: the sum over its rows, in row order
  const int width = slice_groups * 8;
  for (int t = threadIdx.x; t < 2 * width; t += blockDim.x) {
    const int s = t / width, col = t % width;
    float acc = 0.f;
    for (int q = 0; q < rows_per_iter; ++q)
      acc += sm[s][q * width + col];
    const int ch = blockIdx.x * width + col;
    if (ch < c) part[((int64_t)blockIdx.y * 2 + s) * c + ch] = acc;
  }
}

// Any dense layout: block (channel, chunk) sums the chunk's elements of its
// channel, element m of a channel at ((m / inner)·C + ch)·inner + m % inner.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
    reduce_scalar(Op op, int64_t per_channel, int c, int64_t inner,
                  int64_t chunk_len, float* __restrict__ part) {
  __shared__ float sm[2][kThreads];
  const int ch = blockIdx.x;
  op.prologue(ch, 1);
  const int64_t m0 = (int64_t)blockIdx.y * chunk_len;
  const int64_t m1 = m0 + chunk_len < per_channel ? m0 + chunk_len
                                                  : per_channel;
  float a = 0.f, b = 0.f;
  for (int64_t m = m0 + threadIdx.x; m < m1; m += blockDim.x)
    op.one(((m / inner) * c + ch) * inner + m % inner, a, b);
  sm[0][threadIdx.x] = a;
  sm[1][threadIdx.x] = b;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      sm[0][threadIdx.x] += sm[0][threadIdx.x + half];
      sm[1][threadIdx.x] += sm[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x < 2)
    part[((int64_t)blockIdx.y * 2 + threadIdx.x) * c + ch] =
        sm[threadIdx.x][0];
}

// The finishing step: column j of [2·C] summed over the chunks, lane l
// taking chunks l, l + kLanes, …, then the lanes in order; also into out
// (x's dtype) where given.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finish(const float* __restrict__ part, int64_t chunks, int c,
           float* __restrict__ sums, T* __restrict__ out) {
  __shared__ float sm[kLanes][kThreads / kLanes];
  const int cols = kThreads / kLanes;
  const int col = threadIdx.x % cols, lane = threadIdx.x / cols;
  const int64_t j = (int64_t)blockIdx.x * cols + col;
  float acc = 0.f;
  if (j < 2 * c) {
#pragma unroll 4
    for (int64_t k = lane; k < chunks; k += kLanes)
      acc += part[k * 2 * c + j];
  }
  sm[lane][col] = acc;
  __syncthreads();
  if (lane == 0 && j < 2 * c) {
    float s = 0.f;
    for (int l = 0; l < kLanes; ++l) s += sm[l][col];
    sums[j] = s;
    if (out != nullptr) from_f(s, out + j);
  }
}

// ---------------------------------------------------------------- phase 2

// Channel ch's forward constants from the sums: mean, mul = r·weight,
// bias; st (where given) gets mean, var, r and the clamp flag.
template <typename T>
struct FwdChannels {
  const float* sums;
  const T* weight;
  const T* bias;
  float eps, n;
  int c;

  __device__ __forceinline__ void get(int ch, float& m, float& k, float& b,
                                      float* st) const {
    const float mean = sums[ch] / n;
    const float d = sums[c + ch] / n - __fmul_rn(mean, mean);
    const float var = d < 0.f ? 0.f : d;
    const float r = rsqrtf(var + eps);
    m = mean;
    k = __fmul_rn(r, to_f(weight[ch]));
    b = to_f(bias[ch]);
    if (st != nullptr) {
      st[ch] = mean;
      st[c + ch] = var;
      st[2 * c + ch] = r;
      st[3 * c + ch] = d >= 0.f ? 1.f : 0.f;
    }
  }
};

__device__ __forceinline__ float forward_elem(float x, float m, float k,
                                              float b, float res, bool relu) {
  const float z = __fadd_rn(__fmul_rn(x - m, k), b) + res;
  return relu && z < 0.f ? 0.f : z;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_nhwc8(const T* __restrict__ x, const T* __restrict__ res,
                T* __restrict__ y, FwdChannels<T> ch, float* __restrict__ st,
                int64_t n_vec, int groups, bool relu) {
  const int c0 = (int)(threadIdx.x % groups) * 8;
  float m[8], k[8], b[8];
  float* write = blockIdx.x == 0 && threadIdx.x < groups ? st : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) ch.get(c0 + i, m[i], k[i], b[i], write);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    float xv[8], rv[8], out[8];
    load8(x + v * 8, xv);
    if (res != nullptr) load8(res + v * 8, rv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = forward_elem(xv[i], m[i], k[i], b[i],
                            res != nullptr ? rv[i] : 0.f, relu);
    store8(y + v * 8, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_scalar(const T* __restrict__ x, const T* __restrict__ res,
                 T* __restrict__ y, FwdChannels<T> ch, float* __restrict__ st,
                 int64_t n, int64_t inner, bool relu) {
  float m, k, b;
  if (blockIdx.x == 0)
    for (int t = threadIdx.x; t < ch.c; t += blockDim.x)
      ch.get(t, m, k, b, st);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    ch.get((int)((e / inner) % ch.c), m, k, b, nullptr);
    const float rv = res != nullptr ? to_f(res[e]) : 0.f;
    from_f(forward_elem(to_f(x[e]), m, k, b, rv, relu), y + e);
  }
}

// Channel ch's gradient constants: dx = a·g' + e·(x − mean) + f with
// a = weight·r, e = −a·r·Σg'x̂/n (0 where the variance was clamped),
// f = −a·Σg'/n.
template <typename T>
struct BwdChannels {
  const float* stats;
  const float* sums;
  const T* weight;
  float n;
  int c;

  __device__ __forceinline__ void get(int ch, float& m, float& a, float& e,
                                      float& f) const {
    const float r = stats[2 * c + ch];
    m = stats[ch];
    a = __fmul_rn(to_f(weight[ch]), r);
    e = stats[3 * c + ch] != 0.f ? -a * r * (sums[ch] / n) : 0.f;
    f = -a * (sums[c + ch] / n);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grad_nhwc8(const T* __restrict__ dy, const T* __restrict__ y,
               const T* __restrict__ x, T* __restrict__ dx,
               T* __restrict__ dres, BwdChannels<T> ch, int64_t n_vec,
               int groups) {
  const int c0 = (int)(threadIdx.x % groups) * 8;
  float m[8], a[8], e[8], f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ch.get(c0 + i, m[i], a[i], e[i], f[i]);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    float g[8], xv[8], out[8];
    load8(dy + v * 8, g);
    load8(x + v * 8, xv);
    if (y != nullptr) {
      float yv[8];
      load8(y + v * 8, yv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (yv[i] <= 0.f) g[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = fmaf(a[i], g[i], fmaf(e[i], xv[i] - m[i], f[i]));
    store8(dx + v * 8, out);
    if (dres != nullptr) store8(dres + v * 8, g);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grad_scalar(const T* __restrict__ dy, const T* __restrict__ y,
                const T* __restrict__ x, T* __restrict__ dx,
                T* __restrict__ dres, BwdChannels<T> ch, int64_t n,
                int64_t inner) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float m, a, e, f;
    ch.get((int)((i / inner) % ch.c), m, a, e, f);
    float g = to_f(dy[i]);
    if (y != nullptr && to_f(y[i]) <= 0.f) g = 0.f;
    from_f(fmaf(a, g, fmaf(e, to_f(x[i]) - m, f)), dx + i);
    if (dres != nullptr) from_f(g, dres + i);
  }
}

// ------------------------------------------------------------ the launches

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The reduction's geometry for [outer, C, inner]: the vector kernel's
// slices of channel groups and rows per iteration, or the scalar kernel's
// one channel a block; chunks of rows (elements) of each.
struct Plan {
  bool vec;
  int slice_groups, slices, threads;
  int64_t chunks, chunk_len;
};

bool vector_layout(int c, int64_t inner) {
  return inner == 1 && c % 8 == 0 && c / 8 <= kMaxGroups;
}

Plan plan(int64_t outer, int c, int64_t inner, bool vec) {
  Plan p;
  p.vec = vec;
  const int64_t wave = (int64_t)sm_count() * (2048 / kThreads);
  int64_t units, per_iter;   // rows (elements) of a channel, and per block
  if (vec) {
    const int groups = c / 8;
    p.slice_groups = groups < kSliceGroups ? groups : kSliceGroups;
    p.slices = (int)cdiv(groups, p.slice_groups);
    per_iter = kThreads / p.slice_groups;
    p.threads = (int)per_iter * p.slice_groups;
    units = outer;
  } else {
    p.slice_groups = 0;
    p.slices = c;
    per_iter = p.threads = kThreads;
    units = outer * inner;
  }
  int64_t k = cdiv(wave, p.slices);
  const int64_t by_len = units / (per_iter * kMinRows);
  if (k > by_len) k = by_len;
  if (k > kMaxChunks) k = kMaxChunks;
  if (k < 1) k = 1;
  p.chunk_len = cdiv(units, k);
  p.chunks = cdiv(units, p.chunk_len);
  return p;
}

template <typename Op, typename T>
int reduce(const Op& op, int64_t outer, int c, int64_t inner, bool vec,
           float* work, float* sums, T* out, cudaStream_t stream) {
  const Plan p = plan(outer, c, inner, vec);
  if (vec)
    reduce_nhwc8<Op><<<dim3(p.slices, (unsigned)p.chunks), p.threads, 0,
                       stream>>>(op, outer, c, p.slice_groups, p.chunk_len,
                                 work);
  else
    reduce_scalar<Op><<<dim3(c, (unsigned)p.chunks), kThreads, 0, stream>>>(
        op, outer * inner, c, inner, p.chunk_len, work);
  const int cols = kThreads / kLanes;
  finish<T><<<(unsigned)cdiv(2 * (int64_t)c, cols), kThreads, 0, stream>>>(
      work, p.chunks, c, sums, out);
  return (int)cudaGetLastError();
}

// Blocks of one wave of `kernel` at `threads` a block, at most `want`.
template <typename K>
int wave_blocks(K kernel, int threads, int64_t want) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int64_t wave = (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1);
  return (int)(want < wave ? want : wave);
}

template <typename T>
int forward(const void* x, const void* res, void* y, const void* weight,
            const void* bias, float* sums, float* stats, float* work,
            float eps, float count, int64_t outer, int c, int64_t inner,
            bool relu, int phases, cudaStream_t stream) {
  const int64_t n = outer * (int64_t)c * inner;
  const bool vec = vector_layout(c, inner) && aligned16(x) && aligned16(y)
                   && aligned16(res);
  const T* xp = (const T*)x;
  if (phases & 1) {
    const int rc = reduce(XSums<T>{xp}, outer, c, inner, vec, work, sums,
                          (T*)nullptr, stream);
    if (rc != 0) return rc;
  }
  if (phases & 2) {
    const FwdChannels<T> ch{sums, (const T*)weight, (const T*)bias, eps,
                            count, c};
    const T* rp = (const T*)res;
    T* yp = (T*)y;
    if (vec) {
      const int groups = c / 8;
      const int threads = groups * (kThreads / groups);
      const int64_t n_vec = n / 8;
      static int per_sm[kThreads + 1] = {0};
      if (per_sm[threads] == 0)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[threads], apply_nhwc8<T>, threads, 0);
      const int64_t want = cdiv(n_vec, threads);
      const int64_t wave = (int64_t)sm_count()
                           * (per_sm[threads] > 0 ? per_sm[threads] : 1);
      apply_nhwc8<T><<<(unsigned)(want < wave ? want : wave), threads, 0,
                       stream>>>(xp, rp, yp, ch, stats, n_vec, groups, relu);
    } else {
      static int blocks_cap = 0;
      if (blocks_cap == 0)
        blocks_cap = wave_blocks(apply_scalar<T>, kThreads, 1 << 30);
      const int64_t want = cdiv(n, kThreads);
      apply_scalar<T><<<(unsigned)(want < blocks_cap ? want : blocks_cap),
                        kThreads, 0, stream>>>(xp, rp, yp, ch, stats, n,
                                               inner, relu);
    }
  }
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* dy, const void* x, const void* y,
             const float* stats, const void* weight, void* dx, void* dres,
             float* sums, void* dwb, float* work, float count, int64_t outer,
             int c, int64_t inner, int phases, cudaStream_t stream) {
  const int64_t n = outer * (int64_t)c * inner;
  const bool vec = vector_layout(c, inner) && aligned16(dy) && aligned16(x)
                   && aligned16(y) && aligned16(dx) && aligned16(dres);
  const T* dyp = (const T*)dy;
  const T* xp = (const T*)x;
  const T* yp = (const T*)y;
  if (phases & 1) {
    GradSums<T> op;
    op.dy = dyp;
    op.y = yp;
    op.x = xp;
    op.stats = stats;
    op.c = c;
    const int rc = reduce(op, outer, c, inner, vec, work, sums, (T*)dwb,
                          stream);
    if (rc != 0) return rc;
  }
  if (phases & 2) {
    const BwdChannels<T> ch{stats, sums, (const T*)weight, count, c};
    T* dxp = (T*)dx;
    T* drp = (T*)dres;
    if (vec) {
      const int groups = c / 8;
      const int threads = groups * (kThreads / groups);
      const int64_t n_vec = n / 8;
      static int per_sm[kThreads + 1] = {0};
      if (per_sm[threads] == 0)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[threads], grad_nhwc8<T>, threads, 0);
      const int64_t want = cdiv(n_vec, threads);
      const int64_t wave = (int64_t)sm_count()
                           * (per_sm[threads] > 0 ? per_sm[threads] : 1);
      grad_nhwc8<T><<<(unsigned)(want < wave ? want : wave), threads, 0,
                      stream>>>(dyp, yp, xp, dxp, drp, ch, n_vec, groups);
    } else {
      static int blocks_cap = 0;
      if (blocks_cap == 0)
        blocks_cap = wave_blocks(grad_scalar<T>, kThreads, 1 << 30);
      const int64_t want = cdiv(n, kThreads);
      grad_scalar<T><<<(unsigned)(want < blocks_cap ? want : blocks_cap),
                       kThreads, 0, stream>>>(dyp, yp, xp, dxp, drp, ch, n,
                                              inner);
    }
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t outer, int c, int64_t inner, int phases) {
  return outer < 1 || c < 1 || inner < 1 || phases < 1 || phases > 3;
}

}  // namespace

// The f32 values of `work` a call on [outer, C, inner] needs (either
// kernel's plan).
extern "C" int64_t bn_train_workspace(int64_t outer, int c, int64_t inner) {
  if (bad_shape(outer, c, inner, 3)) return 0;
  int64_t k = plan(outer, c, inner, false).chunks;
  if (vector_layout(c, inner)) {
    const int64_t kv = plan(outer, c, inner, true).chunks;
    if (kv > k) k = kv;
  }
  return k * 2 * c;
}

// K13 on x [outer, C, inner] (residual and y alike; residual null for
// none): phase 1 writes sums [2, C] (Σx, Σx²), phase 2 reads them and
// writes y and stats [4, C]; phases 3 = both. count: a channel's elements
// over the mesh. Returns a CUDA error code.
extern "C" int bn_train_forward(const void* x, const void* res, void* y,
                                const void* weight, const void* bias,
                                float* sums, float* stats, float* work,
                                float eps, float count, int64_t outer, int c,
                                int64_t inner, int relu, int is_bf16,
                                int phases, void* stream) {
  if (bad_shape(outer, c, inner, phases)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return forward<__nv_bfloat16>(x, res, y, weight, bias, sums, stats, work,
                                  eps, count, outer, c, inner, relu != 0,
                                  phases, st);
  return forward<float>(x, res, y, weight, bias, sums, stats, work, eps,
                        count, outer, c, inner, relu != 0, phases, st);
}

// K14 for the upstream gradient dy, with x, y (null without ReLU) and the
// forward's stats: phase 1 writes sums [2, C] (Σg'x̂, Σg') and dwb [2, C]
// (dweight, dbias, x's dtype), phase 2 reads them and writes dx and dres
// (null: not wanted). Returns a CUDA error code.
extern "C" int bn_train_backward(const void* dy, const void* x, const void* y,
                                 const float* stats, const void* weight,
                                 void* dx, void* dres, float* sums, void* dwb,
                                 float* work, float count, int64_t outer,
                                 int c, int64_t inner, int is_bf16,
                                 int phases, void* stream) {
  if (bad_shape(outer, c, inner, phases)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return backward<__nv_bfloat16>(dy, x, y, stats, weight, dx, dres, sums,
                                   dwb, work, count, outer, c, inner, phases,
                                   st);
  return backward<float>(dy, x, y, stats, weight, dx, dres, sums, dwb, work,
                         count, outer, c, inner, phases, st);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
