// Eval-mode BatchNorm with its epilogue in one pass (K12):
//
//   y = act((x − mean) · (rsqrt(var + eps) · weight) + bias [+ residual])
//
// act is the identity or ReLU. The ResNet-50s (DeepLabV3+'s encoder at OS
// 16, Mask2Former's backbone at OS 32), DeepLabV3+'s ASPP and decoder and
// both depth heads call it for every BN in eval mode (models/heads.py
// BatchNorm). It replaces no Pallas kernel: on the TPU, XLA fused the BN
// into the convolutions around it. Eager PyTorch runs the same function as
// three small per-channel launches and three full-tensor passes, then a
// residual add and a ReLU pass, each reading and writing the whole tensor.
//
// Arithmetic: f32 from the input's dtype, rounded once to x's dtype. The
// per-channel mul = rsqrt(var + eps)·weight is computed here, in f32, and
// the element is (x − mean)·mul + bias, in that order (Flax's order and the
// plain version's), then + residual, then ReLU.
//
// Layout, x's dtype bf16 or f32 everywhere: x, residual and y dense in one
// of two layouts, the same for all three — channels innermost (NHWC
// memory order of an NCHW tensor, channels-last: the main path, cuDNN's
// output on the NHWC models) or channel-major (NCHW-contiguous; `inner` =
// the product of the dims after the channel dim). mean, var, weight and
// bias: C contiguous values. n = x's element count.
//
// Design: bound by bytes (read x, and the residual where given, once;
// write y once). Channels innermost with C % 8 == 0 and C ≤ 2048: each
// thread keeps the affine of its 8 channels in registers and strides over
// pixels (the block holds a whole number of channel groups, so a thread's
// group never changes), one 8-channel vector at a time; every load and
// store is 16 bytes (bf16; two for f32). The grid is one wave, the blocks
// the SMs hold at once. Two or four vectors in flight a thread (more
// registers, fewer threads an SM) and streaming cache hints were slower at
// every shape of the cells. Anything else (channel-major, a ragged C, an
// unaligned pointer) takes the scalar kernel, which finds each element's
// channel by division: no cell's BN is channel-major, since every input
// comes from a conv on an NHWC view, and the one contiguous case, ASPP's
// pooled [N, C, 1, 1], is channels innermost too (inner 1). Every grid
// strides over the tensor, so the per-channel prologue runs once a thread.
//
// Bound on the H100 at Mask2Former-R50's stem (bf16 [4, 64, 512, 1024]):
// 268 MB read and 268 MB written, 0.160 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 256;     // channel groups of 8 a block holds

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

template <typename T>
struct Channels {
  const T* mean;
  const T* var;
  const T* weight;
  const T* bias;
  float eps;

  // channel c's mean, mul = rsqrt(var + eps)·weight and bias, in f32
  __device__ __forceinline__ void affine(int c, float& m, float& k,
                                         float& b) const {
    m = to_f(__ldg(mean + c));
    k = rsqrtf(to_f(__ldg(var + c)) + eps) * to_f(__ldg(weight + c));
    b = to_f(__ldg(bias + c));
  }
};

__device__ __forceinline__ float epilogue(float x, float m, float k, float b,
                                          float r, bool relu) {
  const float z = fmaf(x - m, k, b) + r;
  return relu && z < 0.f ? 0.f : z;
}

// Channels innermost, C = 8·groups: vector v holds channels
// (v % groups)·8 … +7 of one pixel. blockDim.x is a multiple of groups.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_act_nhwc8(const T* __restrict__ x, const T* __restrict__ res,
                 T* __restrict__ y, Channels<T> ch, int64_t n_vec,
                 int groups, bool relu) {
  const int c0 = (int)(threadIdx.x % groups) * 8;
  float m[8], k[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ch.affine(c0 + i, m[i], k[i], b[i]);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    float xv[8], rv[8], out[8];
    load8(x + v * 8, xv);
    if (res != nullptr) load8(res + v * 8, rv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = epilogue(xv[i], m[i], k[i], b[i],
                        res != nullptr ? rv[i] : 0.f, relu);
    store8(y + v * 8, out);
  }
}

// Any dense layout above: element e is of channel (e / inner) % c (inner 1
// for channels innermost).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_act_scalar(const T* __restrict__ x, const T* __restrict__ res,
                  T* __restrict__ y, Channels<T> ch, int64_t n, int c,
                  int64_t inner, bool relu) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float m, k, b;
    ch.affine((int)((e / inner) % c), m, k, b);
    const float r = res != nullptr ? to_f(res[e]) : 0.f;
    from_f(epilogue(to_f(x[e]), m, k, b, r, relu), y + e);
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* x, const void* res, void* y, const Channels<T>& ch,
           int64_t n, int c, int64_t inner, bool relu, cudaStream_t stream) {
  const T* xp = (const T*)x;
  const T* rp = (const T*)res;
  T* yp = (T*)y;
  const int sms = sm_count();
  const bool vec_ok = aligned16(x) && aligned16(y)
                      && (res == nullptr || aligned16(res));
  if (inner == 1 && c % 8 == 0 && c / 8 <= kMaxGroups && vec_ok) {
    const int groups = c / 8;
    const int threads = groups * (kThreads / groups);
    const int64_t n_vec = n / 8;
    // one wave: the affine in registers leaves room for fewer than 2048
    // threads an SM
    static int per_sm[kThreads + 1] = {0};
    if (per_sm[threads] == 0)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[threads], bn_act_nhwc8<T>, threads, 0);
    const int64_t want = (n_vec + threads - 1) / threads;
    const int64_t wave = (int64_t)sms * (per_sm[threads] > 0 ? per_sm[threads]
                                                           : 1);
    const int blocks = (int)(want < wave ? want : wave);
    bn_act_nhwc8<T><<<blocks, threads, 0, stream>>>(xp, rp, yp, ch, n_vec,
                                                    groups, relu);
  } else {
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int64_t wave = (int64_t)sms * (2048 / kThreads);
    const int blocks = (int)(want < wave ? want : wave);
    bn_act_scalar<T><<<blocks, kThreads, 0, stream>>>(xp, rp, yp, ch, n, c,
                                                      inner, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, residual (null for none), y: n elements of one dense layout; mean,
// var, weight, bias: c values; inner: 1 for channels innermost, else the
// elements of one (n, c) plane. Returns a CUDA error code.
extern "C" int bn_act_launch(const void* x, const void* res, void* y,
                             const void* mean, const void* var,
                             const void* weight, const void* bias, float eps,
                             int64_t n, int c, int64_t inner, int relu,
                             int is_bf16, void* stream) {
  if (c < 1 || inner < 1 || n < 0 || n % ((int64_t)c * inner) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const Channels<T> ch{(const T*)mean, (const T*)var, (const T*)weight,
                         (const T*)bias, eps};
    return launch<T>(x, res, y, ch, n, c, inner, relu != 0, st);
  }
  const Channels<float> ch{(const float*)mean, (const float*)var,
                           (const float*)weight, (const float*)bias, eps};
  return launch<float>(x, res, y, ch, n, c, inner, relu != 0, st);
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
