// Shifted-window attention with a relative position bias (K15), forward
// only. For every batch row, window of the map rolled by (−shift, −shift)
// and head h:
//
//   out = softmax(q·kᵀ·scale + table[rel(i, j), h] + mask(i, j))·v
//
// over the window's N = ws² tokens (Swin, arXiv:2103.14030; the backbone of
// models/swin.py). It replaces no TPU kernel: the JAX package has no Swin.
// The published composition materialises the [windows, heads, N, N]
// scores, adds the gathered bias and the shift mask to them in two more
// passes, softmaxes them and reads them back for the product; at the
// Mask2Former-Swin-L cell (1024×2048, batch 4) those passes move about
// 16 ms of HBM traffic a batch. Here none of them leaves the chip.
//
// Layout: qkv [B, Hp, Wp, 3, heads, 32] (the qkv projection of the padded
// map, in map order), table [(2·ws − 1)², heads], out [B, Hp, Wp, heads,
// 32], bf16 or f32 (one dtype), contiguous; Hp, Wp multiples of ws ≤ 12.
// The roll, the window partition, its reverse and the roll back are index
// arithmetic: window token (ty, tx) of rolled window (wy, wx) is map token
// ((wy·ws + ty + shift) mod Hp, (wx·ws + tx + shift) mod Wp), read there
// and written back there. rel(i, j) = (yi − yj + ws − 1)·(2ws − 1) + xi −
// xj + ws − 1 (the published relative_position_index) is computed from the
// tokens' window coordinates, and the table is gathered from shared
// memory. The published mask is −100 between tokens of different regions
// of the rolled map (three slices an axis: [0, Hp − ws), [Hp − ws,
// Hp − shift), [Hp − shift, Hp)); here such a key gets an exact zero
// weight (exp(−100) is below f32's normal range; a departure only where a
// masked score exceeds the row's largest by more than 100). Only windows
// on the last row or column of a shifted map hold two regions.
//
// Bound on the H100 (portbench/counts/swin.py::k15_counts): q, k, v read
// once and the output written once over the padded map, plus the table;
// 4·Tp·N·C operations. At the cell every launch is bound by bytes (stage 1
// 0.250 ms, stage 2 0.128, stage 3 0.070, stage 4 0.038; 2.09 ms for the
// 24 launches of a batch), with about 4 operations a byte: the softmax's
// exp, the bias gather and the row sums, on the CUDA cores, weigh as much
// as the two products on the tensor cores.
//
// bf16 design (mma.sync m16n8k16 from attention_mma.cuh): a block of
// 32·⌈N/16⌉ threads (9 warps at ws = 12) takes one window and a group of
// G ≤ 4 of its heads in turn, each warp 16 query rows. A head's q, k and v
// (27.6 KB) come into shared memory by cp.async; at 72 registers three
// blocks share an SM, so one block's loads are in flight while the others
// compute. A warp takes the keys in chunks of 48 (three 16-key tiles)
// through an online softmax: a chunk's scores stay in registers, the row
// max and sum are rescaled once a chunk. The probabilities are rounded to
// bf16 for the product (as K1 does); the row sums and the output are
// f32, rounded once. The output goes through the warp's own q rows in
// shared memory to 16-byte stores. On the H100 the arithmetic around the
// products (the bias gather, the exponentials, the sums) sets the pace,
// not the bytes: 39–43% of the bound at stages 1–3; one exact pass over
// all 144 keys (96 registers, two blocks an SM) took 1.2 times as long.
//
// f32 design (parity, CUDA cores): one thread a query row of one (window,
// head); k, v and the table in shared memory; two passes over the keys
// (the row max, then the exponentials and the product).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using attn_mma::bf16;

constexpr int kD = 32;                          // head dim
constexpr int kMaxWs = 12;
constexpr int kMaxN = kMaxWs * kMaxWs;          // 144 tokens a window
constexpr int kMaxTiles = kMaxN / 16;           // 9 row tiles of 16
constexpr int kMaxTable = (2 * kMaxWs - 1) * (2 * kMaxWs - 1);  // 529
constexpr int kLd = kD + attn_mma::kPad;        // 40 bf16 a shared row
constexpr int kMaxGroup = 4;                    // heads of one block
constexpr int kChunk = 3;                       // 16-key tiles a softmax step
constexpr float kLog2e = 1.4426950408889634f;

struct Geometry {
  int hp, wp, ws, shift, nwy, nwx, heads, c, n, tiles, group;
};

// Where window token t of window `win` (b·nwy·nwx + wy·nwx + wx) lies in
// the map, its table row offset (ty·(2ws − 1) + tx) and its region label
// in the rolled map (0 unless shifted).
struct Token {
  int64_t off;
  int kb, region;
};

__device__ __forceinline__ Token token(const Geometry& g, int win, int t) {
  const int per = g.nwy * g.nwx;
  const int b = win / per, w = win % per;
  const int ty = t / g.ws, tx = t % g.ws;
  const int sy = (w / g.nwx) * g.ws + ty, sx = (w % g.nwx) * g.ws + tx;
  int oy = sy + g.shift, ox = sx + g.shift;
  if (oy >= g.hp) oy -= g.hp;
  if (ox >= g.wp) ox -= g.wp;
  Token k;
  k.off = ((int64_t)b * g.hp + oy) * g.wp + ox;
  k.kb = ty * (2 * g.ws - 1) + tx;
  const int ry = sy < g.hp - g.ws ? 0 : (sy < g.hp - g.shift ? 1 : 2);
  const int rx = sx < g.wp - g.ws ? 0 : (sx < g.wp - g.shift ? 1 : 2);
  k.region = g.shift ? ry * 3 + rx : 0;
  return k;
}

// A query row's own term of rel: (ty + ws − 1)·(2ws − 1) + tx + ws − 1, so
// that rel(i, j) = qb(i) − kb(j).
__device__ __forceinline__ int query_base(const Geometry& g, int t) {
  const int ty = t / g.ws, tx = t % g.ws;
  return (ty + g.ws - 1) * (2 * g.ws - 1) + tx + g.ws - 1;
}

// ---------------------------------------------------------------- bf16

struct Shared {
  bf16 q[kMaxN][kLd], k[kMaxN][kLd], v[kMaxN][kLd];
  float table[kMaxGroup][kMaxTable];   // × log2(e)
  int64_t off[kMaxN];
  int16_t kb[kMaxN];                   // 0 past n: a safe table offset
  int8_t region[kMaxN];
};

// One head's q, k, v of the window into shared memory (cp.async,
// committed); rows past n zero-filled.
__device__ __forceinline__ void load_head(Shared& sh, const bf16* qkv,
                                          const Geometry& g, int head) {
  const int rows = g.tiles * 16;
  const int chunks = 3 * rows * (kD / 8);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int part = i / (rows * 4), rem = i % (rows * 4);
    const int r = rem / 4, cc = rem % 4;
    bf16(*dst)[kLd] = part == 0 ? sh.q : (part == 1 ? sh.k : sh.v);
    const bool ok = r < g.n;
    const bf16* src = qkv + (ok ? sh.off[r] : 0) * 3 * g.c + part * g.c +
                      head * kD + cc * 8;
    attn_mma::cp_async16(&dst[r][cc * 8], src, ok ? 16 : 0);
  }
  attn_mma::cp_async_commit();
}

__global__ void __launch_bounds__(kMaxTiles * 32, 3)
    window_attention_mma(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ table,
                         bf16* __restrict__ out, Geometry g, float c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  const int win = blockIdx.x;
  const int h0 = blockIdx.y * g.group;
  const int nh = min(g.group, g.heads - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;
  const int tw = 2 * g.ws - 1, nt = tw * tw;

  for (int t = threadIdx.x; t < kMaxN; t += blockDim.x) {
    const Token k = token(g, win, min(t, g.n - 1));
    sh.off[t] = k.off;
    sh.kb[t] = t < g.n ? (int16_t)k.kb : 0;
    sh.region[t] = (int8_t)k.region;
  }
  __syncthreads();
  load_head(sh, qkv, g, h0);
  for (int i = threadIdx.x; i < nh * nt; i += blockDim.x) {
    const int hh = i / nt, r = i % nt;
    sh.table[hh][r] = __bfloat162float(table[r * g.heads + h0 + hh]) * kLog2e;
  }
  // a block holds two regions only on the rolled map's last window row or
  // column; keys past n (ws < 12 with n % 16 ≠ 0) score −∞
  const int w = win % (g.nwy * g.nwx);
  const bool masked = g.shift && (w / g.nwx == g.nwy - 1 ||
                                  w % g.nwx == g.nwx - 1);
  const bool ragged = g.n % 16 != 0;
  const int row0 = min(warp * 16 + gr, g.n - 1), row1 = min(row0 + 8, g.n - 1);
  const int qb0 = query_base(g, row0), qb1 = query_base(g, row1);
  const int reg0 = sh.region[row0], reg1 = sh.region[row1];
  const int chunks = (g.tiles + kChunk - 1) / kChunk;

  for (int hh = 0; hh < nh; ++hh) {
    if (hh > 0) {
      __syncthreads();   // every warp is done with the previous head
      load_head(sh, qkv, g, h0 + hh);
    }
    attn_mma::cp_async_wait<0>();
    __syncthreads();
    if (warp < g.tiles) {
      const float* tbl = sh.table[hh];
      uint32_t qf[2][4];
      attn_mma::ldsm_x4(qf[0], attn_mma::a_ptr(sh.q, warp * 16, 0, lane));
      attn_mma::ldsm_x4(qf[1], attn_mma::a_ptr(sh.q, warp * 16, 16, lane));
      float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      float o[kD / 8][4];
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      // the keys in chunks of kChunk 16-key tiles, an online softmax over
      // the chunks: a chunk's scores stay in registers
#pragma unroll
      for (int ch = 0; ch < kMaxTiles / kChunk; ++ch) {
        if (ch < chunks) {
          float s[2 * kChunk][4];
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            const int j = ch * kChunk + jj;
            s[2 * jj][0] = s[2 * jj][1] = s[2 * jj][2] = s[2 * jj][3] = 0.f;
            s[2 * jj + 1][0] = s[2 * jj + 1][1] = s[2 * jj + 1][2] =
                s[2 * jj + 1][3] = 0.f;
            if (j < g.tiles) {
#pragma unroll
              for (int kc = 0; kc < 2; ++kc) {
                uint32_t b[4];
                attn_mma::ldsm_x4(b, attn_mma::b_ptr(sh.k, 16 * j, 16 * kc,
                                                     lane));
                attn_mma::mma(s[2 * jj], qf[kc], b[0], b[1]);
                attn_mma::mma(s[2 * jj + 1], qf[kc], b[2], b[3]);
              }
            }
          }
          // log2 units plus the bias; the mask; the chunk's row max
          float cm0 = -INFINITY, cm1 = -INFINITY;
#pragma unroll
          for (int i = 0; i < 2 * kChunk; ++i) {
            const int col = 16 * kChunk * ch + 8 * i + 2 * tg;
            if (col < 16 * g.tiles) {
              const uint32_t kk =
                  *reinterpret_cast<const uint32_t*>(&sh.kb[col]);
              const int k0 = (int)(kk & 0xffffu), k1 = (int)(kk >> 16);
              s[i][0] = fmaf(s[i][0], c, tbl[qb0 - k0]);
              s[i][1] = fmaf(s[i][1], c, tbl[qb0 - k1]);
              s[i][2] = fmaf(s[i][2], c, tbl[qb1 - k0]);
              s[i][3] = fmaf(s[i][3], c, tbl[qb1 - k1]);
              if (masked) {
                const int r0 = sh.region[col], r1 = sh.region[col + 1];
                if (r0 != reg0) s[i][0] = -INFINITY;
                if (r1 != reg0) s[i][1] = -INFINITY;
                if (r0 != reg1) s[i][2] = -INFINITY;
                if (r1 != reg1) s[i][3] = -INFINITY;
              }
              if (ragged) {
                if (col >= g.n) s[i][0] = s[i][2] = -INFINITY;
                if (col + 1 >= g.n) s[i][1] = s[i][3] = -INFINITY;
              }
              cm0 = fmaxf(cm0, fmaxf(s[i][0], s[i][1]));
              cm1 = fmaxf(cm1, fmaxf(s[i][2], s[i][3]));
            }
          }
          cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, 1));
          cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, 2));
          cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, 1));
          cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, 2));
          // the new row max (0 while a row has seen no key: its terms are
          // all zero), and the old terms rescaled to it
          const float m0 = fmaxf(mx0, cm0), m1 = fmaxf(mx1, cm1);
          const float ref0 = m0 == -INFINITY ? 0.f : m0;
          const float ref1 = m1 == -INFINITY ? 0.f : m1;
          const float a0 = attn_mma::ex2(mx0 - ref0);
          const float a1 = attn_mma::ex2(mx1 - ref1);
          mx0 = m0;
          mx1 = m1;
          l0 *= a0;
          l1 *= a1;
#pragma unroll
          for (int n = 0; n < kD / 8; ++n) {
            o[n][0] *= a0;
            o[n][1] *= a0;
            o[n][2] *= a1;
            o[n][3] *= a1;
          }
          // the exponentials, row sums and P·V, 16 keys at a time
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            const int j = ch * kChunk + jj;
            if (j < g.tiles) {
              float p[2][4];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                p[u][0] = attn_mma::ex2(s[2 * jj + u][0] - ref0);
                p[u][1] = attn_mma::ex2(s[2 * jj + u][1] - ref0);
                p[u][2] = attn_mma::ex2(s[2 * jj + u][2] - ref1);
                p[u][3] = attn_mma::ex2(s[2 * jj + u][3] - ref1);
                l0 += p[u][0] + p[u][1];
                l1 += p[u][2] + p[u][3];
              }
              const uint32_t a[4] = {attn_mma::pack_bf16(p[0][0], p[0][1]),
                                     attn_mma::pack_bf16(p[0][2], p[0][3]),
                                     attn_mma::pack_bf16(p[1][0], p[1][1]),
                                     attn_mma::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
              for (int pp = 0; pp < 2; ++pp) {
                uint32_t b[4];
                attn_mma::ldsm_x4_t(b, attn_mma::a_ptr(sh.v, 16 * j, 16 * pp,
                                                       lane));
                attn_mma::mma(o[2 * pp], a, b[0], b[1]);
                attn_mma::mma(o[2 * pp + 1], a, b[2], b[3]);
              }
            }
          }
        }
      }
      const float inv0 = 1.f / attn_mma::quad_sum(l0);
      const float inv1 = 1.f / attn_mma::quad_sum(l1);
      // through the warp's own q rows (read into qf above) to 16-byte stores
      __syncwarp();
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = 8 * n + 2 * tg;
        *reinterpret_cast<uint32_t*>(&sh.q[warp * 16 + gr][col]) =
            attn_mma::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
        *reinterpret_cast<uint32_t*>(&sh.q[warp * 16 + gr + 8][col]) =
            attn_mma::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = warp * 16 + (lane >> 2) + 8 * u, cc = lane & 3;
        if (r < g.n)
          *reinterpret_cast<uint4*>(out + sh.off[r] * g.c + (h0 + hh) * kD +
                                    cc * 8) =
              *reinterpret_cast<const uint4*>(&sh.q[r][cc * 8]);
      }
    }
  }
}

// ----------------------------------------------------------------- f32

struct SharedF32 {
  float k[kMaxN][kD], v[kMaxN][kD];
  float table[kMaxTable];
  int kb[kMaxN], region[kMaxN];
};

__global__ void __launch_bounds__(kMaxN + 16)
    window_attention_f32(const float* __restrict__ qkv,
                         const float* __restrict__ table,
                         float* __restrict__ out, Geometry g, float scale) {
  __shared__ SharedF32 sh;
  const int win = blockIdx.x, head = blockIdx.y, t = threadIdx.x;
  const int tw = 2 * g.ws - 1, nt = tw * tw;
  int64_t off = 0;
  if (t < g.n) {
    const Token k = token(g, win, t);
    off = k.off;
    sh.kb[t] = k.kb;
    sh.region[t] = k.region;
    const float* src = qkv + off * 3 * g.c + head * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      sh.k[t][d] = src[g.c + d];
      sh.v[t][d] = src[2 * g.c + d];
    }
  }
  for (int i = t; i < nt; i += blockDim.x) sh.table[i] = table[i * g.heads + head];
  __syncthreads();
  if (t >= g.n) return;
  float q[kD];
  const float* qs = qkv + off * 3 * g.c + head * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) q[d] = qs[d] * scale;
  const int qb = query_base(g, t), reg = sh.region[t];
  float mx = -INFINITY;
  for (int j = 0; j < g.n; ++j) {
    if (sh.region[j] != reg) continue;
    float s = sh.table[qb - sh.kb[j]];
#pragma unroll
    for (int d = 0; d < kD; ++d) s = fmaf(q[d], sh.k[j][d], s);
    mx = fmaxf(mx, s);
  }
  float l = 0.f, o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] = 0.f;
  for (int j = 0; j < g.n; ++j) {
    if (sh.region[j] != reg) continue;
    float s = sh.table[qb - sh.kb[j]];
#pragma unroll
    for (int d = 0; d < kD; ++d) s = fmaf(q[d], sh.k[j][d], s);
    const float p = expf(s - mx);
    l += p;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] = fmaf(p, sh.v[j][d], o[d]);
  }
  float* dst = out + off * g.c + head * kD;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < kD; ++d) dst[d] = o[d] * inv;
}

}  // namespace

// Returns a CUDA error code.
extern "C" int window_attention_launch(const void* qkv, const void* table,
                                       void* out, int b, int hp, int wp,
                                       int heads, int ws, int shift,
                                       int is_bf16, float scale,
                                       void* stream) {
  if (ws < 1 || ws > kMaxWs || hp % ws || wp % ws || shift < 0 ||
      shift >= ws || heads < 1)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.hp = hp;
  g.wp = wp;
  g.ws = ws;
  g.shift = shift;
  g.nwy = hp / ws;
  g.nwx = wp / ws;
  g.heads = heads;
  g.c = heads * kD;
  g.n = ws * ws;
  g.tiles = (g.n + 15) / 16;
  g.group = 1;
  for (int d = kMaxGroup; d >= 1; --d)
    if (heads % d == 0) { g.group = d; break; }
  const int64_t windows = (int64_t)b * g.nwy * g.nwx;
  if (windows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const size_t bytes = sizeof(Shared);
    const cudaError_t e = attn_mma::allow_smem(window_attention_mma, bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)windows, (unsigned)(heads / g.group));
    window_attention_mma<<<grid, 32 * g.tiles, bytes, st>>>(
        (const bf16*)qkv, (const bf16*)table, (bf16*)out, g,
        scale * kLog2e);
  } else {
    const dim3 grid((unsigned)windows, (unsigned)heads);
    window_attention_f32<<<grid, (g.n + 31) / 32 * 32, 0, st>>>(
        (const float*)qkv, (const float*)table, (float*)out, g, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* awseg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
