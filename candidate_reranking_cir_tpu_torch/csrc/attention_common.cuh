// Pieces shared by the eval (attention.cu) and train (attention_train.cu)
// attention kernels: type helpers, warp reductions, the K5 dropout hash and
// the forward body that both the eval kernels (K1-K4) and the train forward
// (K6) instantiate. With kDropout = false the body is the eval kernel's
// function exactly; with kDropout = true it also applies the K5 keep-mask
// and the 1/(1 - rate) rescale before the cast to the input type.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

namespace crc {

constexpr int kHeadDim = 64;   // the head width the kernels take (the
                               // wrappers zero-pad narrower heads to it)
constexpr int kRows = 32;      // query rows per forward block
constexpr int kKeys = 64;      // keys per K/V tile in shared memory
constexpr int kThreads = 128;  // 4 warps
constexpr int kRowsPerThread = kRows * kKeys / kThreads;  // 16
constexpr int kTileStride = kHeadDim + 1;  // pad: conflict-free column reads
constexpr int kFixedSmemFloats = kRows * kHeadDim + kKeys * kTileStride;
constexpr int kMaxSmemBytes = 232448;      // 227 KB opt-in limit on sm_90

static_assert(kThreads == 2 * kKeys, "two row groups of one key column each");
static_assert(kThreads == 2 * kHeadDim, "two row groups of one output column");

struct Strides {
  // element strides: entry, row, head (the head_dim axis has stride 1)
  long long q[3], k[3], v[3], o[3];
  long long b[2];  // bias: entry, row (row stride 0 broadcasts a key mask)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- K5: the dropout keep-mask (pallas_attention_train.py:50-75) --------
// lowbias32 on 32-bit values with wraparound; the JAX package computes the
// same bits on int32 (logical shifts, two's-complement multiplies). The
// second multiplier is the JAX package's _M2 = -2073376117 = 0x846ACA8B
// (not lowbias32's published 0x846CA68B, which its comment names): the
// mask follows the value the JAX kernel uses.
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846ACA8Bu;
  x ^= x >> 16;
  return x;
}

// salt = hash(seed + b * 0x101 + h), b the absolute entry index
__device__ __forceinline__ uint32_t keep_salt(int seed, int b, int h) {
  return lowbias32(static_cast<uint32_t>(seed) +
                   static_cast<uint32_t>(b) * 0x101u +
                   static_cast<uint32_t>(h));
}

// the top 24 bits of hash(salt + row * cols + col)
__device__ __forceinline__ uint32_t keep_bits(uint32_t salt, int row,
                                              int cols, int col) {
  return lowbias32(salt + static_cast<uint32_t>(row) *
                              static_cast<uint32_t>(cols) +
                   static_cast<uint32_t>(col)) >>
         8;
}

// keep iff float(keep_bits) * 2^-24 >= rate
__device__ __forceinline__ bool keep_elem(uint32_t salt, int row, int cols,
                                          int col, float rate) {
  return static_cast<float>(keep_bits(salt, row, cols, col)) *
             5.9604644775390625e-8f >=
         rate;
}

// The same test as an integer compare, for the tensor-core forward:
// keep_bits is below 2^24, so float(keep_bits) * 2^-24 >= rate holds
// exactly when keep_bits >= keep_threshold(rate) = ceil(rate * 2^24)
// (both scalings by 2^24 are exact).
__device__ __forceinline__ uint32_t keep_threshold(float rate) {
  return static_cast<uint32_t>(ceilf(rate * 16777216.f));
}
__device__ __forceinline__ bool keep_elem_int(uint32_t salt, int row,
                                              int cols, int col,
                                              uint32_t threshold) {
  return keep_bits(salt, row, cols, col) >= threshold;
}

// Dropout of the attention probabilities: keep-mask seed, rate, and
// inv = float32(1 / (1 - rate)). rate 0 keeps everything (inv 1).
struct Dropout {
  int seed;
  float rate;
  float inv;
};

// Forward body. Grid: (ceil(lq / kRows), heads, entries). Dynamic shared
// memory: q tile [kRows][kHeadDim], one K or V tile [kKeys][kTileStride],
// and the score rows [kRows][m], all fp32.
//   - fp32 scores q . k^T, then times the scale (for a power-of-two scale
//     the same bits as the JAX package's fold into q; for any other its
//     fp32 multiply of the scores), then + the bias, without contraction,
//   - max-subtracted exp, a sum, and a DIVIDE,
//   - (kDropout) the K5 mask: kept probabilities times inv, dropped ones 0,
//   - the probabilities rounded to the input type before P.V,
//   - fp32 accumulation of P.V and the output rounded to the input type.
template <typename T, bool kHasBias, bool kDropout>
__device__ __forceinline__ void attn_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int lq, int m,
    float scale, const Strides& st, const Dropout& drop) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* tile = qs + kRows * kHeadDim;
  float* sc = tile + kKeys * kTileStride;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const long long h = blockIdx.y;
  const long long e = blockIdx.z;
  const T* qb = q + e * st.q[0] + h * st.q[2];
  const T* kb = k + e * st.k[0] + h * st.k[2];
  const T* vb = v + e * st.v[0] + h * st.v[2];
  T* ob = out + e * st.o[0] + h * st.o[2];
  const float* bb = kHasBias ? bias + e * st.b[0] : nullptr;

  // q tile; rows past lq read as zeros and are never stored
  for (int i = tid; i < kRows * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    const int row = row0 + r;
    qs[i] = row < lq ? to_f(qb[row * st.q[1] + d]) : 0.f;
  }

  // ---- scores: thread owns key column `col` of each tile, 16 rows ------
  const int col = tid % kKeys;
  const int rbase = (tid / kKeys) * kRowsPerThread;
  for (int k0 = 0; k0 < m; k0 += kKeys) {
    __syncthreads();  // q tile written / previous K tile consumed
    for (int i = tid; i < kKeys * kHeadDim; i += kThreads) {
      const int j = i / kHeadDim, d = i % kHeadDim;
      const int key = k0 + j;
      tile[j * kTileStride + d] =
          key < m ? to_f(kb[key * st.k[1] + d]) : 0.f;
    }
    __syncthreads();
    const int key = k0 + col;
    if (key < m) {
      float acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kHeadDim; ++d) {
        const float kd = tile[col * kTileStride + d];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] = fmaf(qs[(rbase + r) * kHeadDim + d], kd, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        float s = __fmul_rn(acc[r], scale);
        if (kHasBias) {
          const int row = row0 + rbase + r;
          if (row < lq) s = __fadd_rn(s, bb[row * st.b[1] + key]);
        }
        sc[(rbase + r) * m + key] = s;
      }
    }
  }
  __syncthreads();

  // ---- exact softmax: one warp per row -----------------------------------
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t salt =
      kDropout ? keep_salt(drop.seed, static_cast<int>(e), static_cast<int>(h))
               : 0u;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    if (row0 + r >= lq) break;  // uniform across the warp
    float* srow = sc + r * m;
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float p = expf(srow[j] - mx);
      srow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    // divide, (dropout,) then round to the input type before P.V
    for (int j = lane; j < m; j += 32) {
      float p = srow[j] / sum;
      if (kDropout)
        p = keep_elem(salt, row0 + r, m, j, drop.rate) ? p * drop.inv : 0.f;
      srow[j] = to_f(from_f<T>(p));
    }
  }

  // ---- P.V: thread owns output column `dcol`, 16 rows --------------------
  const int dcol = tid % kHeadDim;
  const int obase = (tid / kHeadDim) * kRowsPerThread;
  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < m; k0 += kKeys) {
    __syncthreads();  // softmax done / previous V tile consumed
    for (int i = tid; i < kKeys * kHeadDim; i += kThreads) {
      const int j = i / kHeadDim, d = i % kHeadDim;
      const int key = k0 + j;
      tile[j * kTileStride + d] =
          key < m ? to_f(vb[key * st.v[1] + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(kKeys, m - k0);
    for (int j = 0; j < nk; ++j) {
      const float vd = tile[j * kTileStride + dcol];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(sc[(obase + r) * m + k0 + j], vd, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + obase + r;
    if (row < lq) ob[row * st.o[1] + dcol] = from_f<T>(acc[r]);
  }
}

inline size_t fwd_smem_bytes(int m) {
  return (static_cast<size_t>(kFixedSmemFloats) +
          static_cast<size_t>(kRows) * m) * sizeof(float);
}

// Largest key count whose forward score rows fit a block's shared memory.
inline int fwd_max_keys() {
  return (kMaxSmemBytes - kFixedSmemFloats * static_cast<int>(sizeof(float))) /
         (kRows * static_cast<int>(sizeof(float)));
}

// strides: q, k, v, out as (entry, row, head) triples, then bias (entry, row)
inline Strides unpack_strides(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
  }
  st.b[0] = s[12];
  st.b[1] = s[13];
  return st;
}

}  // namespace crc
