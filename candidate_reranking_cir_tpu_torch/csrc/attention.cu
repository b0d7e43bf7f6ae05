// Eval attention forward for Hopper (sm_90a): one strided kernel for the
// four eval kernels of the JAX package's ops/pallas_attention.py
// (_attn_kernel_folded, _attn_bias_kernel, _attn_kernel,
// _attn_bias_kernel_folded). They compute one function and differ only in
// the layout of q/k/v ([E, L, H*D] folded or [E, L, H, D] unfolded, which
// here is a matter of strides) and in an optional additive bias.
//
// Per (entry e, head h): out = softmax(q*d^-1/2 . k^T + bias) . v with
//   - the scale folded into q (exact: d = 64 makes it a power of two),
//   - fp32 scores, max-subtracted exp, a sum, and a DIVIDE (not a
//     reciprocal multiply), as pallas_attention.py:_head_attention does,
//   - the probabilities rounded to the input type before P.V,
//   - fp32 accumulation of P.V and the output rounded to the input type.
//
// What bounds it: at the main path's shapes (577 keys, <= 1280 query rows
// per entry) the work is about 4*Lq*M*D operations over (Lq + 2M)*D*2
// bytes per head, far above the card's bytes-to-operations balance, so the
// bound is arithmetic. This first version keeps the exact-softmax numerics
// simple: a block holds the full fp32 score rows of its 32 query rows in
// shared memory (32 x 577 x 4 B = 74 KB), so no online-softmax rescaling
// is needed, and it does the products with plain fp32 FMAs from shared
// memory, not tensor cores. That leaves it well short of the bf16 tensor-
// core bound; wgmma/TMA tiles are the next step.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see ops/build.py). Plain C entry
// points, loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>

namespace {

constexpr int kHeadDim = 64;   // the only head width the kernel takes
constexpr int kRows = 32;      // query rows per block
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

// Grid: (ceil(lq / kRows), heads, entries). Dynamic shared memory:
// q tile [kRows][kHeadDim], one K or V tile [kKeys][kTileStride], and the
// score rows [kRows][m], all fp32.
template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ out, int lq, int m, float scale, Strides st) {
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

  // q tile with the scale folded in (exact for a power-of-two scale);
  // rows past lq read as zeros and are never stored
  for (int i = tid; i < kRows * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    const int row = row0 + r;
    qs[i] = row < lq ? to_f(qb[row * st.q[1] + d]) * scale : 0.f;
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
        float s = acc[r];
        if (kHasBias) {
          const int row = row0 + rbase + r;
          if (row < lq) s += bb[row * st.b[1] + key];
        }
        sc[(rbase + r) * m + key] = s;
      }
    }
  }
  __syncthreads();

  // ---- exact softmax: one warp per row -----------------------------------
  const int warp = tid / 32, lane = tid % 32;
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
    // divide, then round to the input type before P.V (pallas :109-115)
    for (int j = lane; j < m; j += 32)
      srow[j] = to_f(from_f<T>(srow[j] / sum));
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

size_t smem_bytes(int m) {
  return (static_cast<size_t>(kFixedSmemFloats) +
          static_cast<size_t>(kRows) * m) * sizeof(float);
}

template <typename T, bool kHasBias>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int entries, int heads, int lq, int m, float scale,
           const Strides& st, cudaStream_t stream) {
  auto kernel = attn_fwd_kernel<T, kHasBias>;
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kRows - 1) / kRows, heads, entries);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lq, m, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest key count whose score rows fit the block's shared memory.
int crc_attention_max_keys() {
  return (kMaxSmemBytes - kFixedSmemFloats * static_cast<int>(sizeof(float))) /
         (kRows * static_cast<int>(sizeof(float)));
}

int crc_attention_head_dim() { return kHeadDim; }

// dtype: 0 = float32, 1 = bfloat16. bias: null, or fp32 with strides
// strides[12..13]. strides: q, k, v, out as (entry, row, head) triples.
// Returns the launch's cudaGetLastError() (0 = success).
int crc_attention_forward(int dtype, const void* q, const void* k,
                          const void* v, const float* bias, void* out,
                          const long long* strides, int entries, int heads,
                          int lq, int m, float scale, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  st.b[0] = strides[12];
  st.b[1] = strides[13];
  if (m < 1 || lq < 1 || m > crc_attention_max_keys())
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bias ? launch<float, true>(q, k, v, bias, out, entries, heads, lq,
                                      m, scale, st, s)
                : launch<float, false>(q, k, v, bias, out, entries, heads, lq,
                                       m, scale, st, s);
  if (dtype == 1)
    return bias ? launch<__nv_bfloat16, true>(q, k, v, bias, out, entries,
                                              heads, lq, m, scale, st, s)
                : launch<__nv_bfloat16, false>(q, k, v, bias, out, entries,
                                               heads, lq, m, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
