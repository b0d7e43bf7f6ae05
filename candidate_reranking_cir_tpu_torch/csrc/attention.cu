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
// The body lives in attention_common.cuh (attn_fwd_body<T, bias, false>);
// the train forward (K6, attention_train.cu) instantiates the same body
// with its dropout step switched on.
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

#include "attention_common.cuh"

namespace {

using namespace crc;

template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ out, int lq, int m, float scale, Strides st) {
  attn_fwd_body<T, kHasBias, false>(q, k, v, bias, out, lq, m, scale, st,
                                    Dropout{0, 0.f, 1.f});
}

template <typename T, bool kHasBias>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int entries, int heads, int lq, int m, float scale,
           const Strides& st, cudaStream_t stream) {
  auto kernel = attn_fwd_kernel<T, kHasBias>;
  const size_t smem = fwd_smem_bytes(m);
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
int crc_attention_max_keys() { return fwd_max_keys(); }

int crc_attention_head_dim() { return kHeadDim; }

// dtype: 0 = float32, 1 = bfloat16. bias: null, or fp32 with strides
// strides[12..13]. strides: q, k, v, out as (entry, row, head) triples.
// Returns the launch's cudaGetLastError() (0 = success).
int crc_attention_forward(int dtype, const void* q, const void* k,
                          const void* v, const float* bias, void* out,
                          const long long* strides, int entries, int heads,
                          int lq, int m, float scale, void* stream) {
  const Strides st = unpack_strides(strides);
  if (m < 1 || lq < 1 || m > fwd_max_keys())
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
