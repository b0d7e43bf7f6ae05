// Eval attention forward for Hopper (sm_90a): the four eval kernels of the
// JAX package's ops/pallas_attention.py (_attn_kernel_folded,
// _attn_bias_kernel, _attn_kernel, _attn_bias_kernel_folded). They compute
// one function and differ only in the layout of q/k/v ([E, L, H*D] folded
// or [E, L, H, D] unfolded, which here is a matter of strides) and in an
// optional additive bias.
//
// Per (entry e, head h): out = softmax(q*d^-1/2 . k^T + bias) . v with
//   - the scale folded into q (exact: d = 64 makes it a power of two),
//   - fp32 scores, max-subtracted exp, a sum, and a DIVIDE (not a
//     reciprocal multiply), as pallas_attention.py:_head_attention does,
//   - the probabilities rounded to the input type before P.V,
//   - fp32 accumulation of P.V and the output rounded to the input type.
//
// Two kernels, chosen by dtype and bias (routing, as the JAX package
// routes by layout and bias; neither is a fallback of the other):
//   - bf16 without a bias (K1, K3: the main path's launches) runs
//     attn_fwd_tc_kernel (attention_tc.cuh): wgmma tensor cores, K/V tiles
//     streamed by cp.async, the exact softmax in two sweeps over the keys.
//   - fp32, and any launch with a bias (K2, K4), runs attn_fwd_kernel over
//     attn_fwd_body (attention_common.cuh), which the train forward (K6,
//     attention_train.cu) shares with its dropout step switched on. It
//     keeps the full fp32 score rows of 32 query rows in shared memory (32
//     x 577 x 4 B = 74 KB, up to fwd_max_keys() keys) and does plain fp32
//     FMAs; fp32 stays off the tensor cores, which would round it to TF32.
//
// What bounds them at the main path's shapes (bf16, per (entry, head)
// 4*Lq*M*D operations against (2*Lq + 2*M)*D*2 bytes): bytes for K1 in
// the MED (40 x 577) and, by a hair, in the ViT (577 x 577: 289 operations
// a byte against the card's 295), and for K2/K4 (40-160 keys); operations
// for K3 at 1,280 rows of 577 keys per candidate, bytes at its narrowest
// call (32 rows). PERF.md has the bounds.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see ops/build.py). Plain C entry
// points, loaded with ctypes.

#include "attention_common.cuh"
#include "attention_tc.cuh"

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

int crc_attention_head_dim() { return kHeadDim; }

// Dynamic shared memory of one tensor-core block of 1 or 2 warpgroups.
int crc_attention_tc_smem_bytes(int warpgroups) {
  return static_cast<int>(tc::smem_bytes(warpgroups));
}

// What crc_attention_forward refuses, as negative codes (a positive code
// is a cudaError_t): more keys than the fp32-FMA kernel's score rows hold
// in shared memory (fwd_max_keys()); on the tensor-core route a base
// pointer or stride that is not aligned (tc::aligned()).
constexpr int kRefusedKeys = -1;
constexpr int kRefusedAlignment = -2;

// dtype: 0 = float32, 1 = bfloat16. bias: null, or fp32 with strides
// strides[12..13]. strides: q, k, v, out as (entry, row, head) triples.
// Routes bf16 without a bias to the tensor-core kernel, the rest to
// attn_fwd_kernel. Returns the launch's cudaGetLastError() (0 = success),
// cudaErrorInvalidValue for an empty axis or an unknown dtype, or one of
// the refusals above.
int crc_attention_forward(int dtype, const void* q, const void* k,
                          const void* v, const float* bias, void* out,
                          const long long* strides, int entries, int heads,
                          int lq, int m, float scale, void* stream) {
  const Strides st = unpack_strides(strides);
  if (m < 1 || lq < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && bias == nullptr) {
    if (!tc::aligned(q, k, v, out, st)) return kRefusedAlignment;
    return tc::launch(q, k, v, out, entries, heads, lq, m, scale, st, s);
  }
  if (m > fwd_max_keys()) return kRefusedKeys;
  if (dtype == 0)
    return bias ? launch<float, true>(q, k, v, bias, out, entries, heads, lq,
                                      m, scale, st, s)
                : launch<float, false>(q, k, v, bias, out, entries, heads, lq,
                                       m, scale, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k, v, bias, out, entries, heads,
                                       lq, m, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
