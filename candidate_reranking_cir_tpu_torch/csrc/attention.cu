// Eval attention forward for Hopper (sm_90a): the four eval kernels of the
// JAX package's ops/pallas_attention.py (_attn_kernel_folded,
// _attn_bias_kernel, _attn_kernel, _attn_bias_kernel_folded). They compute
// one function and differ only in the layout of q/k/v ([E, L, H*D] folded
// or [E, L, H, D] unfolded, which here is a matter of strides) and in an
// optional additive bias.
//
// Per (entry e, head h): out = softmax(q*d^-1/2 . k^T + bias) . v with
//   - fp32 scores times the scale (the JAX package folds a power-of-two
//     scale into q, which gives the same bits; the kernels take d = 64,
//     and the wrappers zero-pad narrower heads and pass their own scale;
//     the tensor-core kernel also takes d = 88 and d = 72 without a bias,
//     in place: EVA ViT-g's heads, BLIP-2's vision tower, and MoonViT's,
//     Kimi-VL's),
//   - max-subtracted exp, a sum, and a DIVIDE (not a
//     reciprocal multiply), as pallas_attention.py:_head_attention does,
//   - the probabilities rounded to the input type before P.V,
//   - fp32 accumulation of P.V and the output rounded to the input type.
//
// Two kernels, chosen by dtype (routing, as the JAX package routes by
// layout and bias; neither is a fallback of the other):
//   - bf16, with or without a bias (K1-K4 on every path), runs
//     attn_fwd_tc_kernel (attention_tc.cuh): wgmma tensor cores, K/V tiles
//     streamed by cp.async, the exact softmax in two sweeps over the keys
//     (one step when the keys fit one tile), the bias added to the scaled
//     score as JAX adds it.
//   - fp32 runs attn_fwd_kernel over attn_fwd_body (attention_common.cuh),
//     which the train forward (K6, attention_train.cu) shares with its
//     dropout step switched on. It keeps the full fp32 score rows of 32
//     query rows in shared memory (32 x 577 x 4 B = 74 KB, up to
//     fwd_max_keys() keys) and does plain fp32 FMAs; fp32 stays off the
//     tensor cores, which would round it to TF32.
//
// What bounds them at the main path's shapes (bf16, per (entry, head)
// 4*Lq*M*D operations against (2*Lq + 2*M)*D*2 bytes): bytes for K1 in
// the MED (40 x 577) and, by a hair, in the ViT (577 x 577: 289 operations
// a byte against the card's 295), and for K2/K4 (8-160 keys, where each
// head is one or a few tiles and latency sets the pace); operations for
// K3 at 1,280 rows of 577 keys per candidate, bytes at its narrowest call
// (32 rows). PERF.md has the bounds.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see ops/build.py). Plain C entry
// points, loaded with ctypes.

#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

using namespace crc;

// fp32 only: bf16 takes the tensor-core kernel
template <bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, int lq, int m, float scale,
                Strides st) {
  attn_fwd_body<float, kHasBias, false>(q, k, v, bias, out, lq, m, scale, st,
                                        Dropout{0, 0.f, 1.f});
}

template <bool kHasBias>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int entries, int heads, int lq, int m, float scale,
           const Strides& st, cudaStream_t stream) {
  auto kernel = attn_fwd_kernel<kHasBias>;
  const size_t smem = fwd_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kRows - 1) / kRows, heads, entries);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), lq, m,
      scale, st);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel with kWarpgroups warpgroups (64 query rows each)
// a block, at head width kDim. Its attributes are set once per device, for
// the ring's shared memory, the most a launch takes.
template <int kWarpgroups, bool kHasBias, int kDim>
int launch_tc_wg(const void* q, const void* k, const void* v,
                 const float* bias, void* out, int entries, int heads,
                 int lq, int m, float scale, const Strides& st,
                 cudaStream_t stream) {
  static std::atomic<bool> done[tc::kMaxDevices];
  constexpr int sub_tiles = tc::HeadLayout<kDim>::kSubTiles;
  auto kernel = tc::attn_fwd_tc_kernel<kWarpgroups, kHasBias, kDim>;
  const cudaError_t err = tc::configure_once(
      done, reinterpret_cast<const void*>(kernel),
      tc::smem_bytes(kWarpgroups, tc::kTileKeys + 1, tc::kStages,
                     sub_tiles));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = kWarpgroups * tc::kRowsPerWg;
  const dim3 grid((lq + rows - 1) / rows, heads, entries);
  kernel<<<grid, kWarpgroups * 128,
           tc::smem_bytes(kWarpgroups, m, tc::kStages, sub_tiles),
           stream>>>(static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), bias,
                     static_cast<__nv_bfloat16*>(out), lq, m, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// One warpgroup (64 rows) per block up to 64 query rows, two above. The
// caller has checked the alignment (tc::aligned()).
template <bool kHasBias, int kDim = kHeadDim>
int launch_tc(const void* q, const void* k, const void* v, const float* bias,
              void* out, int entries, int heads, int lq, int m, float scale,
              const Strides& st, cudaStream_t stream) {
  return lq > tc::kRowsPerWg
             ? launch_tc_wg<2, kHasBias, kDim>(q, k, v, bias, out, entries,
                                               heads, lq, m, scale, st,
                                               stream)
             : launch_tc_wg<1, kHasBias, kDim>(q, k, v, bias, out, entries,
                                               heads, lq, m, scale, st,
                                               stream);
}

}  // namespace

extern "C" {

int crc_attention_head_dim() { return kHeadDim; }

// Dynamic shared memory of one tensor-core block of 1 or 2 warpgroups
// over m keys.
int crc_attention_tc_smem_bytes(int warpgroups, int m) {
  return static_cast<int>(tc::smem_bytes(warpgroups, m));
}

// What crc_attention_forward refuses, as negative codes (a positive code
// is a cudaError_t): more keys than the fp32-FMA kernel's score rows hold
// in shared memory (fwd_max_keys()); on the tensor-core route a base
// pointer or stride that is not aligned (tc::aligned()); a head width
// other than kHeadDim, or kWideHeadDim or kMoonViTHeadDim in bf16 without
// a bias.
constexpr int kRefusedKeys = -1;
constexpr int kRefusedAlignment = -2;
constexpr int kRefusedHeadDim = -3;

// dtype: 0 = float32, 1 = bfloat16. head_dim: kHeadDim, or kWideHeadDim
// or kMoonViTHeadDim (bf16, no bias). bias: null, or fp32 with strides
// strides[12..13]. strides: q, k, v, out as (entry, row, head) triples. Routes bf16 to the
// tensor-core kernel, fp32 to attn_fwd_kernel. Returns the launch's
// cudaGetLastError() (0 = success), cudaErrorInvalidValue for an empty axis
// or an unknown dtype, or one of the refusals above.
int crc_attention_forward(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, const float* bias,
                          void* out, const long long* strides, int entries,
                          int heads, int lq, int m, float scale,
                          void* stream) {
  const Strides st = unpack_strides(strides);
  if (m < 1 || lq < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if ((head_dim == tc::kWideHeadDim || head_dim == tc::kMoonViTHeadDim) &&
      dtype == 1 && !bias) {
    if (!tc::aligned(q, k, v, out, st)) return kRefusedAlignment;
    return head_dim == tc::kWideHeadDim
               ? launch_tc<false, tc::kWideHeadDim>(q, k, v, bias, out,
                                                    entries, heads, lq, m,
                                                    scale, st, s)
               : launch_tc<false, tc::kMoonViTHeadDim>(q, k, v, bias, out,
                                                       entries, heads, lq,
                                                       m, scale, st, s);
  }
  if (head_dim != kHeadDim) return kRefusedHeadDim;
  if (dtype == 1) {
    if (!tc::aligned(q, k, v, out, st)) return kRefusedAlignment;
    return bias ? launch_tc<true>(q, k, v, bias, out, entries, heads, lq, m,
                                  scale, st, s)
                : launch_tc<false>(q, k, v, bias, out, entries, heads, lq, m,
                                   scale, st, s);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m > fwd_max_keys()) return kRefusedKeys;
  return bias ? launch<true>(q, k, v, bias, out, entries, heads, lq, m, scale,
                             st, s)
              : launch<false>(q, k, v, bias, out, entries, heads, lq, m,
                              scale, st, s);
}

}  // extern "C"
