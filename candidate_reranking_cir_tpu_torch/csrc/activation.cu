// fc1's bias add and the exact GELU of every FFN in the port, in one pass
// over bf16 (ops/activation.py::bias_gelu).
//
// It replaces no TPU kernel. The JAX package writes the same formula
// (candidate_reranking_cir_tpu/models/layers.py: Dense, exact_gelu) and
// leaves it to XLA, which fuses it into fc1's epilogue. Run eagerly on the
// card, the formula took some 26 fp32 passes over fc1's [rows, 3072]
// product plus the bias add in bf16: ~240 bytes moved an element for ~30
// fp32 operations, the largest block of the port's device time. This
// kernel reads the bf16 product once and writes the bf16 activation once.
//
// What it computes, element by element, is the eager route's function in
// the eager route's order (the eager route stays the definition):
//   y   = bf16(float(p) + float(bf16(bias[j])))   Dense's bias add in bf16
//                                                  (skipped without a bias:
//                                                  -0 + 0 would flip a sign)
//   x   = float(y)
//   u   = |x| * 0.70710677f
//   t   = 1 / (1 + 0.3275911f * u)                 an IEEE divide (PyTorch's
//                                                  __rtruediv__: reciprocal,
//                                                  then * 1, which is exact)
//   poly: Horner, t * (c1 + t * (c2 + t * (c3 + t * (c4 + t * c5))))
//   erf = sign(x) * (1 - poly * expf(-u * u))      sign(0) = +0, as PyTorch's
//   out = bf16((0.5 * x) * (1 + erf))
// Every constant is the Python double rounded to fp32, as PyTorch rounds a
// scalar against an fp32 tensor. Every product and sum is __fmul_rn /
// __fadd_rn, so that nothing contracts into an FMA (each eager op rounds
// on its own), the divide is __fdiv_rn and the exponential is expf (never
// __expf): the result is bit-equal to the eager route on the card.
//
// What bounds it on the H100: instruction throughput. The 8-wide loop
// executes about 55 instructions an element (the divide's and expf's
// sequences, ~22 fp32 operations, the bf16 conversions), ~0.093 ms at the
// ViT's [18464, 3072] on 132 SMs x 4 warp instructions a clock, against
// 0.068 ms for its 4 bytes an element at 3.35 TB/s (PERF.md has the row).
// The design keeps both low: 16-byte loads and stores of 8 bf16 a thread
// where the row width is a multiple of 8 and the pointers are 16-byte
// aligned (a scalar body otherwise: every width and row count is taken),
// a grid-stride loop that fills the SMs at the occupancy the registers
// allow, the column carried from step to step (no division an element),
// and the bias row read through the read-only cache, where it stays.
//
// Graph-safe: one launch on the caller's stream, nothing allocated.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see ops/build.py). Plain C entry
// point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 values in a 16-byte load

// a Python float as PyTorch hands it to an fp32 kernel: the double rounded
// to the nearest float
#define CRC_F32(x) (static_cast<float>(x))

__device__ __forceinline__ float exact_gelu(float x) {
  const float u = __fmul_rn(fabsf(x), CRC_F32(0.7071067811865476));
  const float t = __fdiv_rn(1.0f,
                            __fadd_rn(__fmul_rn(u, CRC_F32(0.3275911)), 1.0f));
  float p = __fmul_rn(t, CRC_F32(1.061405429));
  p = __fmul_rn(t, __fadd_rn(p, CRC_F32(-1.453152027)));
  p = __fmul_rn(t, __fadd_rn(p, CRC_F32(1.421413741)));
  p = __fmul_rn(t, __fadd_rn(p, CRC_F32(-0.284496736)));
  p = __fmul_rn(t, __fadd_rn(p, CRC_F32(0.254829592)));
  const float e = expf(-__fmul_rn(u, u));
  const float sign = static_cast<float>(static_cast<int>(0.0f < x) -
                                        static_cast<int>(x < 0.0f));
  const float erf = __fmul_rn(sign, __fsub_rn(1.0f, __fmul_rn(p, e)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf));
}

template <bool kBias>
__device__ __forceinline__ __nv_bfloat16 bias_gelu_one(__nv_bfloat16 p,
                                                       float bias) {
  float x = __bfloat162float(p);
  if (kBias) {
    x = __bfloat162float(__float2bfloat16_rn(
        __fadd_rn(x, __bfloat162float(__float2bfloat16_rn(bias)))));
  }
  return __float2bfloat16_rn(exact_gelu(x));
}

// 8 elements a thread and step; n_vec = rows * n / 8, row_vec = n / 8
template <bool kBias>
__global__ void __launch_bounds__(kThreads)
bias_gelu_vec_kernel(const uint4* __restrict__ in,
                     const float* __restrict__ bias, uint4* __restrict__ out,
                     int64_t n_vec, int64_t row_vec) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t step_col = step % row_vec;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t col = v % row_vec;
  for (; v < n_vec; v += step) {
    uint4 raw = in[v];
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
    float b[kVec];
    if (kBias) {
      const float4* b4 = reinterpret_cast<const float4*>(bias + col * kVec);
      const float4 lo = __ldg(b4), hi = __ldg(b4 + 1);
      b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
      b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      h[i] = bias_gelu_one<kBias>(h[i], kBias ? b[i] : 0.0f);
    }
    out[v] = raw;
    col += step_col;
    if (col >= row_vec) col -= row_vec;
  }
}

// one element a thread and step, any width and alignment; total = rows * n
template <bool kBias>
__global__ void __launch_bounds__(kThreads)
bias_gelu_scalar_kernel(const __nv_bfloat16* __restrict__ in,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int64_t total,
                        int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t step_col = step % n;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t col = i % n;
  for (; i < total; i += step) {
    out[i] = bias_gelu_one<kBias>(in[i], kBias ? __ldg(bias + col) : 0.0f);
    col += step_col;
    if (col >= n) col -= n;
  }
}

// the blocks that fill every SM at a kernel's occupancy, asked once a
// kernel (the port's processes each drive one kind of card)
template <typename Kernel>
int64_t full_grid(Kernel kernel) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
}

// blocks enough to fill every SM, and no more than the work needs
int grid_for(int64_t full, int64_t work) {
  const int64_t need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < full ? need : full);
}

template <bool kBias>
int launch(const void* product, const float* bias, void* out, int64_t rows,
           int64_t n, cudaStream_t stream) {
  const int64_t total = rows * n;
  const bool vec = n % kVec == 0
      && reinterpret_cast<uintptr_t>(product) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0
      && (!kBias || reinterpret_cast<uintptr_t>(bias) % 16 == 0);
  if (vec) {
    auto kernel = bias_gelu_vec_kernel<kBias>;
    static const int64_t full = full_grid(kernel);
    const int64_t n_vec = total / kVec;
    kernel<<<grid_for(full, n_vec), kThreads, 0, stream>>>(
        static_cast<const uint4*>(product), bias, static_cast<uint4*>(out),
        n_vec, n / kVec);
  } else {
    auto kernel = bias_gelu_scalar_kernel<kBias>;
    static const int64_t full = full_grid(kernel);
    kernel<<<grid_for(full, total), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(product), bias,
        static_cast<__nv_bfloat16*>(out), total, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// What crc_bias_gelu refuses, as a negative code (a positive code is a
// cudaError_t): a row count below 1 or a width below 1.
int crc_bias_gelu(const void* product, const void* bias, void* out,
                  long long rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  return b ? launch<true>(product, b, out, rows, n, s)
           : launch<false>(product, nullptr, out, rows, n, s);
}

}  // extern "C"
