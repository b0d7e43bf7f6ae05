// The residual add and the LayerNorm after it, in one pass over bf16, for
// every LayerNorm in the port (ops/norm.py::add_layer_norm).
//
// It replaces no TPU kernel. The JAX package writes the same formula
// (candidate_reranking_cir_tpu/models/layers.py: LayerNorm, the residual
// adds of the blocks) and leaves it to XLA, which fuses it. Run eagerly on
// the card, one call took about 13 launches: the bf16 residual add, an
// fp32 copy, two mean reductions, the subtract, square, add eps, rsqrt,
// subtract, the two multiplies and the bias add in fp32, then the cast back
// to bf16, most of them a pass over [rows, width] in fp32. This kernel
// reads each bf16 input once and writes the bf16 output once (and the
// bf16 sum where the caller keeps it: the pre-LN ViT's residual stream).
//
// What it computes, row by row, in the eager route's order:
//   s    = bf16(float(x) + float(r))     the eager bf16 residual add
//                                        (s = x without a residual)
//   mean = sum(float(s)) / n
//   var  = sum((float(s) - mean)^2) / n  two passes, as eager: never
//                                        E[s^2] - mean^2
//   y    = bf16(((s - mean) * rsqrtf(var + eps)) * w + b)
// Every product and sum is __fmul_rn / __fadd_rn, so that nothing contracts
// into an FMA. The fp32 sums are taken in another order than PyTorch's
// reduction (each lane in turn over its columns, then a butterfly across
// the warp, which leaves every lane the same bits), so the result is not
// bit-equal to the eager route; ops/norm.py states the bound.
//
// What bounds it on the H100: bytes. At [8224, 1408] (one EVA ViT-g batch)
// it moves 4 bytes an element without a residual, 8 with one and the sum
// kept: 0.014 and 0.028 ms at 3.35 TB/s, against some 20 operations an
// element. So the design moves no byte twice:
// - one warp a row, 8 rows a block: the statistics are warp shuffles, with
//   no shared memory, no scratch and nothing allocated;
// - where the width is a multiple of 8 and every pointer 16-byte aligned,
//   16-byte loads and stores of 8 bf16 values, and the row held in
//   registers as packed bf16 between the three sweeps (steps = the width's
//   vectors over 32 lanes, 1 to 8, so widths up to 2048: 768 is 3 steps,
//   1408 is 6 with the last one masked);
// - any other width or alignment takes the scalar body, which reads the row
//   three times (its second and third reads come from L1/L2);
// - the launch shape follows the width; one launch on the caller's stream,
//   nothing allocated: graph-safe.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see ops/build.py). Plain C entry
// point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;             // one warp a row
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kVec = 8;                      // bf16 values in 16 bytes
constexpr int kMaxSteps = 8;                 // vector body: widths <= 2048

// a bf16 pair packed in 32 bits: element 0 in the low half
__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a)))
         | (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}
// the eager bf16 add of two pairs
__device__ __forceinline__ uint32_t add_pair(uint32_t a, uint32_t b) {
  return pack(__fadd_rn(lo(a), lo(b)), __fadd_rn(hi(a), hi(b)));
}

// every lane ends with the same bits: lanes i and i^o add the same two
// values at each stage
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float square_dev(float v, float mean) {
  const float d = __fsub_rn(v, mean);
  return __fmul_rn(d, d);
}

__device__ __forceinline__ float normed(float v, float mean, float rstd,
                                        float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), w), b);
}

// kSteps vectors of 8 a lane: vector v = lane + 32 k of the row
template <int kSteps, bool kResidual, bool kKeepSum>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_vec_kernel(const uint4* __restrict__ x,
                          const uint4* __restrict__ res,
                          const float4* __restrict__ weight,
                          const float4* __restrict__ bias,
                          uint4* __restrict__ y, uint4* __restrict__ sum_out,
                          int64_t rows, int row_vec, float n, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock
                      + threadIdx.x / kWarp;
  if (row >= rows) return;                   // the whole warp leaves
  const int64_t base = row * row_vec;
  uint32_t s[kSteps][4];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int v = lane + k * kWarp;
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    if (v < row_vec) {
      a = x[base + v];
      if constexpr (kResidual) {
        const uint4 r = res[base + v];
        a = make_uint4(add_pair(a.x, r.x), add_pair(a.y, r.y),
                       add_pair(a.z, r.z), add_pair(a.w, r.w));
      }
    }
    s[k][0] = a.x; s[k][1] = a.y; s[k][2] = a.z; s[k][3] = a.w;
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    if (lane + k * kWarp < row_vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc = __fadd_rn(__fadd_rn(acc, lo(s[k][j])), hi(s[k][j]));
      }
    }
  }
  const float mean = __fdiv_rn(warp_sum(acc), n);
  acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    if (lane + k * kWarp < row_vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc = __fadd_rn(__fadd_rn(acc, square_dev(lo(s[k][j]), mean)),
                        square_dev(hi(s[k][j]), mean));
      }
    }
  }
  const float var = __fdiv_rn(warp_sum(acc), n);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int v = lane + k * kWarp;
    if (v < row_vec) {
      const float4 w0 = __ldg(weight + 2 * v), w1 = __ldg(weight + 2 * v + 1);
      const float4 b0 = __ldg(bias + 2 * v), b1 = __ldg(bias + 2 * v + 1);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = pack(normed(lo(s[k][j]), mean, rstd, w[2 * j], b[2 * j]),
                    normed(hi(s[k][j]), mean, rstd, w[2 * j + 1],
                           b[2 * j + 1]));
      }
      y[base + v] = make_uint4(o[0], o[1], o[2], o[3]);
      if constexpr (kKeepSum) {
        sum_out[base + v] = make_uint4(s[k][0], s[k][1], s[k][2], s[k][3]);
      }
    }
  }
}

template <bool kResidual>
__device__ __forceinline__ __nv_bfloat16 sum_at(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
    int64_t i) {
  if constexpr (kResidual) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(x[i]),
                                         __bfloat162float(res[i])));
  } else {
    return x[i];
  }
}

// any width and alignment: a lane takes columns lane, lane + 32, ... and
// reads them once a sweep
template <bool kResidual, bool kKeepSum>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ res,
                             const float* __restrict__ weight,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y,
                             __nv_bfloat16* __restrict__ sum_out,
                             int64_t rows, int64_t n, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock
                      + threadIdx.x / kWarp;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + row * n;
  const __nv_bfloat16* rr = kResidual ? res + row * n : nullptr;
  const float nf = static_cast<float>(n);
  float acc = 0.0f;
  for (int64_t j = lane; j < n; j += kWarp) {
    acc = __fadd_rn(acc, __bfloat162float(sum_at<kResidual>(xr, rr, j)));
  }
  const float mean = __fdiv_rn(warp_sum(acc), nf);
  acc = 0.0f;
  for (int64_t j = lane; j < n; j += kWarp) {
    acc = __fadd_rn(acc, square_dev(
        __bfloat162float(sum_at<kResidual>(xr, rr, j)), mean));
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(acc), nf), eps));
  for (int64_t j = lane; j < n; j += kWarp) {
    const __nv_bfloat16 s = sum_at<kResidual>(xr, rr, j);
    y[row * n + j] = __float2bfloat16_rn(normed(
        __bfloat162float(s), mean, rstd, __ldg(weight + j), __ldg(bias + j)));
    if constexpr (kKeepSum) sum_out[row * n + j] = s;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kSteps, bool kResidual, bool kKeepSum>
void launch_vec(int blocks, const void* x, const void* res, const float* w,
                const float* b, void* y, void* s, int64_t rows, int row_vec,
                float eps, cudaStream_t stream) {
  add_layer_norm_vec_kernel<kSteps, kResidual, kKeepSum>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const uint4*>(x), static_cast<const uint4*>(res),
          reinterpret_cast<const float4*>(w),
          reinterpret_cast<const float4*>(b), static_cast<uint4*>(y),
          static_cast<uint4*>(s), rows, row_vec,
          static_cast<float>(row_vec * kVec), eps);
}

template <bool kResidual, bool kKeepSum>
int launch(const void* x, const void* res, const float* w, const float* b,
           void* y, void* s, int64_t rows, int64_t n, float eps,
           cudaStream_t stream) {
  const int blocks = static_cast<int>((rows + kRowsPerBlock - 1)
                                      / kRowsPerBlock);
  const int64_t row_vec = n / kVec;
  const bool vec = n % kVec == 0 && row_vec <= kWarp * kMaxSteps
      && aligned16(x) && aligned16(y) && aligned16(w) && aligned16(b)
      && (!kResidual || aligned16(res)) && (!kKeepSum || aligned16(s));
  if (vec) {
    const int rv = static_cast<int>(row_vec);
    switch ((rv + kWarp - 1) / kWarp) {
#define CRC_STEPS(k)                                                      \
      case k:                                                             \
        launch_vec<k, kResidual, kKeepSum>(blocks, x, res, w, b, y, s,    \
                                           rows, rv, eps, stream);        \
        break;
      CRC_STEPS(1) CRC_STEPS(2) CRC_STEPS(3) CRC_STEPS(4)
      CRC_STEPS(5) CRC_STEPS(6) CRC_STEPS(7) CRC_STEPS(8)
#undef CRC_STEPS
    }
  } else {
    add_layer_norm_scalar_kernel<kResidual, kKeepSum>
        <<<blocks, kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(res), w, b,
            static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(s),
            rows, n, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// What crc_add_layer_norm refuses, as a negative code (a positive code is a
// cudaError_t): -1 a row count or a width below 1, or more rows than one
// grid holds; -2 a sum to keep without a residual.
int crc_add_layer_norm(const void* x, const void* residual,
                       const void* weight, const void* bias, void* out,
                       void* sum_out, long long rows, long long n, float eps,
                       void* stream) {
  if (rows < 1 || n < 1
      || (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) {
    return -1;
  }
  if (sum_out && !residual) return -2;
  auto st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  if (!residual) return launch<false, false>(x, nullptr, w, b, out, nullptr,
                                             rows, n, eps, st);
  if (!sum_out) return launch<true, false>(x, residual, w, b, out, nullptr,
                                           rows, n, eps, st);
  return launch<true, true>(x, residual, w, b, out, sum_out, rows, n, eps,
                            st);
}

}  // extern "C"
