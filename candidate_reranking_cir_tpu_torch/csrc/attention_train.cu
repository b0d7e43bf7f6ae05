// Train attention with in-kernel dropout for Hopper (sm_90a): the kernels
// of the JAX package's ops/pallas_attention_train.py over the unfolded
// [E, L, H, D] layout (strided, like the eval kernels), and their C entry
// points.
//
// K5 (_lowbias32 / _keep_mask): the keep-mask hash, a device function in
//     attention_common.cuh, run inside K6-K9; keep_mask_kernel below
//     writes it out for one (seed, entry, head) so that a test can hold it
//     bit for bit against the plain version.
// K6 (_fwd_kernel): the eval forward with the dropout step on: fp32
//     softmax, the K5 mask, kept probabilities times 1/(1 - rate),
//     dropped ones 0, the cast to the input type, then P.V.
// K7 (_bwd_kernel): dq, dk, dv with the mask regenerated. The products keep
//     the Pallas kernel's precisions: dv = dropped^T . g with fp32 dropped
//     and fp32 g; d_dropped = g . v^T in fp32; d_probs = keep * d_dropped *
//     inv; d_scores = p * (d_probs - sum(d_probs * p)) * scale, cast to the
//     input type; dq = d_scores . k and dk = d_scores^T . q (unscaled q),
//     fp32 accumulation, cast on output.
// K8 (_fwd_kernel_folded) and K9 (_bwd_kernel_folded): K6 and K7 over the
//     head-folded layout [E, L, H*D], which the stage-I MED cross-attention
//     trains in. Viewed as [E, L, H, D] that layout has the strides
//     (L*H*D, H*D, D, 1), so their kernels run K6/K7's bodies with the head
//     stride fixed at compile time to kHeadDim (folded()); they are kernels
//     and entry points of their own, so that a profile names them apart.
//
// Which launches take which kernel (the entry points route; nothing falls
// back from one kernel to another):
//   - bf16 without a bias, K6: attn_train_fwd_tc_kernel; K7:
//     attn_train_bwd_tc_{rows,keys}_kernel; K8:
//     attn_train_fwd_folded_tc_kernel; K9: attn_bwd_tc_{rows,keys}_kernel
//     (all in attention_train_tc.cuh, wgmma). A view that is not 16-byte
//     aligned is refused (kRefusedAlignment), not sent elsewhere. Every
//     stage-II launch (K6, K7) and every stage-I one (K8, K9) is one.
//   - fp32, or a bias (no path launches K6-K9 with one): the fp32-FMA
//     bodies below: attn_fwd_body (attention_common.cuh) for K6 and, at
//     the folded stride, K8; the row and key passes for K7 and, at the
//     folded stride, K9. The tensor cores would round fp32 to TF32.
//
// What bounds them at the stage-II shape [E = 16, Lq = 640, M = 577, H =
// 12, D = 64] in bf16: operations. Per (entry, head) K6 does 4*Lq*M*D =
// 94.5 M operations against (2*Lq + 2*M)*D*2 = 312 KB (303 a byte) and K7
// 10*Lq*M*D = 236 M against (3*Lq + 4*M)*D*2 = 541 KB (437 a byte), both
// above the card's 295: the tensor cores are the resource, so the bf16
// launches run on wgmma (attention_train_tc.cuh says how). At the stage-I
// MED shape [E = 512, Lq <= 40, M = 577] K8 and K9 are bound by bytes
// (37 and 48 operations a byte): with few query rows there is little
// reuse of K and V.
//
// The FMA passes of K7 (and of fp32 and bias K9), deterministic and
// without atomics (blocks run in any order, so nothing may be summed
// across blocks):
//   - a ROW pass per (entry, head, 16-row tile) recomputes scores and
//     probabilities for its rows against all keys (two [16][M] fp32 buffers
//     in shared memory), writes dq, and stores each row's max, sum and
//     delta = sum(d_probs * p) to an fp32 scratch [3][E][H][Lq];
//   - a KEY pass per (entry, head, 32-key tile) loops over all rows in
//     32-row chunks, recomputes p from those statistics, regenerates the
//     mask and d_scores, and accumulates dk and dv in registers.
// Both passes form each score and each g . v^T element with the same
// sequence of fmaf over d = 0..63 as the forward, so the two passes see
// the same fp32 values.
// The TPU kernels block 8 (forward) and 4 (backward) entries per program to
// spread a per-program overhead; here a block is one (row tile, head,
// entry) and the mask is keyed by the absolute entry index (blockIdx.z), so
// no entry blocking is needed. The TPU's transposed dk/dv variant
// (CRC_BWD_TRANSPOSED) has the same numbers: only the math is ported.

#include "attention_common.cuh"
#include "attention_train_tc.cuh"

namespace {

using namespace crc;

// ---- K6, K8 ---------------------------------------------------------------

template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, int lq, int m, float scale,
                      Strides st, Dropout drop) {
  attn_fwd_body<T, kHasBias, true>(q, k, v, bias, out, lq, m, scale, st,
                                   drop);
}

template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_train_fwd_folded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int lq, int m, float scale,
                             Strides st, Dropout drop) {
  attn_fwd_body<T, kHasBias, true>(q, k, v, bias, out, lq, m, scale,
                                   folded(st), drop);
}

template <typename T, bool kHasBias, bool kFolded>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               void* out, int entries, int heads, int lq, int m, float scale,
               const Strides& st, const Dropout& drop, cudaStream_t stream) {
  // only the kernel launched is instantiated: bf16 K6 and K8 without a
  // bias run the tensor cores, so their FMA instantiations would be dead
  // code
  const auto kernel = [] {
    if constexpr (kFolded)
      return attn_train_fwd_folded_kernel<T, kHasBias>;
    else
      return attn_train_fwd_kernel<T, kHasBias>;
  }();
  const size_t smem = fwd_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kRows - 1) / kRows, heads, entries);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lq, m, scale, st,
      drop);
  return static_cast<int>(cudaGetLastError());
}

// ---- K7 -------------------------------------------------------------------

constexpr int kBwdRows = 16;  // row pass: query rows per block
constexpr int kBwdRowsPerThread = kBwdRows * kKeys / kThreads;  // 8
constexpr int kBwdFixedSmemFloats =
    2 * kBwdRows * kHeadDim + kKeys * kTileStride;
constexpr int kKeyTile = 32;   // key pass: keys per block
constexpr int kRowChunk = 32;  // key pass: rows per chunk
constexpr int kPad32 = kKeyTile + 1;
static_assert(kThreads == 4 * kKeyTile, "four row groups of one key each");
static_assert(kRowChunk == 4 * 8, "eight rows per row group");

// Row pass. Grid: (ceil(lq / kBwdRows), heads, entries). Dynamic shared
// memory: q tile and g tile [kBwdRows][kHeadDim], one K or V tile
// [kKeys][kTileStride], then P and DD [kBwdRows][m] (fp32 probabilities,
// and g . v^T turned in place into d_scores).
template <typename T, bool kHasBias>
__device__ __forceinline__ void bwd_rows_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g,
    T* __restrict__ dq, float* __restrict__ stats, int entries, int heads,
    int lq, int m, float scale, const BwdStrides& st, const Dropout& drop) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + kBwdRows * kHeadDim;
  float* tile = gs + kBwdRows * kHeadDim;
  float* P = tile + kKeys * kTileStride;
  float* DD = P + kBwdRows * m;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBwdRows;
  const long long h = blockIdx.y;
  const long long e = blockIdx.z;
  const T* qb = q + e * st.q[0] + h * st.q[2];
  const T* kb = k + e * st.k[0] + h * st.k[2];
  const T* vb = v + e * st.v[0] + h * st.v[2];
  const T* gb = g + e * st.g[0] + h * st.g[2];
  T* dqb = dq + e * st.dq[0] + h * st.dq[2];
  const float* bb = kHasBias ? bias + e * st.b[0] : nullptr;
  const long long plane = static_cast<long long>(entries) * heads * lq;
  float* mstat = stats + (e * heads + h) * lq;
  float* lstat = mstat + plane;
  float* dstat = lstat + plane;

  for (int i = tid; i < kBwdRows * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    const int row = row0 + r;
    qs[i] = row < lq ? to_f(qb[row * st.q[1] + d]) : 0.f;
    gs[i] = row < lq ? to_f(gb[row * st.g[1] + d]) : 0.f;
  }

  const int col = tid % kKeys;
  const int rbase = (tid / kKeys) * kBwdRowsPerThread;
  // scores into P, then g . v^T into DD: same loop over K, then V tiles
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? kb : vb;
    const long long src_row = pass == 0 ? st.k[1] : st.v[1];
    const float* lhs = pass == 0 ? qs : gs;
    float* dst = pass == 0 ? P : DD;
    for (int k0 = 0; k0 < m; k0 += kKeys) {
      __syncthreads();
      for (int i = tid; i < kKeys * kHeadDim; i += kThreads) {
        const int j = i / kHeadDim, d = i % kHeadDim;
        const int key = k0 + j;
        tile[j * kTileStride + d] =
            key < m ? to_f(src[key * src_row + d]) : 0.f;
      }
      __syncthreads();
      const int key = k0 + col;
      if (key < m) {
        float acc[kBwdRowsPerThread];
#pragma unroll
        for (int r = 0; r < kBwdRowsPerThread; ++r) acc[r] = 0.f;
#pragma unroll 8
        for (int d = 0; d < kHeadDim; ++d) {
          const float kd = tile[col * kTileStride + d];
#pragma unroll
          for (int r = 0; r < kBwdRowsPerThread; ++r)
            acc[r] = fmaf(lhs[(rbase + r) * kHeadDim + d], kd, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kBwdRowsPerThread; ++r) {
          float s = acc[r];
          if (pass == 0) {
            // the forward's score: times the scale, then + the bias
            s = __fmul_rn(s, scale);
            const int row = row0 + rbase + r;
            if (kHasBias && row < lq)
              s = __fadd_rn(s, bb[row * st.b[1] + key]);
          }
          dst[(rbase + r) * m + key] = s;
        }
      }
    }
  }
  __syncthreads();

  // per row (one warp per row): p, the mask, d_probs, delta, d_scores
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t salt =
      keep_salt(drop.seed, static_cast<int>(e), static_cast<int>(h));
  for (int r = warp; r < kBwdRows; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= lq) break;  // uniform across the warp
    float* prow = P + r * m;
    float* drow = DD + r * m;
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, prow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float p = expf(prow[j] - mx);
      prow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float p = prow[j] / sum;
      const float dp = keep_elem(salt, row, m, j, drop.rate)
                           ? drow[j] * drop.inv : 0.f;
      prow[j] = p;
      drow[j] = dp;
      delta = fmaf(dp, p, delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < m; j += 32) {
      float ds = prow[j] * (drow[j] - delta);
      ds = ds * scale;
      drow[j] = to_f(from_f<T>(ds));
    }
    if (lane == 0) {
      mstat[row] = mx;
      lstat[row] = sum;
      dstat[row] = delta;
    }
  }

  // dq = d_scores . k: thread owns output column `dcol`, 8 rows
  const int dcol = tid % kHeadDim;
  const int obase = (tid / kHeadDim) * kBwdRowsPerThread;
  float acc[kBwdRowsPerThread];
#pragma unroll
  for (int r = 0; r < kBwdRowsPerThread; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < m; k0 += kKeys) {
    __syncthreads();
    for (int i = tid; i < kKeys * kHeadDim; i += kThreads) {
      const int j = i / kHeadDim, d = i % kHeadDim;
      const int key = k0 + j;
      tile[j * kTileStride + d] =
          key < m ? to_f(kb[key * st.k[1] + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(kKeys, m - k0);
    for (int j = 0; j < nk; ++j) {
      const float kd = tile[j * kTileStride + dcol];
#pragma unroll
      for (int r = 0; r < kBwdRowsPerThread; ++r)
        acc[r] = fmaf(DD[(obase + r) * m + k0 + j], kd, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kBwdRowsPerThread; ++r) {
    const int row = row0 + obase + r;
    if (row < lq) dqb[row * st.dq[1] + dcol] = from_f<T>(acc[r]);
  }
}

// Key pass. Grid: (ceil(m / kKeyTile), heads, entries); static shared
// memory. Thread t owns key j = t % 32; for the scores it takes rows
// (t / 32) * 8 .. +7 of each chunk, for dk/dv the head-dim columns
// t / 32 + 4 * i, i = 0..15.
template <typename T, bool kHasBias>
__device__ __forceinline__ void bwd_keys_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g,
    T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ stats,
    int entries, int heads, int lq, int m, float scale, const BwdStrides& st,
    const Dropout& drop) {
  __shared__ float Ks[kKeyTile * kTileStride];
  __shared__ float Vs[kKeyTile * kTileStride];
  __shared__ float Qs[kRowChunk * kTileStride];  // unscaled q
  __shared__ float Gs[kRowChunk * kTileStride];
  __shared__ float Pd[kRowChunk * kPad32];  // dropped probabilities
  __shared__ float Ds[kRowChunk * kPad32];  // d_scores in the input type

  const int tid = threadIdx.x;
  const int key0 = blockIdx.x * kKeyTile;
  const long long h = blockIdx.y;
  const long long e = blockIdx.z;
  const T* qb = q + e * st.q[0] + h * st.q[2];
  const T* kb = k + e * st.k[0] + h * st.k[2];
  const T* vb = v + e * st.v[0] + h * st.v[2];
  const T* gb = g + e * st.g[0] + h * st.g[2];
  const float* bb = kHasBias ? bias + e * st.b[0] : nullptr;
  const long long plane = static_cast<long long>(entries) * heads * lq;
  const float* mstat = stats + (e * heads + h) * lq;
  const float* lstat = mstat + plane;
  const float* dstat = lstat + plane;

  for (int i = tid; i < kKeyTile * kHeadDim; i += kThreads) {
    const int j = i / kHeadDim, d = i % kHeadDim;
    const int key = key0 + j;
    Ks[j * kTileStride + d] = key < m ? to_f(kb[key * st.k[1] + d]) : 0.f;
    Vs[j * kTileStride + d] = key < m ? to_f(vb[key * st.v[1] + d]) : 0.f;
  }

  const int j = tid % kKeyTile;
  const int key = key0 + j;
  const int grp = tid / kKeyTile;
  const uint32_t salt =
      keep_salt(drop.seed, static_cast<int>(e), static_cast<int>(h));
  float dk_acc[kHeadDim / 4], dv_acc[kHeadDim / 4];
#pragma unroll
  for (int i = 0; i < kHeadDim / 4; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int r0 = 0; r0 < lq; r0 += kRowChunk) {
    __syncthreads();  // K/V tiles written / previous chunk consumed
    for (int i = tid; i < kRowChunk * kHeadDim; i += kThreads) {
      const int r = i / kHeadDim, d = i % kHeadDim;
      const int row = r0 + r;
      Qs[r * kTileStride + d] = row < lq ? to_f(qb[row * st.q[1] + d]) : 0.f;
      Gs[r * kTileStride + d] = row < lq ? to_f(gb[row * st.g[1] + d]) : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < 8; ++rr) {
      const int r = grp * 8 + rr;
      const int row = r0 + r;
      float dropped = 0.f, ds = 0.f;
      if (row < lq && key < m) {
        float s = 0.f, dd = 0.f;
        for (int d = 0; d < kHeadDim; ++d)
          s = fmaf(Qs[r * kTileStride + d], Ks[j * kTileStride + d], s);
        for (int d = 0; d < kHeadDim; ++d)
          dd = fmaf(Gs[r * kTileStride + d], Vs[j * kTileStride + d], dd);
        s = __fmul_rn(s, scale);
        if (kHasBias) s = __fadd_rn(s, bb[row * st.b[1] + key]);
        const float p = expf(s - mstat[row]) / lstat[row];
        const bool kept = keep_elem(salt, row, m, key, drop.rate);
        dropped = kept ? p * drop.inv : 0.f;
        const float dp = kept ? dd * drop.inv : 0.f;
        ds = p * (dp - dstat[row]);
        ds = to_f(from_f<T>(ds * scale));
      }
      Pd[r * kPad32 + j] = dropped;
      Ds[r * kPad32 + j] = ds;
    }
    __syncthreads();
    for (int r = 0; r < kRowChunk; ++r) {
      const float pd = Pd[r * kPad32 + j];
      const float dsv = Ds[r * kPad32 + j];
#pragma unroll
      for (int i = 0; i < kHeadDim / 4; ++i) {
        const int d = grp + 4 * i;
        dv_acc[i] = fmaf(pd, Gs[r * kTileStride + d], dv_acc[i]);
        dk_acc[i] = fmaf(dsv, Qs[r * kTileStride + d], dk_acc[i]);
      }
    }
  }
  if (key < m) {
    T* dkb = dk + e * st.dk[0] + h * st.dk[2] + key * st.dk[1];
    T* dvb = dv + e * st.dv[0] + h * st.dv[2] + key * st.dv[1];
#pragma unroll
    for (int i = 0; i < kHeadDim / 4; ++i) {
      const int d = grp + 4 * i;
      dkb[d] = from_f<T>(dk_acc[i]);
      dvb[d] = from_f<T>(dv_acc[i]);
    }
  }
}

#define CRC_BWD_ROWS_ARGS                                                    \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v, \
      const float *__restrict__ bias, const T *__restrict__ g,               \
      T *__restrict__ dq, float *__restrict__ stats, int entries, int heads, \
      int lq, int m, float scale, BwdStrides st, Dropout drop
#define CRC_BWD_KEYS_ARGS                                                    \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v, \
      const float *__restrict__ bias, const T *__restrict__ g,               \
      T *__restrict__ dk, T *__restrict__ dv,                                \
      const float *__restrict__ stats, int entries, int heads, int lq, int m, \
      float scale, BwdStrides st, Dropout drop

// K7's two passes
template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(CRC_BWD_ROWS_ARGS) {
  bwd_rows_body<T, kHasBias>(q, k, v, bias, g, dq, stats, entries, heads, lq,
                             m, scale, st, drop);
}

template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_kernel(CRC_BWD_KEYS_ARGS) {
  bwd_keys_body<T, kHasBias>(q, k, v, bias, g, dk, dv, stats, entries, heads,
                             lq, m, scale, st, drop);
}

// K9's two passes: K7's with the folded head stride
template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_folded_kernel(CRC_BWD_ROWS_ARGS) {
  bwd_rows_body<T, kHasBias>(q, k, v, bias, g, dq, stats, entries, heads, lq,
                             m, scale, folded(st), drop);
}

template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_folded_kernel(CRC_BWD_KEYS_ARGS) {
  bwd_keys_body<T, kHasBias>(q, k, v, bias, g, dk, dv, stats, entries, heads,
                             lq, m, scale, folded(st), drop);
}

#undef CRC_BWD_ROWS_ARGS
#undef CRC_BWD_KEYS_ARGS

size_t bwd_rows_smem_bytes(int m) {
  return (static_cast<size_t>(kBwdFixedSmemFloats) +
          2 * static_cast<size_t>(kBwdRows) * m) * sizeof(float);
}

int bwd_max_keys() {
  return (kMaxSmemBytes -
          kBwdFixedSmemFloats * static_cast<int>(sizeof(float))) /
         (2 * kBwdRows * static_cast<int>(sizeof(float)));
}

template <typename T, bool kHasBias, bool kFolded>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias,
               const void* g, void* dq, void* dk, void* dv, float* stats,
               int entries, int heads, int lq, int m, float scale,
               const BwdStrides& st, const Dropout& drop,
               cudaStream_t stream) {
  auto rows = attn_bwd_rows_kernel<T, kHasBias>;
  auto keys = attn_bwd_keys_kernel<T, kHasBias>;
  if constexpr (kFolded) {
    rows = attn_bwd_rows_folded_kernel<T, kHasBias>;
    keys = attn_bwd_keys_folded_kernel<T, kHasBias>;
  }
  const size_t smem = bwd_rows_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_rows((lq + kBwdRows - 1) / kBwdRows, heads, entries);
  rows<<<grid_rows, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(g),
      static_cast<T*>(dq), stats, entries, heads, lq, m, scale, st, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_keys((m + kKeyTile - 1) / kKeyTile, heads, entries);
  keys<<<grid_keys, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(g),
      static_cast<T*>(dk), static_cast<T*>(dv), stats, entries, heads, lq, m,
      scale, st, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---- K5, written out ------------------------------------------------------

__global__ void keep_mask_kernel(int seed, int b, int h, int rows, int cols,
                                 float rate, unsigned char* __restrict__ out) {
  const uint32_t salt = keep_salt(seed, b, h);
  const long long n = static_cast<long long>(rows) * cols;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / cols);
    const int col = static_cast<int>(i % cols);
    out[i] = keep_elem(salt, row, cols, col, rate) ? 1 : 0;
  }
}

Dropout make_dropout(int seed, float rate, float inv) {
  Dropout d;
  d.seed = seed;
  d.rate = rate;
  d.inv = inv;
  return d;
}

int max_keys() {
  return bwd_max_keys() < fwd_max_keys() ? bwd_max_keys() : fwd_max_keys();
}

// What the entry points refuse besides cudaErrorInvalidValue, as a
// negative code: on a tensor-core route a base pointer or stride that is
// not aligned (tc::aligned(), tc::bwd_aligned()).
constexpr int kRefusedAlignment = -2;

// K6 (kFolded false) or K8 (true); the folded kernels take head strides of
// kHeadDim only. bf16 launches without a bias run the tensor-core kernels;
// the rest the fp32-FMA body.
template <bool kFolded>
int dispatch_forward(int dtype, const void* q, const void* k, const void* v,
                     const float* bias, void* out, const long long* strides,
                     int entries, int heads, int lq, int m, float scale,
                     int seed, float rate, float inv, void* stream) {
  const Strides st = unpack_strides(strides);
  const Dropout drop = make_dropout(seed, rate, inv);
  if (m < 1 || lq < 1 || m > max_keys())
    return static_cast<int>(cudaErrorInvalidValue);
  if (kFolded && (st.q[2] != kHeadDim || st.k[2] != kHeadDim ||
                  st.v[2] != kHeadDim || st.o[2] != kHeadDim))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && bias == nullptr) {
    if (!tc::aligned(q, k, v, out, st)) return kRefusedAlignment;
    return tc::launch_train_fwd<kFolded>(q, k, v, out, entries, heads, lq, m,
                                         scale, st, drop, s);
  }
  if (dtype == 0)
    return bias ? launch_fwd<float, true, kFolded>(
                      q, k, v, bias, out, entries, heads, lq, m, scale, st,
                      drop, s)
                : launch_fwd<float, false, kFolded>(
                      q, k, v, bias, out, entries, heads, lq, m, scale, st,
                      drop, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd<__nv_bfloat16, true, kFolded>(
      q, k, v, bias, out, entries, heads, lq, m, scale, st, drop, s);
}

// K7 (kFolded false) or K9 (true). Their bf16 launches without a bias run
// the tensor-core passes (attention_train_tc.cuh); fp32 and bias launches
// the fp32-FMA row and key passes.
template <bool kFolded>
int dispatch_backward(int dtype, const void* q, const void* k,
                      const void* v, const float* bias, const void* g,
                      void* dq, void* dk, void* dv, float* stats,
                      const long long* strides, int entries, int heads,
                      int lq, int m, float scale, int seed, float rate,
                      float inv, void* stream) {
  BwdStrides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.g[i] = strides[9 + i];
    st.dq[i] = strides[12 + i];
    st.dk[i] = strides[15 + i];
    st.dv[i] = strides[18 + i];
  }
  st.b[0] = strides[21];
  st.b[1] = strides[22];
  const Dropout drop = make_dropout(seed, rate, inv);
  if (m < 1 || lq < 1 || m > max_keys())
    return static_cast<int>(cudaErrorInvalidValue);
  if (kFolded) {
    for (int i = 0; i < 7; ++i)
      if (strides[3 * i + 2] != kHeadDim)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && bias == nullptr) {
    if (!tc::bwd_aligned(q, k, v, g, dq, dk, dv, st))
      return kRefusedAlignment;
    return tc::launch_bwd<kFolded>(q, k, v, g, dq, dk, dv, stats, entries,
                                   heads, lq, m, scale, st, drop, s);
  }
  if (dtype == 0)
    return bias ? launch_bwd<float, true, kFolded>(
                      q, k, v, bias, g, dq, dk, dv, stats, entries, heads, lq,
                      m, scale, st, drop, s)
                : launch_bwd<float, false, kFolded>(
                      q, k, v, bias, g, dq, dk, dv, stats, entries, heads, lq,
                      m, scale, st, drop, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<__nv_bfloat16, true, kFolded>(
      q, k, v, bias, g, dq, dk, dv, stats, entries, heads, lq, m, scale, st,
      drop, s);
}

}  // namespace

extern "C" {

// Largest key count K6-K9 take (the backward's row pass holds two score
// buffers, so it is the tighter one).
int crc_attention_train_max_keys() { return max_keys(); }

// K6. dtype: 0 = float32, 1 = bfloat16. strides: q, k, v, out as (entry,
// row, head) triples, then the bias's (entry, row). inv = 1 / (1 - rate).
// Returns the launch's cudaGetLastError() (0 = success), or
// kRefusedAlignment for a misaligned view on the tensor-core route.
int crc_attention_train_forward(int dtype, const void* q, const void* k,
                                const void* v, const float* bias, void* out,
                                const long long* strides, int entries,
                                int heads, int lq, int m, float scale,
                                int seed, float rate, float inv,
                                void* stream) {
  return dispatch_forward<false>(dtype, q, k, v, bias, out, strides, entries,
                                 heads, lq, m, scale, seed, rate, inv,
                                 stream);
}

// K8: as K6 over [E, L, H * kHeadDim] tensors (every head stride kHeadDim);
// bf16 without a bias on the tensor cores, which refuse misaligned views
// with kRefusedAlignment.
int crc_attention_train_folded_forward(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const float* bias, void* out,
                                       const long long* strides, int entries,
                                       int heads, int lq, int m, float scale,
                                       int seed, float rate, float inv,
                                       void* stream) {
  return dispatch_forward<true>(dtype, q, k, v, bias, out, strides, entries,
                                heads, lq, m, scale, seed, rate, inv, stream);
}

// K7. strides: q, k, v, g, dq, dk, dv as (entry, row, head) triples, then
// the bias's (entry, row). stats: fp32 scratch of 3 * entries * heads * lq.
// bf16 without a bias on the tensor cores, which refuse misaligned views
// with kRefusedAlignment.
int crc_attention_train_backward(int dtype, const void* q, const void* k,
                                 const void* v, const float* bias,
                                 const void* g, void* dq, void* dk, void* dv,
                                 float* stats, const long long* strides,
                                 int entries, int heads, int lq, int m,
                                 float scale, int seed, float rate, float inv,
                                 void* stream) {
  return dispatch_backward<false>(dtype, q, k, v, bias, g, dq, dk, dv, stats,
                                  strides, entries, heads, lq, m, scale,
                                  seed, rate, inv, stream);
}

// K9: as K7 over [E, L, H * kHeadDim] tensors (every head stride kHeadDim);
// bf16 without a bias on the tensor cores, which refuse misaligned views
// with kRefusedAlignment.
int crc_attention_train_folded_backward(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const float* bias, const void* g,
                                        void* dq, void* dk, void* dv,
                                        float* stats, const long long* strides,
                                        int entries, int heads, int lq, int m,
                                        float scale, int seed, float rate,
                                        float inv, void* stream) {
  return dispatch_backward<true>(dtype, q, k, v, bias, g, dq, dk, dv, stats,
                                 strides, entries, heads, lq, m, scale, seed,
                                 rate, inv, stream);
}

// Dynamic shared memory of the tensor-core kernels: 0 = the backward's
// (K7, K9) row pass, 1 = its key pass; 2 = K6 with one warpgroup over more
// than one key tile, 3 = with two; 4 = K8 with one warpgroup over more
// than one key tile, 5 = with two.
int crc_attention_train_tc_smem_bytes(int pass) {
  if (pass == 0) return static_cast<int>(tc::bwd_rows_smem_bytes());
  if (pass == 1) return static_cast<int>(tc::bwd_keys_smem_bytes());
  if (pass >= 4)
    return static_cast<int>(
        tc::train_fwd_smem_bytes<true>(pass - 3, tc::kTileKeys + 1));
  return static_cast<int>(
      tc::train_fwd_smem_bytes<false>(pass - 1, tc::kTileKeys + 1));
}

// Blocks of the bf16 K8 kernel for lq rows and m keys that an SM of the
// current device holds at once, or a negative cudaError_t.
int crc_attention_train_folded_forward_blocks_per_sm(int lq, int m) {
  return tc::folded_fwd_blocks_per_sm(lq, m);
}

// K5 written out: out[rows * cols] = keep(seed, b, h, row, col) as 0/1.
int crc_keep_mask(int seed, int b, int h, int rows, int cols, float rate,
                  unsigned char* out, void* stream) {
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(rows) * cols;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256
                                                             : 4096);
  keep_mask_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, b, h, rows, cols, rate, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
