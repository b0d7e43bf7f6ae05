// Tensor-core kernels of the dropout attention for Hopper (sm_90a): the
// bf16 launches without a bias of
//   - K6, ops/pallas_attention_train.py::_fwd_kernel (the stage-II pair
//     cross-attention forward): attn_train_fwd_tc_kernel, the eval
//     kernel's body (attention_tc.cuh) with the K5 mask and 1/(1 - rate)
//     applied to p in its second sweep, before the bf16 rounding;
//   - K7, _bwd_kernel (its backward): attn_train_bwd_tc_{rows,keys}_kernel;
//   - K8, _fwd_kernel_folded (the stage-I MED cross-attention forward):
//     attn_train_fwd_folded_tc_kernel, K6's body with the head stride
//     fixed at kHeadDim at compile time, a two-stage ring and sweep 2's
//     copies marked evict-first in L2 (below);
//   - K9, _bwd_kernel_folded (the stage-I MED cross-attention backward):
//     attn_bwd_tc_{rows,keys}_kernel, K7's passes with the head stride
//     fixed at kHeadDim at compile time.
// K7 and K9, K6 and K8, and K6 and the eval kernels, are __global__ entry
// points of their own over shared device bodies, so a profile and ptxas
// name them apart. fp32 and bias launches stay on the fp32-FMA bodies of
// attention_train.cu (the tensor cores would round fp32 to TF32; no path
// launches K6-K9 with a bias).
//
// K6's and K8's function: p = softmax(fl(q . k^T) * scale) in fp32 with
// a divide; at rate > 0, kept ? fl(p * inv) : 0; rounded to bf16; P.V
// with fp32 sums. The same steps in the same order for both, so K8 on
// [E, L, H*D] gives K6's bits on the [E, L, H, D] copy.
//   - K6 at the stage-II shape [E = 16, Lq = 640, M = 577, H = 12, D =
//     64]: 4*Lq*M*D operations per (entry, head) against (2*Lq + 2*M)*D*2
//     bytes (303 a byte against the card's 295): operations, so the eval
//     kernel's design: wgmma, K/V through a cp.async ring, 128 query rows
//     a block (two warpgroups), the softmax in two sweeps; the mask adds
//     one lowbias32 hash per score in sweep 2.
//   - K8 at the stage-I MED shape [E = 512, Lq = 32 or 40, M = 577, H =
//     12, D = 64]: 37 operations a byte, so bytes: 6,144 (entry, head)
//     blocks of one warpgroup, each reading 148 KB of K and V for 5 KB of
//     q. Two costs above the bytes: sweep 2 reads K again, and the 64-row
//     wgmma tile carries 24-32 rows that do not exist. The body's
//     short-row layout (tile_row()) lets the warp halves that hold no
//     query row skip the exp, the divide, the hash and the packing in both
//     sweeps. The ring has two stages, not three: 41 KB a block, so four
//     blocks (the registers' limit) share an SM, not three; and sweep 2's
//     copies, read once, go first out of L2, so sweep 1's K tiles stay
//     there for sweep 2. Each choice was timed against the others on an
//     H100 (PERF.md): a form that kept every K tile in shared memory
//     from sweep 1 to sweep 2 (113 KB, two blocks an SM) moved the bytes
//     of the bound but lost to the ring on latency.
//
// The backward's function, per (entry b, head h), with the K5 mask
// keep(seed, b, h, row, col = key) and inv = 1 / (1 - rate):
//   p = softmax(fl(q . k^T) * scale) in fp32, with a divide;
//   dropped = keep ? p * inv : 0 (fp32);
//   dv = dropped^T . g, with fp32 dropped and g upcast from bf16;
//   d_dropped = g . v^T; d_probs = keep ? d_dropped * inv : 0;
//   d_scores = p * (d_probs - sum(d_probs * p)) * scale, rounded to bf16;
//   dq = d_scores . k and dk = d_scores^T . q (q unscaled), fp32 sums,
//   rounded on output.
// (At rate 0 there is no mask and no multiply by inv, as in JAX.)
//
// What bounds the backward on the H100:
//   - K7 at the stage-II shape [16, 640, 577, 12, 64]: operations. Per
//     (entry, head) 10*Lq*M*D = 236 M operations against (3*Lq + 4*M)*D*2
//     = 541 KB (437 a byte; the card's ridge is 295).
//   - K9 at the stage-I shape [E = 512, Lq <= 40, M = 577, H = 12, D =
//     64]: bytes. 14.8 M operations against 311 KB (48 a byte): with 40
//     query rows, K and V see little reuse.
//
// Design: the deterministic, atomic-free split of the FMA passes, every
// product on wgmma m64n64k16 in the eval kernel's two forms (wgmma_ss,
// both operands K-major from swizzled tiles; wgmma_rs_tn, A from
// registers, B MN-major):
//   - ROW pass, a block (one warpgroup) per (64 query rows, head, entry),
//     K and V tiles through a cp.async ring, two sweeps over the 64-key
//     tiles:
//       sweep 1: S = Q.K^T and dP = G.V^T (one commit); each row's max,
//         sum of exp(s - max) and D = sum(d_probs * exp(s - max)), both
//         rescaled when the max grows (online); delta = D / sum;
//       sweep 2: S and dP again; p = exp(s - max) / sum (the correctly
//         rounded quotient, divide()), the mask, d_scores rounded to bf16
//         and packed from the accumulator as A; dQ += dS.K with K's tile
//         read MN-major, as V in the eval kernel's P.V;
//     then dq, and each row's (max, sum, delta) to an fp32 scratch.
//     K and V are read twice per row tile (the second time mostly from
//     L2); the online delta differs from JAX's sum(d_probs * p) in fp32
//     rounding only (d_scores is rounded to bf16 after it).
//   - KEY pass, a block per (64 keys, head, entry), the key tile's K and V
//     held, 64-row chunks of Q, G and the row statistics through a
//     two-stage ring:
//       S^T = K.Q^T and dP^T = V.G^T (the eval kernel's scores() with the
//         operands swapped: accumulator element (i, j) is key key0 + i,
//         query row r0 + j, so the mask hash takes (row = r0 + j, col =
//         key0 + i) with cols = M, the salt the absolute entry);
//       p from the row pass's statistics, the mask, d_scores as above;
//       dV += dropped^T.G with dropped split into bf16 hi + lo (lo =
//         dropped - hi, exact in fp32; hi + lo holds dropped to about
//         2^-17 of its value, against bf16's 2^-9), two wgmma_rs_tn into
//         one accumulator, so dv keeps the fp32 product's precision;
//       dK += dS^T.Q (Q unscaled), both with the chunk's tile MN-major.
//     One chunk at Lq <= 64 (K9): Q, G, K, V are each read once; ten at
//     K7's Lq = 640, the dk and dv accumulators held across them.
//   The two passes form S and S^T with different operand orders, so a
//   score may differ in its last fp32 bit between them; the bf16 rounding
//   of d_scores and the tolerance cover it.
// Blocks at K7's shape: the row pass 10 per (entry, head), 1,920 in all,
// three an SM (146 registers); the key pass 10 per (entry, head), 1,920.
// The row pass's blocks hold one warpgroup, not two: 128-row blocks read
// K and V half as often, but at 153 registers x 256 threads one block
// fits an SM, and K7 took 0.61 ms with them against 0.55 with one
// warpgroup on an H100 (PERF.md). Each score is formed three times
// (twice by the row pass, once by the key pass) and the hash evaluated
// three times: 3.3x the forward's products.
// Alignment: every base pointer and entry, row and head stride of q, k,
// v and g 16-byte aligned (16-byte copies), of dq, dk, dv and K6's out
// 4-byte aligned (bf16 pairs); the C entry points refuse anything else.

#pragma once

#include "attention_tc.cuh"

namespace crc {

struct BwdStrides {
  // element strides (entry, row, head) of q, k, v, g, dq, dk, dv
  long long q[3], k[3], v[3], g[3], dq[3], dk[3], dv[3];
  long long b[2];
};

// The folded layout's head stride, fixed at compile time (K8, K9): with
// the kernels' bodies inlined, head offsets become h * kHeadDim.
__device__ __forceinline__ Strides folded(Strides st) {
  st.q[2] = st.k[2] = st.v[2] = st.o[2] = kHeadDim;
  return st;
}

__device__ __forceinline__ BwdStrides folded(BwdStrides st) {
  st.q[2] = st.k[2] = st.v[2] = st.g[2] = kHeadDim;
  st.dq[2] = st.dk[2] = st.dv[2] = kHeadDim;
  return st;
}

namespace tc {

constexpr int kKeyStages = 2;  // key pass: (Q, G) chunks in flight

// Row pass: the Q and G tiles, then the ring of (K, V) pairs.
inline size_t bwd_rows_smem_bytes() {
  return static_cast<size_t>(2 + 2 * kStages) * kTileBytes + 1024;
}

// Key pass: the K and V tiles, the ring of (Q, G) chunk pairs, and each
// stage's row statistics (-max * c, sum, 1 / sum, delta for 64 rows).
inline size_t bwd_keys_smem_bytes() {
  return static_cast<size_t>(2 + 2 * kKeyStages) * kTileBytes +
         kKeyStages * 4 * kRowsPerWg * sizeof(float) + 1024;
}

// D1 = A1.B1^T and D2 = A2.B2^T, all four 64 x 64 swizzled tiles K-major,
// issued together and waited for once.
__device__ __forceinline__ void scores_pair(float (&d1)[32], uint32_t a1,
                                            uint32_t b1, float (&d2)[32],
                                            uint32_t a2, uint32_t b2) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    wgmma_ss(d1, desc_sw128(a1 + 32 * kk), desc_sw128(b1 + 32 * kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    wgmma_ss(d2, desc_sw128(a2 + 32 * kk), desc_sw128(b2 + 32 * kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(d1);
  fence_acc(d2);
}

// d_probs of one element: the mask and inv at rate > 0, d_dropped itself
// at rate 0 (JAX applies neither then); the product is not fused.
__device__ __forceinline__ float d_probs(float dd, bool kept,
                                         const Dropout& drop) {
  if (drop.rate <= 0.f) return dd;
  return kept ? __fmul_rn(dd, drop.inv) : 0.f;
}

__device__ __forceinline__ bool kept_at(uint32_t salt, int row, int m,
                                        int key, const Dropout& drop) {
  return drop.rate <= 0.f || keep_elem(salt, row, m, key, drop.rate);
}

// fl(fl(p * fl(dp - delta)) * scale) rounded to bf16, JAX's order
__device__ __forceinline__ float d_score(float p, float dp, float delta,
                                         float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// Row pass, sweep 1 on one tile: per row the running max (accumulator
// units), and the quad-partial sum of e = exp(scale * (s - max)) and of
// d_probs * e, both rescaled when the max grows. kMask: keys past m count
// as -inf (their dP is 0: V's rows are zero-filled).
template <bool kMask>
__device__ __forceinline__ void tile_stats_delta(
    float (&s)[32], const float (&dp)[32], int key0, int m, int quad,
    float c, int row_base, uint32_t salt, const Dropout& drop,
    float (&row_max)[2], float (&row_sum)[2], float (&row_d)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_base + 8 * hh;
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float& x = s[4 * i + 2 * hh + b];
        if (kMask && key0 + 8 * i + 2 * quad + b >= m) x = -INFINITY;
        tmax = fmaxf(tmax, x);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float mx = fmaxf(row_max[hh], tmax);
    const float neg_mc = -mx * c;
    float part = 0.f, dpart = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int idx = 4 * i + 2 * hh + b;
        const int key = key0 + 8 * i + 2 * quad + b;
        const float ex = ex2(fmaf(s[idx], c, neg_mc));
        part += ex;
        dpart = fmaf(d_probs(dp[idx], kept_at(salt, row, m, key, drop), drop),
                     ex, dpart);
      }
    const float alpha = ex2(fmaf(row_max[hh], c, neg_mc));
    row_sum[hh] = row_sum[hh] * alpha + part;
    row_d[hh] = row_d[hh] * alpha + dpart;
    row_max[hh] = mx;
  }
}

// Row pass, sweep 2 on one tile: d_scores in bf16, packed as the A operand
// of dS.K (k-step kk takes keys 16kk..16kk+15, i.e. s[8kk .. 8kk+7]);
// keys past m (kMask) give 0.
template <bool kMask>
__device__ __forceinline__ void tile_dscores(
    const float (&s)[32], const float (&dp)[32], int key0, int m, int quad,
    float c, int row_base, uint32_t salt, const Dropout& drop, float scale,
    const float (&neg_mc)[2], const float (&sum)[2], const float (&inv)[2],
    const float (&delta)[2], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = 8 * kk + 2 * r;
      const int hh = r & 1;
      const int row = row_base + 8 * hh;
      const int key = key0 + 16 * kk + 8 * (r >> 1) + 2 * quad;
      float ds[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float p = divide(ex2(fmaf(s[idx + b], c, neg_mc[hh])), sum[hh],
                               inv[hh]);
        const bool kept = kept_at(salt, row, m, key + b, drop);
        ds[b] = d_score(p, d_probs(dp[idx + b], kept, drop), delta[hh],
                        scale);
        if (kMask && key + b >= m) ds[b] = 0.f;
      }
      a[kk][r] = pack_bf16(ds[0], ds[1]);
    }
}

// ROW pass, one warpgroup. Grid: (ceil(lq / 64), heads, entries).
// stats: fp32 [3][entries][heads][lq] = max (accumulator units), sum,
// delta of every row.
__device__ __forceinline__ void bwd_rows_tc_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, int entries,
    int heads, int lq, int m, float scale, const BwdStrides& st,
    const Dropout& drop) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t g_tile = base + kTileBytes;
  const uint32_t ring = base + 2 * kTileBytes;
  // stage s: K tile at ring + 2s * kTileBytes, V tile right after it

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * kRowsPerWg;
  const long long h = blockIdx.y;
  const long long e = blockIdx.z;
  const __nv_bfloat16* qb = q + e * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + e * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + e * st.v[0] + h * st.v[2];
  const __nv_bfloat16* gb = g + e * st.g[0] + h * st.g[2];
  __nv_bfloat16* dqb = dq + e * st.dq[0] + h * st.dq[2];

  const int n_tiles = (m + kTileKeys - 1) / kTileKeys;
  const int n_steps = 2 * n_tiles;  // both sweeps load K and V

  auto load_step = [&](int step) {
    const int stage = step % kStages;
    const int j = step < n_tiles ? step : step - n_tiles;
    const uint32_t kt = ring + 2 * stage * kTileBytes;
    load_tile(kt, kb, st.k[1], j * kTileKeys, m, tid, 128);
    load_tile(kt + kTileBytes, vb, st.v[1], j * kTileKeys, m, tid, 128);
  };

  // prologue: the Q and G tiles ride with step 0's group
  load_tile(q_tile, qb, st.q[1], row0, lq, tid, 128);
  load_tile(g_tile, gb, st.g[1], row0, lq, tid, 128);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }

  const int quad = lane & 3;
  const float c = scale * kLog2e;  // exp(scale * x) = 2^(c * x)
  const uint32_t salt =
      keep_salt(drop.seed, static_cast<int>(e), static_cast<int>(h));
  const int row_base = row0 + 16 * warp + lane / 4;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  float row_d[2] = {0.f, 0.f};
  float neg_mc[2], inv[2], delta[2];
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's tiles have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; the oldest stage is free
    if (step + kStages - 1 < n_steps) load_step(step + kStages - 1);
    cp_async_commit();

    const int stage = step % kStages;
    const uint32_t kt = ring + 2 * stage * kTileBytes;
    const bool sweep1 = step < n_tiles;
    const int key0 = (sweep1 ? step : step - n_tiles) * kTileKeys;
    const bool ragged = key0 + kTileKeys > m;  // only the last tile
    float s[32], dp[32];
    scores_pair(s, q_tile, kt, dp, g_tile, kt + kTileBytes);

    if (sweep1) {
      if (ragged)
        tile_stats_delta<true>(s, dp, key0, m, quad, c, row_base, salt, drop,
                               row_max, row_sum, row_d);
      else
        tile_stats_delta<false>(s, dp, key0, m, quad, c, row_base, salt,
                                drop, row_max, row_sum, row_d);
      if (step == n_tiles - 1) {
        // the quad's partial sums share one max: add them
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
          row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
          row_d[hh] += __shfl_xor_sync(0xffffffffu, row_d[hh], 1);
          row_d[hh] += __shfl_xor_sync(0xffffffffu, row_d[hh], 2);
          neg_mc[hh] = -row_max[hh] * c;
          inv[hh] = __frcp_rn(row_sum[hh]);
          delta[hh] = __fdiv_rn(row_d[hh], row_sum[hh]);
        }
      }
      continue;
    }

    uint32_t a[4][4];
    if (ragged)
      tile_dscores<true>(s, dp, key0, m, quad, c, row_base, salt, drop, scale,
                         neg_mc, row_sum, inv, delta, a);
    else
      tile_dscores<false>(s, dp, key0, m, quad, c, row_base, salt, drop,
                          scale, neg_mc, row_sum, inv, delta, a);
    wgmma_fence();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tn(o, a[kk], desc_sw128(kt + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(o);
  }

  const long long plane = static_cast<long long>(entries) * heads * lq;
  float* mstat = stats + (e * heads + h) * lq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_base + 8 * hh;
    if (row >= lq) continue;
    __nv_bfloat16* drow = dqb + row * st.dq[1];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * i + 2 * quad) =
          __floats2bfloat162_rn(o[4 * i + 2 * hh], o[4 * i + 2 * hh + 1]);
    if (quad == 0) {
      mstat[row] = row_max[hh];
      mstat[plane + row] = row_sum[hh];
      mstat[2 * plane + row] = delta[hh];
    }
  }
}

// KEY pass. Grid: (ceil(m / 64), heads, entries), one warpgroup. Reads the
// row pass's stats.
__device__ __forceinline__ void bwd_keys_tc_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const float* __restrict__ stats, int entries, int heads, int lq, int m,
    float scale, const BwdStrides& st, const Dropout& drop) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gen_base = smem_raw + (base - raw);  // the same address
  const uint32_t k_tile = base;
  const uint32_t v_tile = base + kTileBytes;
  const uint32_t ring = base + 2 * kTileBytes;
  // stage s: Q chunk at ring + 2s * kTileBytes, G chunk right after it;
  // then each stage's row statistics, 4 x 64 floats
  float* const row_stats = reinterpret_cast<float*>(
      gen_base + (2 + 2 * kKeyStages) * kTileBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane & 3;
  const int key0 = blockIdx.x * kTileKeys;
  const long long h = blockIdx.y;
  const long long e = blockIdx.z;
  const __nv_bfloat16* qb = q + e * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + e * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + e * st.v[0] + h * st.v[2];
  const __nv_bfloat16* gb = g + e * st.g[0] + h * st.g[2];
  const long long plane = static_cast<long long>(entries) * heads * lq;
  const float* mstat = stats + (e * heads + h) * lq;
  const float c = scale * kLog2e;

  const int n_chunks = (lq + kRowsPerWg - 1) / kRowsPerWg;
  auto load_step = [&](int step) {
    const int stage = step % kKeyStages;
    const int r0 = step * kRowsPerWg;
    const uint32_t qc = ring + 2 * stage * kTileBytes;
    load_tile(qc, qb, st.q[1], r0, lq, tid, 128);
    load_tile(qc + kTileBytes, gb, st.g[1], r0, lq, tid, 128);
    // rows past lq: exp(-inf) = 0 gives p = 0, and their G rows are 0
    float* rs = row_stats + stage * 4 * kRowsPerWg;
    for (int i = tid; i < kRowsPerWg; i += 128) {
      const int row = r0 + i;
      const bool ok = row < lq;
      const float sum = ok ? mstat[plane + row] : 1.f;
      rs[i] = ok ? -mstat[row] * c : -INFINITY;
      rs[kRowsPerWg + i] = sum;
      rs[2 * kRowsPerWg + i] = __frcp_rn(sum);
      rs[3 * kRowsPerWg + i] = ok ? mstat[2 * plane + row] : 0.f;
    }
  };

  // prologue: the K and V tiles ride with chunk 0's group
  load_tile(k_tile, kb, st.k[1], key0, m, tid, 128);
  load_tile(v_tile, vb, st.v[1], key0, m, tid, 128);
#pragma unroll
  for (int s = 0; s < kKeyStages - 1; ++s) {
    if (s < n_chunks) load_step(s);
    cp_async_commit();
  }

  const uint32_t salt =
      keep_salt(drop.seed, static_cast<int>(e), static_cast<int>(h));
  // this thread's accumulator rows are keys key_base (+8)
  const int key_base = key0 + 16 * warp + lane / 4;
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int step = 0; step < n_chunks; ++step) {
    cp_async_wait<kKeyStages - 2>();  // this chunk has landed
    fence_proxy_async();
    __syncthreads();  // ... and its statistics; the oldest stage is free
    if (step + kKeyStages - 1 < n_chunks) load_step(step + kKeyStages - 1);
    cp_async_commit();

    const int stage = step % kKeyStages;
    const uint32_t qc = ring + 2 * stage * kTileBytes;
    const uint32_t gc = qc + kTileBytes;
    const float* rs = row_stats + stage * 4 * kRowsPerWg;
    const int r0 = step * kRowsPerWg;
    float s[32], dp[32];
    // S^T = K.Q^T, dP^T = V.G^T: element (i, j) is key i, query row j
    scores_pair(s, k_tile, qc, dp, v_tile, gc);

    uint32_t hi[4][4], lo[4][4], ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = 8 * kk + 2 * r;
        const int key = key_base + 8 * (r & 1);
        const int j0 = 16 * kk + 8 * (r >> 1) + 2 * quad;  // chunk row
        float dh[2], dl[2], dsv[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int j = j0 + b;
          const float p =
              divide(ex2(fmaf(s[idx + b], c, rs[j])), rs[kRowsPerWg + j],
                     rs[2 * kRowsPerWg + j]);
          const bool kept = kept_at(salt, r0 + j, m, key, drop);
          const float dropped = drop.rate <= 0.f ? p
                                : kept           ? __fmul_rn(p, drop.inv)
                                                 : 0.f;
          const __nv_bfloat16 h16 = __float2bfloat16_rn(dropped);
          dh[b] = __bfloat162float(h16);
          dl[b] = dropped - dh[b];  // exact
          dsv[b] = d_score(p, d_probs(dp[idx + b], kept, drop),
                           rs[3 * kRowsPerWg + j], scale);
        }
        hi[kk][r] = pack_bf16(dh[0], dh[1]);
        lo[kk][r] = pack_bf16(dl[0], dl[1]);
        ds[kk][r] = pack_bf16(dsv[0], dsv[1]);
      }
    wgmma_fence();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tn(dv_acc, hi[kk], desc_sw128(gc + kk * 16 * 128));
      wgmma_rs_tn(dv_acc, lo[kk], desc_sw128(gc + kk * 16 * 128));
      wgmma_rs_tn(dk_acc, ds[kk], desc_sw128(qc + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key_base + 8 * hh;
    if (key >= m) continue;
    __nv_bfloat16* krow = dk + e * st.dk[0] + h * st.dk[2] + key * st.dk[1];
    __nv_bfloat16* vrow = dv + e * st.dv[0] + h * st.dv[2] + key * st.dv[1];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 8 * i + 2 * quad;
      *reinterpret_cast<__nv_bfloat162*>(krow + d) = __floats2bfloat162_rn(
          dk_acc[4 * i + 2 * hh], dk_acc[4 * i + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + d) = __floats2bfloat162_rn(
          dv_acc[4 * i + 2 * hh], dv_acc[4 * i + 2 * hh + 1]);
    }
  }
}

#define CRC_TC_ROWS_ARGS                                                     \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k, \
      const __nv_bfloat16 *__restrict__ v,                                  \
      const __nv_bfloat16 *__restrict__ g, __nv_bfloat16 *__restrict__ dq,  \
      float *__restrict__ stats, int entries, int heads, int lq, int m,     \
      float scale, BwdStrides st, Dropout drop
#define CRC_TC_KEYS_ARGS                                                     \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k, \
      const __nv_bfloat16 *__restrict__ v,                                  \
      const __nv_bfloat16 *__restrict__ g, __nv_bfloat16 *__restrict__ dk,  \
      __nv_bfloat16 *__restrict__ dv, const float *__restrict__ stats,      \
      int entries, int heads, int lq, int m, float scale, BwdStrides st,    \
      Dropout drop

// K7's passes: general (entry, row, head) strides
__global__ void __launch_bounds__(128, 3)
attn_train_bwd_tc_rows_kernel(CRC_TC_ROWS_ARGS) {
  bwd_rows_tc_body(q, k, v, g, dq, stats, entries, heads, lq, m, scale, st,
                   drop);
}

__global__ void __launch_bounds__(128, 2)
attn_train_bwd_tc_keys_kernel(CRC_TC_KEYS_ARGS) {
  bwd_keys_tc_body(q, k, v, g, dk, dv, stats, entries, heads, lq, m, scale,
                   st, drop);
}

// K9's passes: K7's with the folded head stride
__global__ void __launch_bounds__(128, 3)
attn_bwd_tc_rows_kernel(CRC_TC_ROWS_ARGS) {
  bwd_rows_tc_body(q, k, v, g, dq, stats, entries, heads, lq, m, scale,
                   folded(st), drop);
}

__global__ void __launch_bounds__(128, 2)
attn_bwd_tc_keys_kernel(CRC_TC_KEYS_ARGS) {
  bwd_keys_tc_body(q, k, v, g, dk, dv, stats, entries, heads, lq, m, scale,
                   folded(st), drop);
}

#undef CRC_TC_ROWS_ARGS
#undef CRC_TC_KEYS_ARGS

// K6: the eval kernel's body with its dropout switch on, no bias, general
// strides
template <int kWarpgroups>
__global__ void __launch_bounds__(kWarpgroups * 128, 4 / kWarpgroups)
attn_train_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int lq, int m,
                         float scale, Strides st, Dropout drop) {
  attn_fwd_tc_body<kWarpgroups, false, true>(q, k, v, nullptr, out, lq, m,
                                             scale, st, drop);
}

// K8: K6's kernel at the folded head stride, with a ring of kK8Stages
// stages and sweep 2's copies marked evict-first in L2
constexpr int kK8Stages = 2;

template <int kWarpgroups>
__global__ void __launch_bounds__(kWarpgroups * 128, 4 / kWarpgroups)
attn_train_fwd_folded_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ out, int lq,
                                int m, float scale, Strides st,
                                Dropout drop) {
  attn_fwd_tc_body<kWarpgroups, false, true, kK8Stages, true>(
      q, k, v, nullptr, out, lq, m, scale, folded(st), drop);
}

// 16-byte copies of q, k, v and g need 16-byte-aligned rows; dq, dk and
// dv are written as bf16 pairs
inline bool bwd_aligned(const void* q, const void* k, const void* v,
                        const void* g, const void* dq, const void* dk,
                        const void* dv, const BwdStrides& st) {
  auto a = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  for (int i = 0; i < 3; ++i)
    if (st.q[i] % 8 || st.k[i] % 8 || st.v[i] % 8 || st.g[i] % 8 ||
        st.dq[i] % 2 || st.dk[i] % 2 || st.dv[i] % 2)
      return false;
  return a(q, 16) && a(k, 16) && a(v, 16) && a(g, 16) && a(dq, 4) &&
         a(dk, 4) && a(dv, 4);
}

// The forward kernel of K6 (kFolded false) or K8 (true) with kWarpgroups
// warpgroups a block, and its dynamic shared memory for m keys.
template <int kWarpgroups, bool kFolded>
constexpr auto train_fwd_kernel() {
  if constexpr (kFolded)
    return attn_train_fwd_folded_tc_kernel<kWarpgroups>;
  else
    return attn_train_fwd_tc_kernel<kWarpgroups>;
}

template <bool kFolded>
size_t train_fwd_smem_bytes(int warpgroups, int m) {
  return smem_bytes(warpgroups, m, kFolded ? kK8Stages : kStages);
}

// Sets the kernel's attributes on the current device once, for the most
// shared memory a launch of it takes (configure_once).
template <int kWarpgroups, bool kFolded>
cudaError_t configure_train_fwd() {
  static std::atomic<bool> done[kMaxDevices];
  return configure_once(
      done,
      reinterpret_cast<const void*>(train_fwd_kernel<kWarpgroups, kFolded>()),
      train_fwd_smem_bytes<kFolded>(kWarpgroups, kTileKeys + 1));
}

template <int kWarpgroups, bool kFolded>
cudaError_t launch_train_fwd_wg(const void* q, const void* k, const void* v,
                                void* out, int entries, int heads, int lq,
                                int m, float scale, const Strides& st,
                                const Dropout& drop, cudaStream_t stream) {
  const cudaError_t err = configure_train_fwd<kWarpgroups, kFolded>();
  if (err != cudaSuccess) return err;
  const auto kernel = train_fwd_kernel<kWarpgroups, kFolded>();
  constexpr int rows = kWarpgroups * kRowsPerWg;
  const dim3 grid((lq + rows - 1) / rows, heads, entries);
  kernel<<<grid, kWarpgroups * 128,
           train_fwd_smem_bytes<kFolded>(kWarpgroups, m), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lq, m, scale, st, drop);
  return cudaGetLastError();
}

// K6 (kFolded false) or K8 (true): one warpgroup (64 rows) a block up to
// 64 query rows, two above. The caller has checked the alignment
// (aligned()).
template <bool kFolded>
int launch_train_fwd(const void* q, const void* k, const void* v, void* out,
                     int entries, int heads, int lq, int m, float scale,
                     const Strides& st, const Dropout& drop,
                     cudaStream_t stream) {
  return static_cast<int>(
      lq > kRowsPerWg
          ? launch_train_fwd_wg<2, kFolded>(q, k, v, out, entries, heads, lq,
                                            m, scale, st, drop, stream)
          : launch_train_fwd_wg<1, kFolded>(q, k, v, out, entries, heads, lq,
                                            m, scale, st, drop, stream));
}

// Blocks of K8's kernel for lq rows and m keys that an SM of the current
// device holds at once, or a negative cudaError_t.
template <int kWarpgroups>
int folded_fwd_occupancy(int m) {
  cudaError_t err = configure_train_fwd<kWarpgroups, true>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, train_fwd_kernel<kWarpgroups, true>(), kWarpgroups * 128,
        train_fwd_smem_bytes<true>(kWarpgroups, m));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

inline int folded_fwd_blocks_per_sm(int lq, int m) {
  return lq > kRowsPerWg ? folded_fwd_occupancy<2>(m)
                         : folded_fwd_occupancy<1>(m);
}

// K7 (kFolded false) or K9 (true): the row pass, then the key pass, on
// one stream. The caller has checked the alignment (bwd_aligned()).
template <bool kFolded>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, float* stats, int entries,
               int heads, int lq, int m, float scale, const BwdStrides& st,
               const Dropout& drop, cudaStream_t stream) {
  static std::atomic<bool> rows_done[kMaxDevices], keys_done[kMaxDevices];
  auto rows = attn_train_bwd_tc_rows_kernel;
  auto keys = attn_train_bwd_tc_keys_kernel;
  if constexpr (kFolded) {
    rows = attn_bwd_tc_rows_kernel;
    keys = attn_bwd_tc_keys_kernel;
  }
  cudaError_t err = configure_once(
      rows_done, reinterpret_cast<const void*>(rows), bwd_rows_smem_bytes());
  if (err == cudaSuccess)
    err = configure_once(keys_done, reinterpret_cast<const void*>(keys),
                         bwd_keys_smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const dim3 grid_rows((lq + kRowsPerWg - 1) / kRowsPerWg, heads, entries);
  rows<<<grid_rows, 128, bwd_rows_smem_bytes(), stream>>>(
      qp, kp, vp, gp, static_cast<__nv_bfloat16*>(dq), stats, entries, heads,
      lq, m, scale, st, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_keys((m + kTileKeys - 1) / kTileKeys, heads, entries);
  keys<<<grid_keys, 128, bwd_keys_smem_bytes(), stream>>>(
      qp, kp, vp, gp, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), stats, entries, heads, lq, m, scale,
      st, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace crc
