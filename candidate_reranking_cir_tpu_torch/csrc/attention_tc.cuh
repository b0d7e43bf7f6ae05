// Tensor-core eval attention for Hopper (sm_90a): every bf16 launch of the
// eval kernels. It replaces, for those launches, the JAX package's
// ops/pallas_attention.py
//   - _attn_kernel_folded      (K1: q/k/v [E, L, H*D], head stride 64),
//   - _attn_bias_kernel        (K2: q/k/v [E, L, H, D] + bias [E, Lq, M]),
//   - _attn_kernel             (K3: q/k/v [E, L, H, D]),
//   - _attn_bias_kernel_folded (K4: K1's layout + K2's bias),
// all through _head_attention. Layouts differ only in strides; the bias
// is a template switch. fp32 stays on attn_fwd_body (attention_common.cuh):
// the tensor cores would round fp32 inputs to TF32. The body below also
// carries K6, the stage-II dropout forward (attention_train_tc.cuh), with
// its dropout switch on.
//
// The function, per (entry, head), is the one the plain version and the
// Pallas kernels compute: fp32 scores times the scale 1/sqrt(d) (folded
// into q by JAX where it is a power of two, 1/8 at d = 64; the wrappers
// zero-pad narrower heads to 64 and pass their own scale), (+ the bias,
// added to the scaled score in fp32), max-subtracted exp, a sum, a DIVIDE
// by the
// sum, probabilities rounded to bf16 before P.V, fp32 accumulation of P.V,
// output in bf16. How the kernel computes it on the CUDA cores, where the
// time between the products goes:
//   - q reaches wgmma as bf16, unscaled; without a bias the scale goes
//     onto the fp32 scores with log2(e), in one FMA: exp(scale * (s -
//     max)) = 2^(c*s - c*max), on the special-function unit. With a bias
//     that would be another function: the kernel forms t = fl(fl(s *
//     scale) + bias) first, as JAX adds the bias to the scaled score, and
//     takes max and exp of t (c = log2(e)). The bias is read in fp32 through its (entry, row) strides;
//     a row stride of 0 broadcasts a key mask over the rows. A masked key
//     (-10000) gives 2^(-14427 + ...) = 0 exactly (ex2.approx.ftz);
//   - the divide is the correctly rounded quotient, from one correctly
//     rounded reciprocal per row and a product and two FMAs per score
//     (see divide()), not a reciprocal multiply;
//   - only a tile holding keys past M tests the key index.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): per (entry,
// head) 4*Lq*M*D operations against (2*Lq + 2*M)*D*2 bytes (+ the bias).
//   - K1 in the MED (40 x 577: 37 operations a byte) and, by a hair, in
//     the ViT (577 x 577: 289 against the card's 295): bytes.
//   - K3 at 1,280 rows x 577 keys per candidate (398): operations; at the
//     narrowest call, 32 rows (30): bytes.
//   - K2 on the eval path (Lq = M <= 40 text tokens: 10 operations a
//     byte) and K4: bytes, and at K2's tiny heads, latency: one 40 x 40
//     head is one partial tile (24 of 64 rows idle, 24 of 64 keys padded).
// What the design does about it:
//   - wgmma m64n64k16 (bf16 in, fp32 out) for S = Q.K^T, with Q and K read
//     by descriptor from 128-byte-swizzled shared memory, and for O += P.V
//     with P from registers (the S accumulator re-packed as bf16) and V by
//     descriptor, transposed (MN-major).
//   - one block holds 64 query rows per warpgroup (two warpgroups when
//     Lq > 64), so each K/V tile it loads serves up to 128 rows;
//   - K/V stream through a ring of kStages 64-key tiles by 16-byte
//     cp.async copies, so loads overlap the products;
//   - exact softmax in two sweeps over the key tiles, no score rows in
//     shared memory: sweep 1 keeps each row's max and sum of exp(s - max)
//     (rescaled when the max grows); sweep 2 recomputes each S tile, forms
//     p = exp(s - max) / sum, rounds it to bf16 and accumulates P.V. A
//     one-pass online softmax would round exp(s - running max), not p, to
//     bf16 before P.V: another function. The second sweep costs one more
//     Q.K^T (1.5x the products); its K comes back mostly from L2.
//     No key cap: shared memory does not grow with M.
//   - M <= 64 (one key tile: K2's text self-attention): sweep 1 already
//     holds the exact max and sum, so the kernel forms S once, then p,
//     then P.V, in one step; the block loads Q, K and V together and
//     takes (warpgroups + 2) tiles of shared memory (25 KB with one
//     warpgroup, not the ring's 58 KB), so more blocks share an SM.
//   - short rows: 64 is wgmma's smallest M, and the MED's and the narrow
//     K3 calls' heads have 32-40 query rows. The CUDA-core work between
//     the products (exp, divide, hash, packing) is per row, so the rows of
//     a warpgroup's tile are laid out (tile_row()) to let whole warp
//     halves idle: the first 32 query rows go to the first halves of the
//     four warps, the next 32 to their second halves. A half whose eight
//     rows are all past Lq skips that work in both sweeps and hands the
//     P.V product zeros; the products still cover the 64-row tile. At 32
//     rows each warp skips its second half, so all four of the SM's
//     sub-partitions keep equal shares; at 40, the one warp with a
//     second half turns with the head.
//   - rows past Lq are computed on zeros (or skipped, above) and never
//     stored (they read no bias); keys past M count as -inf in sweep 1
//     and as p = 0 in sweep 2 (their K/V rows are zero-filled by the
//     copies; they read no bias).
//   - K8's form (attention_train_tc.cuh) takes the ring's depth and an L2
//     hint as template arguments: two stages, and sweep 2's copies marked
//     evict-first, so that they do not push sweep 1's K tiles out of L2
//     before sweep 2 reads them again.
// Inputs are strided views: every base pointer and every entry, row and
// head stride of q, k and v must be 16-byte aligned (8 bf16), as 16-byte
// copies need, and the output's 4-byte aligned (it is written as bf16
// pairs); the C entry point refuses anything else (aligned()). The bias
// takes any fp32 strides.
//
// Head width 88 (kWideHeadDim: EVA ViT-g's 16 heads of 1408, BLIP-2's
// vision tower), without a bias: the kDim template argument of the body and
// of attn_fwd_tc_kernel (64 everywhere else). An 88-wide row is 176 bytes,
// eleven 16-byte chunks, so the heads are read in place and the padding to
// the products' widths happens in shared memory (HeadLayout): a row of a
// tile is two 64-lane sub-tiles, each laid out as a d = 64 tile is (the
// same swizzle and descriptors), the second holding lanes 64..87 and a
// zero-filled chunk for lanes 88..95. S = Q.K^T takes six k-steps of 16
// (lanes 0..95, the last eight zeros in Q and K); P.V takes one m64n64 per
// sub-tile (lanes 0..127), and only lanes 0..87 are stored. The products
// run 96/88 (S) and 128/88 (P.V) of the work the head needs; at ViT-g's
// 257 x 257 the attention is about 3% of the tower's operations, and bytes,
// not the products, bound it (128 operations a byte against the card's
// 295). The two accumulators take 32 more registers a thread, so the wide
// kernel asks for one block an SM in its launch bounds.
//
// Head width 72 (kMoonViTHeadDim: MoonViT's 16 heads of 1152, Kimi-VL's
// vision tower) takes the same route: nine chunks a row, the second
// sub-tile holding lanes 64..71 and a zero-filled chunk for lanes 72..79;
// S takes five k-steps (lanes 0..79) and P.V one m64n64 a sub-tile, of
// which lanes 0..71 are stored.

#pragma once

#include <atomic>

#include "attention_common.cuh"

namespace crc {
namespace tc {

constexpr int kRowsPerWg = 64;   // query rows per warpgroup (the wgmma M)
constexpr int kTileKeys = 64;    // keys per K/V tile
constexpr int kStages = 3;       // K/V tiles in flight
constexpr int kTileBytes = kTileKeys * kHeadDim * 2;  // 8 KB, 128-byte rows
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

static_assert(kHeadDim == 64, "a tile row is one 128-byte swizzle row");

constexpr int kWideHeadDim = 88;  // the other head widths (no bias)
constexpr int kMoonViTHeadDim = 72;

// A head of kDim lanes in shared memory: kSubTiles 64-lane sub-tiles of
// kTileBytes each (a d = 64 tile's layout), kChunks 16-byte chunks of the
// head a row, kLoadChunks copied a row (the head rounded up to a k-step of
// 16 lanes; the chunks past the head zero-filled), kKSteps k-steps of S.
template <int kDim>
struct HeadLayout {
  static_assert(kDim % 8 == 0 && kDim <= 128, "8..128 lanes in 16-byte chunks");
  static constexpr int kChunks = kDim / 8;
  static constexpr int kLoadChunks = (kDim + 15) / 16 * 2;
  static constexpr int kSubTiles = (kDim + 63) / 64;
  static constexpr int kKSteps = (kDim + 15) / 16;
  static constexpr int kBytes = kSubTiles * kTileBytes;
  // the bf16 pairs of the last sub-tile's accumulator columns a row stores
  static constexpr int kLastPairs = (kDim - 64 * (kSubTiles - 1)) / 8;
};

// Dynamic shared memory: Q tiles (one per warpgroup), then a ring of
// `stages` (K, V) tile pairs, of which one key tile (m <= 64) uses the
// first only; +1 KB to align the start to the 1,024-byte swizzle atom.
// `sub_tiles`: HeadLayout's kSubTiles (a tile of a wide head is that many
// d = 64 tiles).
inline size_t smem_bytes(int warpgroups, int m, int stages = kStages,
                         int sub_tiles = 1) {
  if (m <= kTileKeys) stages = 1;
  return static_cast<size_t>(warpgroups + 2 * stages) * sub_tiles *
             kTileBytes + 1024;
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
// (Swizzle<3,4,3>: the chunk index XOR the row's position in its 8-row
// atom), the layout wgmma's SWIZZLE_128B descriptors read.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}
// an L2 policy that evicts the lines it loads first, for data read once
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async16_hint(uint32_t dst, const void* src,
                                                int src_bytes,
                                                uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      ::"r"(dst), "l"(src), "r"(src_bytes), "l"(policy));
}
// the copies wrote shared memory through the generic proxy; wgmma reads
// it through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Chunk i of a tile's copy, of kLoadChunks a row: its row r, its chunk c
// within the row, and whether c lies inside the head (chunks past it are
// zero-filled and read no memory). At d = 64 a row is eight chunks, all of
// the head.
template <int kDim>
__device__ __forceinline__ void tile_chunk(int i, int& r, int& c,
                                           bool& in_head) {
  using L = HeadLayout<kDim>;
  if constexpr (L::kLoadChunks == 8) {
    r = i >> 3;
    c = i & 7;
  } else {
    r = i / L::kLoadChunks;
    c = i % L::kLoadChunks;
  }
  in_head = L::kChunks == L::kLoadChunks || c < L::kChunks;
}

// Where chunk c of row r lands: its sub-tile, then the 128-byte swizzle.
template <int kDim>
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  if constexpr (HeadLayout<kDim>::kSubTiles == 1) return swz(r, c);
  return static_cast<uint32_t>((c >> 3) * kTileBytes) + swz(r, c & 7);
}

// Rows [row0, row0 + 64) of a [rows, kDim] bf16 view into a swizzled tile
// (HeadLayout<kDim>); rows at or past `rows` are zero-filled (and read no
// memory). kHint: the copies carry the L2 `policy`.
template <bool kHint = false, int kDim = kHeadDim>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int rows, int tid, int nthreads,
                                          uint64_t policy = 0) {
  for (int i = tid; i < kTileKeys * HeadLayout<kDim>::kLoadChunks;
       i += nthreads) {
    int r, c;
    bool in_head;
    tile_chunk<kDim>(i, r, c, in_head);
    const int row = row0 + r;
    const bool ok = row < rows && in_head;
    const __nv_bfloat16* src =
        base + (ok ? row : 0) * row_stride + (in_head ? c : 0) * 8;
    if constexpr (kHint)
      cp_async16_hint(dst + chunk_at<kDim>(r, c), src, ok ? 16 : 0, policy);
    else
      cp_async16(dst + chunk_at<kDim>(r, c), src, ok ? 16 : 0);
  }
}

// The query row (of a warpgroup's 64) that accumulator row 16w + 8h + i
// holds (warp w, half h, i = lane / 4): 32h + 8((w + rot) & 3) + i. The
// first 32 query rows fill the four warps' first halves, so a tile of at
// most 32 rows leaves every second half idle; rot (the head) turns which
// warp holds rows 8j..8j+7 and 32+8j..32+8j+7.
__device__ __forceinline__ int tile_row(int w, int h, int i, int rot) {
  return 32 * h + 8 * ((w + rot) & 3) + i;
}

// The Q tile of rows [row0, row0 + 64) of a [rows, kDim] bf16 view in
// tile_row()'s order; rows at or past `rows` are zero-filled.
template <int kDim = kHeadDim>
__device__ __forceinline__ void load_q_tile(uint32_t dst,
                                            const __nv_bfloat16* base,
                                            long long row_stride, int row0,
                                            int rows, int rot, int tid,
                                            int nthreads) {
  for (int i = tid; i < kRowsPerWg * HeadLayout<kDim>::kLoadChunks;
       i += nthreads) {
    int r, c;
    bool in_head;
    tile_chunk<kDim>(i, r, c, in_head);
    const int row = row0 + tile_row(r >> 4, (r >> 3) & 1, r & 7, rot);
    const bool ok = row < rows && in_head;
    cp_async16(dst + chunk_at<kDim>(r, c),
               base + (ok ? row : 0) * row_stride + (in_head ? c : 0) * 8,
               ok ? 16 : 0);
  }
}

// K-major or MN-major operand of one 64 x 64 bf16 tile in 128-byte-swizzled
// rows: start address, leading offset 16 B (unused by swizzled layouts at
// this width), stride between 8-row groups 1,024 B, SWIZZLE_128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous product
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CRC_WGMMA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define CRC_WGMMA_OUT32(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// D (+)= A.B^T, A [64 x 16] and B [64 x 16] both K-major from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CRC_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CRC_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A.B, A [64 x 16] bf16 from registers, B [16 x 64] MN-major (N
// contiguous) from shared memory
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CRC_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CRC_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit; results below 2^-126 flush to 0 (a
// probability that small is 0 after the bf16 rounding's smallest normal
// anyway, and adds nothing to a sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p / sum, correctly rounded, from inv = the correctly rounded 1 / sum:
// q0 = p * inv is within an ulp of the quotient, the FMA gives the exact
// remainder p - q0 * sum, and one more FMA rounds q0 + rem * inv to the
// correctly rounded quotient (Markstein), the IEEE divide's result at a
// product and two FMAs per element
__device__ __forceinline__ float divide(float p, float sum, float inv) {
  const float q0 = __fmul_rn(p, inv);
  return __fmaf_rn(__fmaf_rn(-q0, sum, p), inv, q0);
}

// The bias variant's scores: t = fl(fl(s * scale) + bias), the bias added
// to the scaled score in fp32, as JAX adds it (two roundings, no FMA: at
// a scale that is not a power of two, s * scale is not exact). rows[h]:
// the query row of
// the thread's half h. Rows at or past lq and keys at or past m (kMask)
// read no bias: the former are never stored, the latter become -inf in
// tile_stats.
template <bool kMask>
__device__ __forceinline__ void add_bias(float (&s)[32],
                                         const float* __restrict__ bias,
                                         long long row_stride,
                                         const int (&rows)[2], int lq,
                                         int key0, int m, int quad,
                                         float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rows[hh];
    const float* brow = bias + (row < lq ? row : 0) * row_stride;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int key = key0 + 8 * i + 2 * quad + b;
        float& x = s[4 * i + 2 * hh + b];
        const bool read = row < lq && (!kMask || key < m);
        x = __fadd_rn(__fmul_rn(x, scale), read ? __ldg(brow + key) : 0.f);
      }
  }
}

// Sweep 1 on one tile: each row's running max (in accumulator units: the
// scale is positive) and the quad-partial sum of exp(scale * (s - max)),
// rescaled when the max grows. c = scale * log2(e) (with a bias the scores
// are already scaled and c = log2(e)). kMask: the tile holds keys past m,
// which count as -inf. kHalves: the warp's halves that hold query rows
// (1: the second half's rows are all past lq and keep no statistics).
template <bool kMask, int kHalves>
__device__ __forceinline__ void tile_stats(float (&s)[32], int key0, int m,
                                           int quad, float c,
                                           float (&row_max)[2],
                                           float (&row_sum)[2]) {
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh) {
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
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        part += ex2(fmaf(s[4 * i + 2 * hh + b], c, neg_mc));
    row_sum[hh] = row_sum[hh] * ex2(fmaf(row_max[hh], c, neg_mc)) + part;
    row_max[hh] = mx;
  }
}

// Sweep 2 on one tile: p = exp(scale * (s - max)) / sum; with kDropout
// at rate > 0 (K6) the K5 mask of (row, key) and 1/(1 - rate), kept ?
// fl(p * inv) : 0, as JAX applies them to the fp32 p (at rate 0 neither,
// as in JAX); then p rounded to bf16 and packed as the A operand of P.V
// (k-step kk takes keys 16kk..16kk+15, i.e. s[8kk .. 8kk+7]). Keys past m
// (kMask) give p = 0; so do the rows of a second half that holds none
// (kHalves 1), which P.V then keeps at zero and nothing stores. rows[h]:
// the query row of the thread's half h, which the mask hash takes;
// keep_thr: keep_threshold(drop.rate).
template <bool kMask, bool kDropout, int kHalves>
__device__ __forceinline__ void tile_probs(const float (&s)[32], int key0,
                                           int m, int quad, float c,
                                           const float (&neg_mc)[2],
                                           const float (&sum)[2],
                                           const float (&inv)[2],
                                           const int (&rows)[2],
                                           uint32_t salt, uint32_t keep_thr,
                                           const Dropout& drop,
                                           uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = 8 * kk + 2 * r;
      const int hh = r & 1;
      const int key = key0 + 16 * kk + 8 * (r >> 1) + 2 * quad;
      if (hh >= kHalves) {
        p[kk][r] = 0u;
        continue;
      }
      float pv[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        pv[b] = divide(ex2(fmaf(s[idx + b], c, neg_mc[hh])), sum[hh],
                       inv[hh]);
        if (kDropout && drop.rate > 0.f)
          pv[b] = keep_elem_int(salt, rows[hh], m, key + b, keep_thr)
                      ? __fmul_rn(pv[b], drop.inv)
                      : 0.f;
        if (kMask && key + b >= m) pv[b] = 0.f;
      }
      p[kk][r] = pack_bf16(pv[0], pv[1]);
    }
}

// S = Q.K^T for one warpgroup: Q [64 x kDim] and K [64 keys x kDim],
// both swizzled tiles (HeadLayout<kDim>); k-steps of 16 (32 bytes along
// each 128-byte row of a sub-tile, four a sub-tile).
template <int kDim = kHeadDim>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t q_tile,
                                       uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HeadLayout<kDim>::kKSteps; ++kk) {
    const uint32_t at = (kk >> 2) * kTileBytes + 32 * (kk & 3);
    wgmma_ss(s, desc_sw128(q_tile + at), desc_sw128(k_tile + at), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(s);
}

// Accumulator layout of m64n64 (per warpgroup thread t, warp w = t / 32,
// lane l): s[4i + 2h + b] is row 16w + l/4 + 8h, column 8i + 2(l%4) + b;
// row 16w + 8h + l/4 holds query row tile_row(w, h, l/4, head) of its
// warpgroup's 64.
// kHasBias: the bias variant (K2, K4); bias is fp32 with the (entry, row)
// strides st.b. kDropout: K6's dropout in sweep 2 (tile_probs), the mask
// keyed by the absolute entry blockIdx.z, the head and the absolute row
// and key. kRing: the (K, V) ring's stages. kStreamSweep2: sweep 2's
// copies carry an evict-first L2 policy (they are read once). kDim: the
// head width (HeadLayout; P.V accumulates one m64n64 a sub-tile). The
// eval kernels (attn_fwd_tc_kernel), K6 (attn_train_fwd_tc_kernel) and K8
// (attn_train_fwd_folded_tc_kernel, attention_train_tc.cuh) are
// __global__ entry points of their own over this body.
template <int kWarpgroups, bool kHasBias, bool kDropout, int kRing = kStages,
          bool kStreamSweep2 = false, int kDim = kHeadDim>
__device__ __forceinline__ void attn_fwd_tc_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int lq, int m, float scale,
    const Strides& st, const Dropout& drop) {
  static_assert(kRing >= 2, "a step's tiles and the next step's");
  using L = HeadLayout<kDim>;
  constexpr int kThreadsTc = kWarpgroups * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_tiles = base;
  const uint32_t ring = base + kWarpgroups * L::kBytes;
  // stage s: K tile at ring + 2s * L::kBytes, V tile right after it

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int block_row0 = blockIdx.x * (kWarpgroups * kRowsPerWg);
  const long long h = blockIdx.y;
  const long long e = blockIdx.z;
  const __nv_bfloat16* qb = q + e * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + e * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + e * st.v[0] + h * st.v[2];
  const float* bb = kHasBias ? bias + e * st.b[0] : nullptr;
  __nv_bfloat16* ob = out + e * st.o[0] + h * st.o[2];
  const int rot = static_cast<int>(h) & 3;

  const int n_tiles = (m + kTileKeys - 1) / kTileKeys;
  // one tile: S once, stats and P.V in one step (the smaller launch's
  // shared memory holds stage 0 only); else sweep 1 over the K tiles,
  // sweep 2 over K and V
  const bool single = n_tiles == 1;
  const int n_steps = single ? 1 : 2 * n_tiles;
  const uint64_t sweep2_policy = kStreamSweep2 ? l2_evict_first() : 0;

  auto load_step = [&](int step) {
    const int stage = step % kRing;
    const int j = step < n_tiles ? step : step - n_tiles;
    const uint32_t kt = ring + 2 * stage * L::kBytes;
    if (kStreamSweep2 && step >= n_tiles) {
      load_tile<true, kDim>(kt, kb, st.k[1], j * kTileKeys, m, tid,
                            kThreadsTc, sweep2_policy);
      load_tile<true, kDim>(kt + L::kBytes, vb, st.v[1], j * kTileKeys, m,
                            tid, kThreadsTc, sweep2_policy);
      return;
    }
    load_tile<false, kDim>(kt, kb, st.k[1], j * kTileKeys, m, tid,
                           kThreadsTc);
    if (single || step >= n_tiles)
      load_tile<false, kDim>(kt + L::kBytes, vb, st.v[1], j * kTileKeys, m,
                             tid, kThreadsTc);
  };

  // prologue: the Q tiles ride with step 0's group
#pragma unroll
  for (int w = 0; w < kWarpgroups; ++w)
    load_q_tile<kDim>(q_tiles + w * L::kBytes, qb, st.q[1],
                      block_row0 + w * kRowsPerWg, lq, rot, tid, kThreadsTc);
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }

  const uint32_t my_q = q_tiles + wg * L::kBytes;
  const int quad = lane & 3;
  // exp(x) = 2^(c * x) with x the scaled score; without a bias the scale
  // rides in c, with one it is already in t
  const float c = kHasBias ? kLog2e : scale * kLog2e;
  const int wg_row0 = block_row0 + wg * kRowsPerWg;
  const int rows[2] = {wg_row0 + tile_row(warp, 0, lane / 4, rot),
                       wg_row0 + tile_row(warp, 1, lane / 4, rot)};
  // this warp's halves that hold query rows (warp-uniform): 2, 1 (the
  // second half's eight rows are all past lq) or 0
  const int first = wg_row0 + tile_row(warp, 0, 0, rot);
  const int halves = (first < lq) + (first + 32 < lq);
  const uint32_t salt = kDropout ? keep_salt(drop.seed, static_cast<int>(e),
                                             static_cast<int>(h))
                                 : 0u;
  const uint32_t keep_thr = kDropout ? keep_threshold(drop.rate) : 0u;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  float neg_mc[2], inv[2];
  float o[L::kSubTiles][32];
#pragma unroll
  for (int u = 0; u < L::kSubTiles; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[u][i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kRing - 2>();  // this step's tiles have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; the oldest stage is free
    if (step + kRing - 1 < n_steps) load_step(step + kRing - 1);
    cp_async_commit();

    const int stage = step % kRing;
    const uint32_t kt = ring + 2 * stage * L::kBytes;
    const bool sweep1 = step < n_tiles;
    const int key0 = (sweep1 ? step : step - n_tiles) * kTileKeys;
    const bool ragged = key0 + kTileKeys > m;  // only the last tile
    float s[32];
    scores<kDim>(s, my_q, kt);
    if (kHasBias) {
      if (ragged)
        add_bias<true>(s, bb, st.b[1], rows, lq, key0, m, quad, scale);
      else
        add_bias<false>(s, bb, st.b[1], rows, lq, key0, m, quad, scale);
    }

    if (sweep1) {
      if (halves == 2) {
        if (ragged)
          tile_stats<true, 2>(s, key0, m, quad, c, row_max, row_sum);
        else
          tile_stats<false, 2>(s, key0, m, quad, c, row_max, row_sum);
      } else if (halves == 1) {
        if (ragged)
          tile_stats<true, 1>(s, key0, m, quad, c, row_max, row_sum);
        else
          tile_stats<false, 1>(s, key0, m, quad, c, row_max, row_sum);
      }
      if (step == n_tiles - 1) {
        // the quad's partial sums share one max: add them
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
          row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
          neg_mc[hh] = -row_max[hh] * c;
          inv[hh] = __frcp_rn(row_sum[hh]);
        }
      }
      if (!single) continue;
    }

    uint32_t p[4][4];
    if (halves == 2) {
      if (ragged)
        tile_probs<true, kDropout, 2>(s, key0, m, quad, c, neg_mc, row_sum,
                                      inv, rows, salt, keep_thr, drop, p);
      else
        tile_probs<false, kDropout, 2>(s, key0, m, quad, c, neg_mc, row_sum,
                                       inv, rows, salt, keep_thr, drop, p);
    } else if (halves == 1) {
      if (ragged)
        tile_probs<true, kDropout, 1>(s, key0, m, quad, c, neg_mc, row_sum,
                                      inv, rows, salt, keep_thr, drop, p);
      else
        tile_probs<false, kDropout, 1>(s, key0, m, quad, c, neg_mc, row_sum,
                                       inv, rows, salt, keep_thr, drop, p);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = 0u;
    }
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < L::kSubTiles; ++u) fence_acc(o[u]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int u = 0; u < L::kSubTiles; ++u)
        wgmma_rs_tn(o[u], p[kk], desc_sw128(kt + L::kBytes + u * kTileBytes +
                                            kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < L::kSubTiles; ++u) fence_acc(o[u]);
  }

  // output rows of this thread: its halves' query rows, the head's lanes
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rows[hh];
    if (row >= lq) continue;
    __nv_bfloat16* orow = ob + row * st.o[1];
#pragma unroll
    for (int u = 0; u < L::kSubTiles; ++u)
#pragma unroll
      for (int i = 0; i < (u + 1 < L::kSubTiles ? 8 : L::kLastPairs); ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * u + 8 * i +
                                           2 * quad) =
            __floats2bfloat162_rn(o[u][4 * i + 2 * hh],
                                  o[u][4 * i + 2 * hh + 1]);
  }
}

// K1-K4 in bf16; kDim the head width (64, or kWideHeadDim or
// kMoonViTHeadDim without a bias), a template argument so that a trace
// names the width
template <int kWarpgroups, bool kHasBias, int kDim>
__global__ void __launch_bounds__(kWarpgroups * 128,
                                  kDim == kHeadDim ? 4 / kWarpgroups : 1)
attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int lq, int m,
                   float scale, Strides st) {
  attn_fwd_tc_body<kWarpgroups, kHasBias, false, kStages, false, kDim>(
      q, k, v, bias, out, lq, m, scale, st, Dropout{0, 0.f, 1.f});
}

#undef CRC_WGMMA_D32
#undef CRC_WGMMA_OUT32

// 16-byte copies need 16-byte-aligned rows; the output is written as bf16
// pairs
inline bool aligned(const void* q, const void* k, const void* v,
                    const void* out, const Strides& st) {
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  for (int i = 0; i < 3; ++i)
    if (st.q[i] % 8 || st.k[i] % 8 || st.v[i] % 8 || st.o[i] % 2)
      return false;
  return a16(q) && a16(k) && a16(v) &&
         reinterpret_cast<uintptr_t>(out) % 4 == 0;
}

constexpr int kMaxDevices = 64;

// A kernel's attributes on the current device, set on its first launch
// there and not again (`done`: the caller's flags for that kernel), so the
// launch path stays one kernel launch: the dynamic shared memory it may
// take, and all of the SM's unified memory as shared memory (the copies
// bypass L1), so more blocks fit an SM.
inline cudaError_t configure_once(std::atomic<bool> (&done)[kMaxDevices],
                                  const void* kernel, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace tc
}  // namespace crc
