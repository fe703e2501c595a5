// Paged decode attention on float32 operands for Hopper (sm_90a), as
// split-key flash-decoding: K3-f32, its multi-query verify and K4-f32.
//
// Replaces, for float32 q, pools and tails (the reference's kernels take any
// float dtype and sum in f32; in f32 their p.astype(v.dtype) is a no-op),
// two Pallas TPU kernels of ditl_tpu/ops/paged_attention.py:
// - K3 _paged_tail_kernel (:235, pallas_call :491), with _accumulate_block
//   and _finalize_out: entry point ditl_paged_tail_f32, one query token per
//   slot over its pages, positions [0, min(starts, lengths)), then the
//   tick's tail buffer, positions [starts, lengths); with q_groups (:248,
//   the speculative verify's Q query tokens per slot): ditl_paged_verify_f32;
// - K4 _paged_kernel (:191, :516), the same without a tail:
//   ditl_paged_f32;
// - K3 with quantized=True (ROADMAP.md §2 variant F: an f32 q and tail over
//   int8 pools with f32 scales (P, K, 1, ps)): ditl_paged_tail_i8_f32 and
//   its verify ditl_paged_verify_i8_f32.
// The bf16, float16 and bf16/float16-over-int8 kernels (paged_attention.cu)
// stay as they are.
//
// One split kernel and one merge: every form runs the tensor-core kernel,
// paged_mma_f32_kernel (3xTF32 mma.sync, below), then paged_merge_f32_kernel.
// K3-f32's verify and K4-f32 ran an FFMA kernel of their own until they
// moved onto it (PERF.md §6).
//
// Bound on the card: bytes. K3-f32 must read each live key's K and V once
// per slot that reads it (2 * K * D * 4 bytes per key in f32, twice the bf16
// kernel's), the live tail, q and o, and does 4 * D flops per (query head,
// key): at the decode tick (8 slots, 32 query / 8 KV heads, D = 128, 4,343
// live keys) about 35.6 MB, 0.0106 ms at 3.35 TB/s, against 0.07 GFLOP of
// products. The verify at the spec tick (Q = 9) adds 9x the q and o bytes
// and 9x the flops: still bytes at G = 4, operations (3xTF32) at path 16's
// G = 16 over int8 pools. What counts is keeping enough bytes in flight and
// enough blocks on an SM to overlap each block's chain of waits.
//
// Grid and walk: the bf16 template's split structure, its rules and its
// merge.
// - The grid is (split, KV head and row group, slot), a split being `split`
//   positions (ops/paged_attention.py SPLIT_KEYS, a multiple of the 64-key
//   tile) of the slot's axis of max_pages * page_size page positions
//   followed by tail_len tail positions (K4: none); sized from shapes alone,
//   so the wrapper reads nothing back from the card. A block whose split
//   holds no live key stops at once and writes nothing; the merge gives it
//   no weight.
// - Inside a split, a block walks its live 64-key tiles (skipping tiles with
//   no live column) with an online softmax in f32.
// - Each block writes its partial (m and l per query row, f32 acc); a second
//   kernel, one block per (query row, KV head, slot), merges the partials in
//   split order, so two calls give the same bits.
//
// Rules kept from the bf16 template: the tail is read only when lengths >
// starts (the Pallas kernel's _tail gate); query qi sees tail column j when
// starts + j < lengths + qi (per-row limits); page columns below min(starts,
// lengths) for every row; keys past the table's last page are absent;
// out-of-range page ids clamp into the pool; a tile (and a split) is
// processed when any row has a live key in it, and a row with nothing live
// in a split keeps m at the mask value and weighs 0 in the merge (tested
// explicitly). ops/paged_attention.py::paged_attention_split_plain is the
// kernels' twin in f32.
//
// Over int8 pools (variant F). Bound at the decode tick: 8.9 MB of int8
// K/V plus 0.28 MB of scales and the f32 tail, q and o, about 2.8 us at
// 3.35 TB/s, a quarter of the f32 kernel's bytes. The reference's quantized
// branch (_accumulate_block :140-176) in f32: q . k of the exact int8 values
// in f32, times the scale, times K's scale of the key; p times V's scale in
// f32, never rounded (the reference multiplies (p * vs) by v.astype(f32)),
// while l adds the unscaled p; the tail columns as the f32 kernel's.
// Routing it through the bf16 int8 kernel would round q to bf16, far
// outside f32's tolerance.
//
// The tensor-core kernel, paged_mma_f32_kernel<D, kF32, kMT, kTail>:
// paged_attention.cu's K3-int8 design with f32 numerics; the single query
// over int8 pools first, then the verify over int8 pools and K3-f32 over f32
// pools, then K3-f32's verify and K4-f32 (kTail false) moved onto it (their
// first forms ran both products on FFMA: 2.4-3.2% of the verify's bound, 22%
// of K3-f32's; H100 SXM, 700 W; PERF.md §6).
// - Rows: kMT m16 row tiles of the n_q G rows r = qi G + g a block, one
//   warpgroup (four warps) a row tile, so a block of kMT row tiles is 128
//   kMT threads; the first warpgroup copies the tiles, and each K and V tile
//   in shared memory serves every row tile (one copy from device memory
//   where kMT one-tile blocks would make kMT). The single queries (K3-f32,
//   K4-f32, K3-int8-f32) take one row tile (G > 16 in groups of 16 side by
//   side), and so does a verify of at most 16 rows. Past 16 rows the verify
//   over int8 pools takes kVerifyRowTiles (2) row tiles a block, more
//   blocks side by side (path 11's spec tick, 36 rows: two blocks, of two
//   row tiles and of one with its second warpgroup idle; path 16's 144
//   rows: five); over f32 pools f32_verify_row_tiles (below). A row tile
//   past the block's rows computes nothing. Scores mask by each row's tail
//   limit.
// - Over int8 pools, small staging tiles. A page tile (every row below the
//   tail) comes by 16-byte cp.async into two stages of raw int8 tiles, D +
//   32 bytes a key, the next page tile in flight while one is computed; its
//   two scales by 4-byte copies into a scale tile. A tile with tail rows
//   (the tail's, or one that mixes page and tail rows) takes one f32 tile
//   that aliases both stages: its K rows, then after q.k its V rows (page
//   rows as int8 bytes in the first D bytes of their f32 row, tail rows f32,
//   dead rows zeros); such a tile is loaded once the one before it is done,
//   as only the axis's last tiles hold tail rows. Block bytes at D = 32 /
//   64 / 128 / 256: one row tile 34 / 47 / 71 / 120 KB, two 51 / 67 / 100 /
//   166 KB.
// - Over f32 pools (K3-f32, its verify, K4-f32), f32 tiles: one K tile and one V tile of
//   64 keys, D + 8 floats a row (35 KB each at D = 128), every live row,
//   page or tail, by 16-byte cp.async from a row id that 64 threads take
//   once a tile (f32_row: the table read and the divisions once a row, not
//   once a 16-byte copy). A tile's V rows load during its q.k, the next
//   tile's K rows once q.k is done (during the softmax and p.V), its V rows
//   once p.V is done. Block bytes at D = 32 / 64 / 128 / 256: one row tile
//   37 / 58 / 99 / 181 KB, six / three / two / one blocks an SM (at D = 256
//   one block an SM is all that fits); three row tiles 71 / 100 / 157 KB up
//   to D = 128, two 227 KB at D = 256 (the verify's only instances past one
//   row tile).
// - Both products on the tensor cores (mma.sync.m16n8k8.tf32), 3xTF32: a
//   row tile's 16 query rows (zero-padded) are the m16 A operand. q is split
//   once a block into TF32 hi and lo = q - hi (flash_f32.cu's split_tf32) A
//   fragments, which shared memory holds in lane order (one 16-byte read a
//   k8 step; in registers they would take D registers a thread a row tile);
//   with one row tile over int8 pools q is read once the first tile's
//   copies are issued, else q's loads are issued first. An int8 key is
//   exact in TF32, so an int8 page tile takes two MMAs a product, q_lo . k
//   then q_hi . k; a tile with f32 rows splits them too and takes three,
//   lo.hi, hi.lo, hi.hi (lo = 0 on its int8 rows): a choice per tile, the
//   same for the whole block; every tile over f32 pools takes three. p
//   (times V's scale on an int8 row) is formed in f32 and split into p's hi
//   and lo fragments by the softmax; p.V takes two or three MMAs alike. Each
//   32-deep partial (32 dimensions of q.k, 32 keys of p.V) sums from zero
//   and a rounded FADD adds it on (the tensor cores' own accumulation
//   truncates), so a row's bits do not depend on the block that holds it.
// - The softmax takes one warp a row with one row tile over int8 pools (the
//   single query's first form, its instructions kept); else eight lanes a
//   row, four rows a warp at a time (two row tiles put 32 rows on eight
//   warps), its row sums in the order of a warp a row (a butterfly over
//   lanes holding keys l and l + 32), so the bits are the same in both.
// - int8 to TF32 in registers from the raw tile, no convert pass: the
//   contraction of q.k is permuted alike in both operands (k8 step 4c + s
//   takes dimensions 32c + 8t + 2s and + 1 for columns t and t + 4), so
//   one 8-byte read of a key row feeds four steps; p.V's output columns
//   are permuted (column n of n8 block j is dimension w D / 4 + (D / 32)
//   n + j), so one read of D / 32 bytes of a V row feeds all of a warp's
//   column blocks. A byte converts by one byte permute into 2^23 + (v +
//   128) and one FADD, exact.
//
// Head dims up to 32, 64, 128 and 256, one template whose D is a capacity:
// a call's head_dim (Params::head_dim, any multiple of 16 up to 256) runs on
// the smallest instance that holds it, as in paged_attention.cu. Rows are
// read at their true stride, one 16-byte copy per chunk (an f32 row of a
// multiple of 16 is whole float4 chunks, an int8 row whole 16-byte chunks);
// chunks past head_dim are zero-filled in shared memory, so they add exact
// zeros to q.k and zero columns to acc, which are never stored (the
// partials, the merge with head_dim threads and o take the true stride);
// the scale is the caller's head_dim**-0.5.
// Row groups: a call with more rows than a block takes (Llama-3.1-405B's G
// = 16 at spec_k = 8 is 144) runs ceil(rows / 16 kMT) blocks side by side
// (blockIdx.y: KV head, then row group), each walking the split's tiles for
// its rows (each re-reads the split's K and V); their partials land in the
// same workspace rows the merge reads.
// ptxas -v (sm_90a) with the run-time head_dim, no spills: over int8 pools
// 126 / 118 / 120 / 164 registers at D = 32 / 64 / 128 / 256 with one row
// tile (its first form, as its own kernel, 124 / 128 / 127 / 164), 128 /
// 124 / 127 / 188 with two; over f32 pools one row tile 72 / 96 / 120 /
// 163 (K4-f32, kTail false: 72 / 98 / 118 / 161), three 72 / 96 / 123 up
// to D = 128, two 166 at D = 256; merge 48-145. Blocks an SM (shared memory
// and registers): int8 one row tile 4 / 4 / 3 / 1, two 2 / 2 / 2 / 1; f32
// one row tile 6 / 3 / 2 / 1, three 2 / 1 / 1, two 1 at D = 256.
//
// Semantics, the reference's in f32: scores are the f32 q.k sums times the
// scale; masked columns of a processed tile take the finite -2.3819763e38;
// p stays f32 for p.v, l adds the same p; a row with l == 0 (a dead slot,
// length 0) writes 0; o is f32. Within a split p is relative to the split's
// running max; the merge rescales each split's l and acc by exp(m_s - max_s
// m_s). Exponents by expf.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // keys per tile; two per lane in the softmax
constexpr int kMergeBatch = 32;    // merge: splits whose acc values are loaded at once
constexpr int kMaxSplits = 6144;   // the merge's m and l: 48 KB of shared memory
constexpr float kNegInf = -2.3819763e38f;  // ops/attention.py NEG_INF
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take

struct Params {
  const float* q;        // (B, H, D); verify (B, Q, H, D)
  const float* k_pages;  // (P, K, ps, D)
  const float* v_pages;
  const int* table;      // (B, max_pages)
  const int* lengths;    // (B,)
  const int* starts;     // (B,), K3 only
  const float* tail_k;   // (B, K, T, D), K3 only
  const float* tail_v;
  float* o;              // shaped as q
  float* part_acc;       // (B, K, n_split, R, D), R = n_q * G query rows
  float* part_ml;        // (B, K, n_split, R, 2): m, l
  int kv_heads, groups, page_size, max_pages, n_pool, tail_len, split, n_split;
  float scale;
  int n_q;               // query tokens per slot: 1, or the verify's Q
  const int8_t* k_i8;    // (P, K, ps, D), int8 pools (ditl_paged_*_i8_f32)
  const int8_t* v_i8;
  const float* k_scale;  // (P, K, 1, ps)
  const float* v_scale;
  int head_dim;          // the rows' true width: a multiple of 16, <= the instance's D
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes global -> shared, in flight until cp_wait; with valid == false
// the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (a scale); with valid == false, zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a slot's live keys lie on its axis of page positions, then tail
// positions: [0, page_limit) for every query, and [tail0, row_end(qi)) for
// query qi; tail_end is the last query's end (the union), and the axis ends
// at end. (paged_attention.cu's rule.)
struct Live {
  int page_limit, tail0, tail_end, end;
  int tail_q0;    // query 0's tail end, when the slot has a tail
  int tail_max;   // tail0 + tail_len
  bool has_tail;  // lengths > starts: the Pallas kernel's _tail gate

  __device__ __forceinline__ int row_end(int qi) const {
    return has_tail ? min(tail_q0 + qi, tail_max) : tail0;
  }
  __device__ __forceinline__ bool key(int v) const {
    return v < page_limit || (v >= tail0 && v < tail_end);
  }
  __device__ __forceinline__ bool key_row(int v, int te) const {
    return v < page_limit || (v >= tail0 && v < te);
  }
  __device__ __forceinline__ bool tile(int t0) const {
    return t0 < page_limit || max(t0, tail0) < min(t0 + kTile, tail_end);
  }
  __device__ __forceinline__ int next(int t0, int t1) const {
    for (; t0 < t1; t0 += kTile) {
      if (tile(t0)) return t0;
    }
    return -1;
  }
  __device__ __forceinline__ bool split_live(int s, int split) const {
    return next(s * split, min(s * split + split, end)) >= 0;
  }
};

template <bool kTail>
__device__ __forceinline__ Live slot_live(const Params& p, int b) {
  const int length = p.lengths[b];
  const int start = kTail ? p.starts[b] : length;
  Live live;
  live.tail0 = p.max_pages * p.page_size;
  live.page_limit = min(min(start, length), live.tail0);
  live.has_tail = kTail && length > start;
  live.tail_q0 = live.tail0 + (length - start);
  live.tail_max = live.tail0 + (kTail ? p.tail_len : 0);
  live.tail_end = live.row_end(p.n_q - 1);
  live.end = live.tail_max;
  return live;
}

// Whether key v of a tile over int8 pools came as int8 values (a live page
// key) and not as f32 (a tail key, or a dead key's zeros).
__device__ __forceinline__ bool int8_row(const Live& live, int v) {
  return live.key(v) && v < live.tail0;
}

// Merge: one block of D threads per (query row r, KV head kh, slot b), as
// paged_attention.cu's: the partials of every split with a key live for
// some row are summed in split order; a partial whose m is the mask value
// weighs 0. The block has head_dim threads (D is the instance's capacity).
template <int D, bool kTail>
__global__ void __launch_bounds__(D) paged_merge_f32_kernel(const Params p) {
  extern __shared__ float sml[];  // m, then l, of each split
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int rows = p.n_q * p.groups, n = p.n_split, hd = p.head_dim;
  const long bk = (long)b * p.kv_heads + kh;
  const Live live = slot_live<kTail>(p, b);
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml) + bk * n * rows + r;
  for (int s = d; s < n; s += hd) {
    const float2 v = live.split_live(s, p.split) ? __ldcg(ml + (long)s * rows)
                                                 : make_float2(kNegInf, 0.f);
    sml[s] = v.x;
    sml[n + s] = v.y;
  }
  __syncthreads();
  float m_max = kNegInf;
  for (int s = 0; s < n; ++s) m_max = fmaxf(m_max, sml[s]);
  auto weight = [&](int s) { return sml[s] == kNegInf ? 0.f : expf(sml[s] - m_max); };
  float l = 0.f;
  for (int s = 0; s < n; ++s) l += weight(s) * sml[n + s];
  const float* acc = p.part_acc + (bk * n * rows + r) * hd + d;
  float o = 0.f;
  for (int s0 = 0; s0 < n; s0 += kMergeBatch) {
    float av[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int s = s0 + j;
      av[j] = s < n && sml[s] != kNegInf ? __ldcg(acc + (long)s * rows * hd) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      if (s0 + j < n) o += weight(s0 + j) * av[j];
    }
  }
  o /= (l == 0.f ? 1.f : l);
  const int qi = r / p.groups, g = r % p.groups;
  const long orow = ((long)b * p.n_q + qi) * p.kv_heads * p.groups + (long)kh * p.groups + g;
  p.o[orow * hd + d] = o;
}

// ---------------------------------------------------------------------------
// The tensor-core kernel: K3-int8-f32 and its verify over int8 pools, K3-f32
// over f32 pools.
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16;  // query rows of a row tile: the rows of the m16 A operand

// m16 row tiles a block of the verify over int8 pools past one row tile. Two
// were the fastest of one, two and three at path 16's 144-row spec tick and
// 3% behind one at path 11's 36 rows (PERF.md §6); three at D = 256
// take more shared memory than a block has.
constexpr int kVerifyRowTiles = 2;

// The block's shared memory, in bytes, for kMT row tiles. Over int8 pools
// (kF32 false): two stages of raw int8 K and V tiles (64 rows of D bytes,
// padded to D + 32 so the fragment reads below reach 32 banks); the f32 tile
// of a tile with tail rows (64 rows of D + 8 floats, holding its K rows,
// then its V rows) aliases both stages, which such a tile never needs. Over
// f32 pools: one f32 K tile and one f32 V tile of 64 rows of D + 8 floats.
// Then, for each row tile, q's and p's A fragments (TF32 hi, then lo, 16
// bytes a lane a k8 step); the scores, m, l and alpha of the 16 kMT rows;
// over int8 pools, two stages of the tile's 64 K and 64 V scales, over f32
// pools two sets of 64 row ids (the tile's, the next's).
template <int D, bool kF32, int kMT>
struct MmaLayout {
  static constexpr int kLd8 = D + 32;
  static constexpr int kTile8 = kTile * kLd8;
  static constexpr int kStage = 2 * kTile8;
  static constexpr int kLdF = D + 8;
  static constexpr int kTileF = kTile * kLdF * 4;     // bytes of an f32 tile
  static constexpr int kQF = kF32 ? 2 * kTileF : 2 * kStage;
  static constexpr int kQFrag = D / 8 * 32 * 16;      // one of q's hi or lo fragment sets
  static constexpr int kPF = kQF + kMT * 2 * kQFrag;
  static constexpr int kPFrag = kTile / 8 * 32 * 16;  // one of p's
  static constexpr int kLdS = kTile + 4;
  static constexpr int kRows = kMT * kMmaRows;
  static constexpr int kS = kPF + kMT * 2 * kPFrag;
  static constexpr int kM = kS + kRows * kLdS * 4;
  static constexpr int kL = kM + kRows * 4;
  static constexpr int kAlpha = kL + kRows * 4;
  static constexpr int kSc = kAlpha + kRows * 4;
  static constexpr int kBytes = kSc + (kF32 ? 2 * kTile * 4 : 2 * 2 * kTile * 4);
  static_assert(kF32 || kTileF <= 2 * kStage, "the f32 tile fits the two int8 stages");
  static_assert(kBytes <= kMaxSmem, "shared memory of a block");
};

// x = hi + lo, hi x rounded to the nearest TF32 value (cvt.rna's result) by
// two integer operations, lo = x - hi exact and handed over unrounded (the
// tensor cores read its top 19 bits): csrc/flash_f32.cu's split_tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte i of a word of int8 values whose sign bits were flipped (w ^
// 0x80808080, so the byte is v + 128) as the bits of v in f32, exact in
// TF32: 2^23 + (v + 128) built by one byte permute, minus 2^23 + 128.
__device__ __forceinline__ uint32_t i8_tf32(uint32_t w, int i) {
  return __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | i)) - 8388736.f);
}

// N consecutive int8 values at p (N = 1, 2, 4 or 8, aligned to N), sign
// bits flipped for i8_tf32: bytes 0-3 in .x, 4-7 in .y.
template <int N>
__device__ __forceinline__ uint2 ld_i8(const uint8_t* p) {
  uint2 w = make_uint2(0u, 0u);
  if constexpr (N == 8) w = *reinterpret_cast<const uint2*>(p);
  else if constexpr (N == 4) w.x = *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (N == 2) w.x = *reinterpret_cast<const uint16_t*>(p);
  else w.x = *p;
  return make_uint2(w.x ^ 0x80808080u, w.y ^ 0x80808080u);
}

__device__ __forceinline__ uint32_t i8_at8(const uint2& w, int i) {
  return i8_tf32(i < 4 ? w.x : w.y, i & 3);
}

// N consecutive floats at p (aligned to 4 N bytes) into v.
template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// The page tile at t0 (every row below tail0: page keys, or dead keys that
// arrive as zeros) into an int8 stage (K at k8, V kTile8 bytes on), a live
// row's D bytes by 16-byte cp.async, chunks past head_dim zero; its K and V
// scales to sc (V kTile floats on; 0 on dead rows).
template <int D>
__device__ __forceinline__ void load_i8_tile(const Params& p, const Live& live, int b, int kh,
                                             int t0, uint8_t* k8, float* sc) {
  using L = MmaLayout<D, false, 1>;
  constexpr int kChunks = D / 16;
  static_assert(kThreads == 2 * kTile, "one thread per K or V scale of a tile");
  const int hd = p.head_dim;
  const int* trow = p.table + (long)b * p.max_pages;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int v = t0 + r;
    const bool in = live.key(v) && 16 * c < hd;
    long off = 0;
    if (in) {
      const long page = min(max(trow[v / p.page_size], 0), p.n_pool - 1);
      off = ((page * p.kv_heads + kh) * p.page_size + v % p.page_size) * hd + 16 * c;
    }
    cp_async16(k8 + r * L::kLd8 + 16 * c, p.k_i8 + off, in);
    cp_async16(k8 + L::kTile8 + r * L::kLd8 + 16 * c, p.v_i8 + off, in);
  }
  const int r = threadIdx.x % kTile;
  const bool is_v = threadIdx.x >= kTile;
  const int v = t0 + r;
  const bool ok = int8_row(live, v);
  long off = 0;
  if (ok) {
    const long page = min(max(trow[v / p.page_size], 0), p.n_pool - 1);
    off = (page * p.kv_heads + kh) * p.page_size + v % p.page_size;
  }
  cp_async4(sc + (is_v ? kTile : 0) + r, (is_v ? p.v_scale : p.k_scale) + off, ok);
  cp_commit();
}

// K's (is_v false: with both scales to sc) or V's rows of a tile with tail
// rows over int8 pools into the f32 tile ft: a live page row's D int8 bytes
// into the first D bytes of its f32 row, a tail row's f32 values, a dead row
// zeros (chunks past head_dim zero).
template <int D>
__device__ __forceinline__ void load_f32_tile(const Params& p, const Live& live, int b, int kh,
                                              int t0, bool is_v, float* ft, float* sc) {
  using L = MmaLayout<D, false, 1>;
  constexpr int kChunks = D / 4;
  const int hd = p.head_dim;
  const int* trow = p.table + (long)b * p.max_pages;
  const int8_t* pool = is_v ? p.v_i8 : p.k_i8;
  const float* tail = is_v ? p.tail_v : p.tail_k;
#pragma unroll 4
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int v = t0 + r;
    float* dst = ft + r * L::kLdF;
    if (int8_row(live, v)) {
      if (c < D / 16) {
        const bool in = 16 * c < hd;
        long off = 0;
        if (in) {
          const long page = min(max(trow[v / p.page_size], 0), p.n_pool - 1);
          off = ((page * p.kv_heads + kh) * p.page_size + v % p.page_size) * hd + 16 * c;
        }
        cp_async16(reinterpret_cast<uint8_t*>(dst) + 16 * c, pool + off, in);
      }
      continue;
    }
    // A tail row, or a dead row (no read; its address is any valid one).
    const bool in = live.key(v) && 4 * c < hd;
    const long off =
        in ? (((long)b * p.kv_heads + kh) * p.tail_len + (v - live.tail0)) * hd + 4 * c : 0;
    cp_async16(dst + 4 * c, tail + off, in);
  }
  if (!is_v) {
    const int r = threadIdx.x % kTile;
    const bool v_sc = threadIdx.x >= kTile;
    const int v = t0 + r;
    const bool ok = int8_row(live, v);
    long off = 0;
    if (ok) {
      const long page = min(max(trow[v / p.page_size], 0), p.n_pool - 1);
      off = (page * p.kv_heads + kh) * p.page_size + v % p.page_size;
    }
    cp_async4(sc + (v_sc ? kTile : 0) + r, (v_sc ? p.v_scale : p.k_scale) + off, ok);
  }
  cp_commit();
}

// Over f32 pools, the row of key v: >= 0 the pool row (page K + kh) ps + v %
// ps, <= -2 the tail row -2 - id = (b K + kh) T + v - tail0, -1 a dead key.
// A tile's 64 ids are taken once (64 threads), so its copies read no table.
__device__ __forceinline__ int f32_row(const Params& p, const Live& live, int b, int kh,
                                       int v) {
  if (!live.key(v)) return -1;
  if (v < live.tail0) {
    const int page =
        min(max(p.table[(long)b * p.max_pages + v / p.page_size], 0), p.n_pool - 1);
    return (page * p.kv_heads + kh) * p.page_size + v % p.page_size;
  }
  return -2 - ((b * p.kv_heads + kh) * p.tail_len + (v - live.tail0));
}

// K's (is_v false) or V's rows of an f32-pool tile into the f32 tile ft by
// their ids (f32_row), 16 bytes a copy; dead rows and chunks past head_dim
// zero.
template <int D>
__device__ __forceinline__ void load_f32_rows(const Params& p, const int* ids, bool is_v,
                                              float* ft) {
  using L = MmaLayout<D, true, 1>;
  constexpr int kChunks = D / 4;
  const int hd = p.head_dim;
  const float* pool = is_v ? p.v_pages : p.k_pages;
  const float* tail = is_v ? p.tail_v : p.tail_k;
#pragma unroll 4
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int id = ids[r];
    const bool in = id != -1 && 4 * c < hd;
    const float* src = id >= 0 ? pool + (long)id * hd : tail + (long)(-2 - id) * hd;
    cp_async16(ft + r * L::kLdF + 4 * c, in ? src + 4 * c : pool, in);
  }
  cp_commit();
}

// The float index of element (row r, contraction index k) of an m16 x k8
// A fragment set laid out lane by lane (k8 step k / 8, lane 4 (r % 8) + k %
// 4, element r / 8 + 2 ((k % 8) / 4)).
__device__ __forceinline__ int frag_at(int r, int k) {
  return ((k >> 3) * 32 + ((r & 7) << 2) + (k & 3)) * 4 + (r >> 3) + (((k >> 2) & 1) << 1);
}

__device__ __forceinline__ void frag_u32(const float4& x, uint32_t (&a)[4]) {
  a[0] = __float_as_uint(x.x);
  a[1] = __float_as_uint(x.y);
  a[2] = __float_as_uint(x.z);
  a[3] = __float_as_uint(x.w);
}


// One split of one (KV head, slot) for kMT m16 row tiles of the n_q G query
// rows r = qi G + g (blockIdx.y: the KV head, then the block's group of 16
// kMT rows), one warpgroup of four warps a row tile; q.k and p.V as 3xTF32
// products on mma.sync.m16n8k8 (see "The tensor-core kernel" in the
// header); over int8 pools (kF32 false) or f32 pools. The first warpgroup
// copies the tiles; the K and V tiles in shared memory serve every row
// tile.
//
// The least blocks an SM in the launch bounds: over int8 pools two for two
// row tiles at D <= 128, none (0) for one row tile, as its first form named
// none (a count of 1 gives it up to 32 more registers, one block an SM fewer
// at D = 32 and 64); over f32 pools one (three row tiles take 157 KB at D =
// 128 and two 227 KB at D = 256, so one block is all that fits). kTail false:
// K4-f32, no tail (p.starts is never read).
template <int D, bool kF32, int kMT, bool kTail>
__global__ void __launch_bounds__(kThreads * kMT,
                                  !kF32 && kMT == 2 && D <= 128 ? 2 : kMT >= 2 || kF32 ? 1 : 0)
    paged_mma_f32_kernel(const Params p) {
  using L = MmaLayout<D, kF32, kMT>;
  constexpr int kNT = D / 32;                 // p.V: n8 column blocks a warp (D / 4 columns)
  constexpr int kQSet = D / 8 * 32;           // float4s of one of q's fragment sets
  constexpr int kPSet = kTile / 8 * 32 * 4;   // floats of one of p's
  constexpr int kBlockThreads = kThreads * kMT;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  uint8_t* smem = mma_smem;
  // int8 pools: the f32 tile of a tile with tail rows (aliases both stages,
  // K rows then V rows); f32 pools: the K tile, then the V tile.
  float* ft = reinterpret_cast<float*>(smem);
  float* fv = kF32 ? ft + kTile * L::kLdF : ft;
  const float4* qf = reinterpret_cast<const float4*>(smem + L::kQF);  // q's A fragments
  float* pf = reinterpret_cast<float*>(smem + L::kPF);                // p's
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  float* sm = reinterpret_cast<float*>(smem + L::kM);
  float* sl = reinterpret_cast<float*>(smem + L::kL);
  float* salpha = reinterpret_cast<float*>(smem + L::kAlpha);
  float* ssc = reinterpret_cast<float*>(smem + L::kSc);  // int8 pools: the scales
  int* srow = reinterpret_cast<int*>(smem + L::kSc);     // f32 pools: the row ids

  const int split = blockIdx.x, kh = blockIdx.y % p.kv_heads, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // One row tile over int8 pools (the single query, and a verify of at
  // most 16 rows) keeps its first form's order and softmax: q read after
  // the first tile's copies are issued, one warp a row.
  constexpr bool kFirstForm = !kF32 && kMT == 1;
  const int mt = kMT == 1 ? 0 : warp / kWarps, wq = warp % kWarps;  // row tile, place in it
  const bool loader = kMT == 1 || tid < kThreads;  // the first warpgroup copies the tiles
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int groups = p.groups, hd = p.head_dim;
  const int all_rows = p.n_q * groups;
  const int row0 = blockIdx.y / p.kv_heads * L::kRows;
  const int rows = min(L::kRows, all_rows - row0);
  const bool busy = kMT == 1 || kMmaRows * mt < rows;  // the warp's row tile holds rows
  const Live live = slot_live<kTail>(p, b);
  const int v0 = split * p.split, v1 = min(v0 + p.split, live.end);
  int cur = live.next(v0, v1);
  if (cur < 0) return;  // no live key: no partial (the merge weighs this split 0)
  // q's rows, split once into TF32 hi and lo A fragments, in the order the
  // k8 steps read the keys' bytes: step 4c + s takes, for column t (t + 4),
  // dimension 32c + 8t + 2s (+ 1), so one 8-byte read of a key row feeds
  // four steps. Rows past the block's and dimensions past head_dim zero.
  // Float4 e4 of row tile m's sets takes two float2s of q (q_pair).
  const long heads = (long)p.kv_heads * groups;
  auto q_pair = [&](int m, int e4, float2 (&x)[2]) {
    const int ks = e4 >> 5, fg = (e4 >> 2) & 7, ft4 = e4 & 3;
    const int d0 = 32 * (ks >> 2) + 8 * ft4 + 2 * (ks & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = kMmaRows * m + fg + 8 * h, rr = row0 + r;
      x[h] = make_float2(0.f, 0.f);
      if (r < rows && d0 < hd) {
        const long qrow = ((long)b * p.n_q + rr / groups) * heads + (long)kh * groups + rr % groups;
        x[h] = *reinterpret_cast<const float2*>(p.q + qrow * hd + d0);
      }
    }
  };
  auto q_split = [&](int m, int e4, const float2 (&x)[2]) {
    float4* qw = reinterpret_cast<float4*>(smem + L::kQF) + 2 * kQSet * m;
    const float a[4] = {x[0].x, x[1].x, x[0].y, x[1].y};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], hi[e], lo[e]);
    qw[e4] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                         __uint_as_float(hi[3]));
    qw[kQSet + e4] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                 __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  };
  // Over int8 pools a tile with every row below tail0 is a page tile (int8
  // stages, two MMAs a product); else it holds tail rows (the f32 tile,
  // three MMAs). Over f32 pools every tile takes the f32 tiles and three.
  bool page = !kF32 && cur + kTile <= live.tail0;
  if constexpr (kFirstForm) {  // the first tile's copies, then q
    if (page) {
      load_i8_tile<D>(p, live, b, kh, cur, smem, ssc);
    } else {
      load_f32_tile<D>(p, live, b, kh, cur, false, ft, ssc);
    }
    for (int e4 = tid; e4 < kQSet; e4 += kThreads) {
      float2 x[2];
      q_pair(0, e4, x);
      q_split(0, e4, x);
    }
  } else {
    // q's loads in flight while the first tile's copies are issued; each
    // thread takes D / 32 float4s of the kMT row tiles' sets.
    constexpr int kQIters = kMT * kQSet / kBlockThreads;
    static_assert(kQIters * kBlockThreads == kMT * kQSet, "q's fragments a thread");
    float2 xq[kQIters][2];
#pragma unroll
    for (int i = 0; i < kQIters; ++i) {
      const int idx = tid + i * kBlockThreads;
      q_pair(idx / kQSet, idx % kQSet, xq[i]);
    }
    if constexpr (kF32) {
      if (tid < kTile) srow[tid] = f32_row(p, live, b, kh, cur + tid);
      __syncthreads();
      if (loader) {
        load_f32_rows<D>(p, srow, false, ft);
        load_f32_rows<D>(p, srow, true, fv);
      }
    } else if (loader) {
      if (page) {
        load_i8_tile<D>(p, live, b, kh, cur, smem, ssc);
      } else {
        load_f32_tile<D>(p, live, b, kh, cur, false, ft, ssc);
      }
    }
#pragma unroll
    for (int i = 0; i < kQIters; ++i) {
      const int idx = tid + i * kBlockThreads;
      q_split(idx / kQSet, idx % kQSet, xq[i]);
    }
  }
  {
    float4* pw = reinterpret_cast<float4*>(pf);  // padding rows: p = 0
    for (int i = tid; i < kMT * 2 * kPSet / 4; i += kBlockThreads) pw[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r = tid; r < L::kRows; r += kBlockThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  const float4* qh = qf + 2 * kQSet * mt;  // this warp's row tile: q's hi, then lo
  const float4* ph = reinterpret_cast<const float4*>(pf) + mt * 2 * (kPSet / 4);  // p's
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int stage = 0; cur >= 0; stage ^= 1) {
    const int nxt = live.next(cur + kTile, v1);
    // int8 pools: the next tile is in flight during this one only if both
    // are page tiles. f32 pools: wait for this tile's K rows (its V rows
    // may still be in flight) and take the next tile's row ids (their set
    // was last read by the copies of the tile before this one).
    bool ahead = false;
    if constexpr (kF32) {
      if (nxt >= 0 && tid < kTile) srow[(stage ^ 1) * kTile + tid] = f32_row(p, live, b, kh, nxt + tid);
      cp_wait<1>();
    } else {
      ahead = page && nxt >= 0 && nxt + kTile <= live.tail0;
      if (ahead) {
        if (loader) {
          load_i8_tile<D>(p, live, b, kh, nxt, smem + (stage ^ 1) * L::kStage,
                          ssc + (stage ^ 1) * 2 * kTile);
        }
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    }
    __syncthreads();  // the tile's K (and V) and scales, q's fragments, m, l
    const uint8_t* k8 = smem + stage * L::kStage;
    const uint8_t* v8 = k8 + L::kTile8;
    const float* sks = ssc + stage * 2 * kTile;
    const float* svs = sks + kTile;

    // Scores of warp wq's 16 keys (two n8 blocks) for its row tile, 32
    // dimensions a chunk: each chunk's MMAs sum from zero and a rounded
    // FADD adds them on. A row tile past the block's rows (the last block
    // of an odd count) computes nothing.
    if (busy) {
      float s[2][4] = {};
#pragma unroll 2
      for (int c = 0; c < D / 32; ++c) {
        uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 16 * wq + 8 * j + g;
          if (!kF32 && (page || int8_row(live, cur + r))) {
            const uint8_t* row = page ? k8 + r * L::kLd8 : reinterpret_cast<const uint8_t*>(
                                                                ft + r * L::kLdF);
            const uint2 w = ld_i8<8>(row + 32 * c + 8 * t);
#pragma unroll
            for (int s4 = 0; s4 < 4; ++s4) {
              bh[j][s4][0] = i8_at8(w, 2 * s4);
              bh[j][s4][1] = i8_at8(w, 2 * s4 + 1);
              bl[j][s4][0] = bl[j][s4][1] = 0u;
            }
          } else {
            float x[8];
            ld_f32<8>(ft + r * L::kLdF + 32 * c + 8 * t, x);
#pragma unroll
            for (int s4 = 0; s4 < 4; ++s4) {
              split_tf32(x[2 * s4], bh[j][s4][0], bl[j][s4][0]);
              split_tf32(x[2 * s4 + 1], bh[j][s4][1], bl[j][s4][1]);
            }
          }
        }
        float part[2][4] = {};
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int ks = 4 * c + s4;
          uint32_t ah[4], al[4];
          frag_u32(qh[ks * 32 + lane], ah);
          frag_u32(qh[kQSet + ks * 32 + lane], al);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (page) {  // an int8 key is exact in TF32: q_lo.k, then q_hi.k
              mma_tf32(part[j], al, bh[j][s4]);
              mma_tf32(part[j], ah, bh[j][s4]);
            } else {  // lo.hi, hi.lo, hi.hi (lo = 0 on a tile's int8 rows)
              mma_tf32(part[j], al, bh[j][s4]);
              mma_tf32(part[j], ah, bl[j][s4]);
              mma_tf32(part[j], ah, bh[j][s4]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(s[j][e], part[j][e]);
        }
      }
      // times the scale, then K's scale on an int8 page key; keys dead for
      // the row take the finite mask value.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = kMmaRows * mt + 8 * hf + g;
        if (r < rows) {
          const int te = live.row_end((row0 + r) / groups);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = 16 * wq + 8 * j + 2 * t;
            float s0 = s[j][2 * hf] * p.scale, s1 = s[j][2 * hf + 1] * p.scale;
            if (!kF32 && int8_row(live, cur + k)) s0 *= sks[k];
            if (!kF32 && int8_row(live, cur + k + 1)) s1 *= sks[k + 1];
            float2 sc;
            sc.x = live.key_row(cur + k, te) ? s0 : kNegInf;
            sc.y = live.key_row(cur + k + 1, te) ? s1 : kNegInf;
            *reinterpret_cast<float2*>(ss + r * L::kLdS + k) = sc;
          }
        }
      }
    }
    __syncthreads();  // the scores; the K rows are read
    if (loader) {
      if constexpr (kF32) {
        if (nxt >= 0) load_f32_rows<D>(p, srow + (stage ^ 1) * kTile, false, ft);
      } else {
        if (!page) load_f32_tile<D>(p, live, b, kh, cur, true, ft, nullptr);
      }
    }

    // Online softmax; p times V's scale on an int8 page key (never rounded;
    // l adds the unscaled p), split into p's fragments of the row's tile.
    if constexpr (kFirstForm) {  // one warp a row, keys lane and lane + 32
      for (int r = warp; r < rows; r += kWarps) {
        const float s0 = ss[r * L::kLdS + lane];
        const float s1 = ss[r * L::kLdS + lane + 32];
        const float m_prev = sm[r];
        const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
        const float p0 = expf(s0 - m_next);
        const float p1 = expf(s1 - m_next);
        const float rs = warp_sum(p0 + p1);
        float w[2] = {p0, p1};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = lane + 32 * h;
          if (int8_row(live, cur + k)) w[h] *= svs[k];
          uint32_t hi, lo;
          split_tf32(w[h], hi, lo);
          pf[frag_at(r, k)] = __uint_as_float(hi);
          pf[kPSet + frag_at(r, k)] = __uint_as_float(lo);
        }
        if (lane == 0) {
          const float alpha = expf(m_prev - m_next);
          salpha[r] = alpha;
          sl[r] = alpha * sl[r] + rs;
          sm[r] = m_next;
        }
      }
    } else {
      // Eight lanes a row (lane j of a row's eight holds keys j + 8i), four
      // rows a warp at a time. The row sum adds in the order of a butterfly
      // over 32 lanes that each hold keys l and l + 32: lane l = j + 8k adds
      // keys j + 8k and j + 8k + 32, lanes l ^ 16 and l ^ 8 are added here,
      // l ^ 4, 2, 1 by shuffles; so the bits are those of a warp a row.
      const int j8 = lane & 7;
      for (int r0 = 4 * warp; r0 < rows; r0 += 4 * kWarps * kMT) {
        const int r = r0 + (lane >> 3);
        const bool in = r < rows;
        float w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = in ? ss[r * L::kLdS + j8 + 8 * i] : kNegInf;
        float mx = w[0];
#pragma unroll
        for (int i = 1; i < 8; ++i) mx = fmaxf(mx, w[i]);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = in ? sm[r] : kNegInf;
        const float m_next = fmaxf(m_prev, mx);
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = expf(w[i] - m_next);
        float rs = ((w[0] + w[4]) + (w[2] + w[6])) + ((w[1] + w[5]) + (w[3] + w[7]));
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
        if (in) {
          float* prow = pf + (r / kMmaRows) * 2 * kPSet;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int k = j8 + 8 * i;
            float x = w[i];
            if (!kF32 && int8_row(live, cur + k)) x *= svs[k];
            uint32_t hi, lo;
            split_tf32(x, hi, lo);
            prow[frag_at(r % kMmaRows, k)] = __uint_as_float(hi);
            prow[kPSet + frag_at(r % kMmaRows, k)] = __uint_as_float(lo);
          }
          if (j8 == 0) {
            const float alpha = expf(m_prev - m_next);
            salpha[r] = alpha;
            sl[r] = alpha * sl[r] + rs;
            sm[r] = m_next;
          }
        }
      }
    }
    if constexpr (kF32) {
      if (nxt >= 0) {
        cp_wait<1>();  // this tile's V rows; the next tile's K rows in flight
      } else {
        cp_wait<0>();
      }
    } else {
      if (!page) cp_wait<0>();
    }
    __syncthreads();  // p's fragments, alpha, the tile's V rows

    // acc = acc * alpha + p.V on warp wq's D / 4 columns of its row tile,
    // 32 keys a chunk. Column n of n8 block j is dimension wq D / 4 + kNT n +
    // j, so one read of kNT bytes (or floats) of a V row feeds every block
    // of the warp.
    if (busy) {
      const int r = kMmaRows * mt + g;
      const float alpha0 = r < rows ? salpha[r] : 0.f;
      const float alpha1 = r + 8 < rows ? salpha[r + 8] : 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[j][0] = __fmul_rn(acc[j][0], alpha0);
        acc[j][1] = __fmul_rn(acc[j][1], alpha0);
        acc[j][2] = __fmul_rn(acc[j][2], alpha1);
        acc[j][3] = __fmul_rn(acc[j][3], alpha1);
      }
      const int col = wq * (D / 4) + kNT * g;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        float part[kNT][4] = {};
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int ks = 4 * kc + s4;
          uint32_t ah[4], al[4];
          frag_u32(ph[ks * 32 + lane], ah);
          frag_u32(ph[kPSet / 4 + ks * 32 + lane], al);
          uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // V rows 8 ks + t and 8 ks + t + 4
            const int vr = 8 * ks + t + 4 * e;
            if (!kF32 && (page || int8_row(live, cur + vr))) {
              const uint8_t* row = page ? v8 + vr * L::kLd8 : reinterpret_cast<const uint8_t*>(
                                                                   ft + vr * L::kLdF);
              const uint2 w = ld_i8<kNT>(row + col);
#pragma unroll
              for (int j = 0; j < kNT; ++j) {
                bh[j][e] = i8_at8(w, j);
                bl[j][e] = 0u;
              }
            } else {
              float x[kNT];
              ld_f32<kNT>(fv + vr * L::kLdF + col, x);
#pragma unroll
              for (int j = 0; j < kNT; ++j) split_tf32(x[j], bh[j][e], bl[j][e]);
            }
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (page) {  // an int8 V row is exact in TF32: p_lo.v, then p_hi.v
              mma_tf32(part[j], al, bh[j]);
              mma_tf32(part[j], ah, bh[j]);
            } else {
              mma_tf32(part[j], al, bh[j]);
              mma_tf32(part[j], ah, bl[j]);
              mma_tf32(part[j], ah, bh[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
        }
      }
    }
    __syncthreads();  // the stage or f32 tiles, the scores and p are free again
    if constexpr (kF32) {
      if (loader && nxt >= 0) load_f32_rows<D>(p, srow + (stage ^ 1) * kTile, true, fv);
    } else {
      if (loader && !ahead && nxt >= 0) {  // a tile with tail rows: after this one
        load_f32_tile<D>(p, live, b, kh, nxt, false, ft, ssc + (stage ^ 1) * 2 * kTile);
      }
      page = ahead;
    }
    cur = nxt;
  }

  // The split's partial: m and l per row; acc's row g (and g + 8) of the
  // warp's row tile holds dimensions wq D / 4 + 2 t kNT .. + 2 kNT - 1 in
  // order (columns 2t of the kNT blocks, then 2t + 1), a run that head_dim
  // (a multiple of 16) holds whole or not at all.
  const long part = ((long)b * p.kv_heads + kh) * p.n_split + split;
  const int col0 = wq * (D / 4) + 2 * t * kNT;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = kMmaRows * mt + 8 * hf + g;
    if (r < rows && col0 < hd) {
      float run[2 * kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        run[j] = acc[j][2 * hf];
        run[kNT + j] = acc[j][2 * hf + 1];
      }
      float* dst = p.part_acc + (part * all_rows + row0 + r) * hd + col0;
      if constexpr (kNT == 1) {
        *reinterpret_cast<float2*>(dst) = make_float2(run[0], run[1]);
      } else {
#pragma unroll
        for (int i = 0; i < 2 * kNT; i += 4) {
          *reinterpret_cast<float4*>(dst + i) =
              make_float4(run[i], run[i + 1], run[i + 2], run[i + 3]);
        }
      }
    }
  }
  for (int r = tid; r < rows; r += kBlockThreads) {
    p.part_ml[(part * all_rows + row0 + r) * 2] = sm[r];
    p.part_ml[(part * all_rows + row0 + r) * 2 + 1] = sl[r];
  }
}

template <int D, bool kF32, int kMT, bool kTail>
int launch_mma(const Params& p, int batch, cudaStream_t stream) {
  static bool prepared = false;
  constexpr int kSmem = MmaLayout<D, kF32, kMT>::kBytes;
  auto kernel = paged_mma_f32_kernel<D, kF32, kMT, kTail>;
  if (!prepared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    prepared = true;
  }
  constexpr int kRows = kMT * kMmaRows;
  const int row_groups = (p.n_q * p.groups + kRows - 1) / kRows;
  kernel<<<dim3(p.n_split, p.kv_heads * row_groups, batch), kThreads * kMT, kSmem, stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  paged_merge_f32_kernel<D, kTail><<<dim3(p.n_q * p.groups, p.kv_heads, batch), p.head_dim,
                                     2 * static_cast<size_t>(p.n_split) * 4, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// m16 row tiles a block of the verify over f32 pools with `rows` query rows
// a KV head, from shapes alone. Up to D = 128: one up to 32 rows (blocks
// side by side), three past them (157 KB at D = 128, one block of twelve
// warps an SM). At D = 256: one up to 16 rows, two past them (227 KB; three
// do not fit). Timed with each count forced (NVIDIA H100 80GB HBM3, 700.00
// W; PERF.md §6), ms at one / two / three: 36 rows 0.0797 / 0.0934 / 0.0744,
// 80 rows 0.1355 / 0.1503 / 0.1308, 144 rows 0.2349 / 0.2536 / 0.2132, 9
// rows (D = 96) 0.0930 / 0.1419 / 0.1473, 18 rows (D = 32) within 2%; at D =
// 256, 72 rows, one / two 0.0529 / 0.0391. Two lose to one and three up to D
// = 128, so no two-row-tile instance is built there.
template <int D>
int f32_verify_row_tiles(int rows) {
  if (D <= 128) return rows <= 2 * kMmaRows ? 1 : 3;
  return rows <= kMmaRows ? 1 : 2;
}

// The instance for `rows` query rows, all on the tensor-core kernel. Over
// int8 pools the single query one row tile a block (groups of 16 of any G
// side by side), the verify past 16 rows kVerifyRowTiles row tiles a block,
// blocks side by side past them. Over f32 pools the single query (K3-f32,
// and K4-f32 without a tail) one row tile a block, the verify
// f32_verify_row_tiles.
template <int D, bool kTail, bool kI8>
int launch_rows(const Params& p, int batch, cudaStream_t stream, bool verify, int rows) {
  if constexpr (kI8) {
    if (verify && rows > kMmaRows) {
      return launch_mma<D, false, kVerifyRowTiles, true>(p, batch, stream);
    }
    return launch_mma<D, false, 1, true>(p, batch, stream);
  } else {
    if (!verify) return launch_mma<D, true, 1, kTail>(p, batch, stream);
    if constexpr (kTail) {
      if (f32_verify_row_tiles<D>(rows) == 1) return launch_mma<D, true, 1, true>(p, batch, stream);
      if constexpr (D <= 128) {
        return launch_mma<D, true, 3, true>(p, batch, stream);
      } else {
        return launch_mma<D, true, 2, true>(p, batch, stream);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);  // a verify has a tail
  }
}

template <bool kTail, bool kI8>
int dispatch(Params p, int batch, int n_q, bool verify, int heads, int head_dim,
             void* stream) {
  if (batch < 1 || n_q < 1 || (!verify && n_q != 1) || p.kv_heads < 1 ||
      heads % p.kv_heads || p.page_size < 1 || p.max_pages < 1 || p.n_pool < 1 ||
      (kTail && p.tail_len < 1) || p.split < kTile || p.split % kTile || head_dim < 16 ||
      head_dim > 256 || head_dim % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.groups = heads / p.kv_heads;
  p.n_q = n_q;
  p.head_dim = head_dim;
  const int rows = n_q * p.groups;
  const long keys = (long)p.max_pages * p.page_size + (kTail ? p.tail_len : 0);
  const long n_split = (keys + p.split - 1) / p.split;
  if (n_split > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  p.n_split = static_cast<int>(n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The smallest instance that holds head_dim.
  if (head_dim <= 32) return launch_rows<32, kTail, kI8>(p, batch, s, verify, rows);
  if (head_dim <= 64) return launch_rows<64, kTail, kI8>(p, batch, s, verify, rows);
  if (head_dim <= 128) return launch_rows<128, kTail, kI8>(p, batch, s, verify, rows);
  return launch_rows<256, kTail, kI8>(p, batch, s, verify, rows);
}

Params make_params(const void* q, const void* k_pages, const void* v_pages, const void* table,
                   const void* lengths, const void* starts, const void* tail_k,
                   const void* tail_v, void* o, void* part_acc, void* part_ml, int kv_heads,
                   int page_size, int max_pages, int n_pool, int tail_len, int split,
                   float scale) {
  return Params{static_cast<const float*>(q), static_cast<const float*>(k_pages),
                static_cast<const float*>(v_pages), static_cast<const int*>(table),
                static_cast<const int*>(lengths), static_cast<const int*>(starts),
                static_cast<const float*>(tail_k), static_cast<const float*>(tail_v),
                static_cast<float*>(o), static_cast<float*>(part_acc),
                static_cast<float*>(part_ml), kv_heads, 0, page_size, max_pages, n_pool,
                tail_len, split, 0, scale, 1};
}

// The same over int8 pools (P, K, ps, D) and their f32 scales (P, K, 1, ps).
Params make_params_i8(const void* q, const void* k_pages, const void* v_pages,
                      const void* k_scale, const void* v_scale, const void* table,
                      const void* lengths, const void* starts, const void* tail_k,
                      const void* tail_v, void* o, void* part_acc, void* part_ml,
                      int kv_heads, int page_size, int max_pages, int n_pool, int tail_len,
                      int split, float scale) {
  Params p = make_params(q, nullptr, nullptr, table, lengths, starts, tail_k, tail_v, o,
                         part_acc, part_ml, kv_heads, page_size, max_pages, n_pool, tail_len,
                         split, scale);
  p.k_i8 = static_cast<const int8_t*>(k_pages);
  p.v_i8 = static_cast<const int8_t*>(v_pages);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  return p;
}


}  // namespace

// K3-f32. q (B, H, D); pools (P, K, ps, D) with P = n_pool; table (B, maxp)
// int32; lengths and starts (B,) int32; tails (B, K, T, D); o (B, H, D), with
// D = head_dim a multiple of 16 up to 256 and any H / K. f32
// tensors, all contiguous. Workspace: part_acc f32 (B, K, n_split, H / K, D)
// and part_ml f32 (B, K, n_split, H / K, 2) with n_split = ceil((maxp * ps +
// T) / split), split a multiple of 64. Returns cudaGetLastError() after the
// two launches (0 = launched).
extern "C" int ditl_paged_tail_f32(const void* q, const void* k_pages, const void* v_pages,
                                   const void* table, const void* lengths, const void* starts,
                                   const void* tail_k, const void* tail_v, void* o,
                                   void* part_acc, void* part_ml, int batch, int heads,
                                   int kv_heads, int head_dim, int page_size, int max_pages,
                                   int n_pool, int tail_len, int split, float scale,
                                   void* stream) {
  const Params p = make_params(q, k_pages, v_pages, table, lengths, starts, tail_k, tail_v, o,
                               part_acc, part_ml, kv_heads, page_size, max_pages, n_pool,
                               tail_len, split, scale);
  return dispatch<true, false>(p, batch, 1, false, heads, head_dim, stream);
}

// K3-f32's multi-query verify: as ditl_paged_tail_f32 with q and o (B, Q, H,
// D), n_q = Q, and the workspace's H / K rows replaced by R = Q * H / K (any
// count: blocks side by side past a block's rows).
extern "C" int ditl_paged_verify_f32(const void* q, const void* k_pages, const void* v_pages,
                                     const void* table, const void* lengths,
                                     const void* starts, const void* tail_k,
                                     const void* tail_v, void* o, void* part_acc,
                                     void* part_ml, int batch, int n_q, int heads,
                                     int kv_heads, int head_dim, int page_size, int max_pages,
                                     int n_pool, int tail_len, int split, float scale,
                                     void* stream) {
  const Params p = make_params(q, k_pages, v_pages, table, lengths, starts, tail_k, tail_v, o,
                               part_acc, part_ml, kv_heads, page_size, max_pages, n_pool,
                               tail_len, split, scale);
  return dispatch<true, false>(p, batch, n_q, true, heads, head_dim, stream);
}

// K4-f32: the same without a tail; pages up to lengths; n_split =
// ceil(maxp * ps / split).
extern "C" int ditl_paged_f32(const void* q, const void* k_pages, const void* v_pages,
                              const void* table, const void* lengths, void* o, void* part_acc,
                              void* part_ml, int batch, int heads, int kv_heads, int head_dim,
                              int page_size, int max_pages, int n_pool, int split, float scale,
                              void* stream) {
  const Params p = make_params(q, k_pages, v_pages, table, lengths, nullptr, nullptr, nullptr,
                               o, part_acc, part_ml, kv_heads, page_size, max_pages, n_pool, 0,
                               split, scale);
  return dispatch<false, false>(p, batch, 1, false, heads, head_dim, stream);
}

// K3-f32 over int8 pools (variant F): as ditl_paged_tail_f32 with int8 pools
// (P, K, ps, D) and their f32 scales k_scale, v_scale (P, K, 1, ps); q and
// the tails f32.
extern "C" int ditl_paged_tail_i8_f32(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scale, const void* v_scale,
                                      const void* table, const void* lengths,
                                      const void* starts, const void* tail_k,
                                      const void* tail_v, void* o, void* part_acc,
                                      void* part_ml, int batch, int heads, int kv_heads,
                                      int head_dim, int page_size, int max_pages, int n_pool,
                                      int tail_len, int split, float scale, void* stream) {
  const Params p = make_params_i8(q, k_pages, v_pages, k_scale, v_scale, table, lengths,
                                  starts, tail_k, tail_v, o, part_acc, part_ml, kv_heads,
                                  page_size, max_pages, n_pool, tail_len, split, scale);
  return dispatch<true, true>(p, batch, 1, false, heads, head_dim, stream);
}

// Its multi-query verify: ditl_paged_verify_f32's shapes with
// ditl_paged_tail_i8_f32's pools and scales.
extern "C" int ditl_paged_verify_i8_f32(const void* q, const void* k_pages,
                                        const void* v_pages, const void* k_scale,
                                        const void* v_scale, const void* table,
                                        const void* lengths, const void* starts,
                                        const void* tail_k, const void* tail_v, void* o,
                                        void* part_acc, void* part_ml, int batch, int n_q,
                                        int heads, int kv_heads, int head_dim, int page_size,
                                        int max_pages, int n_pool, int tail_len, int split,
                                        float scale, void* stream) {
  const Params p = make_params_i8(q, k_pages, v_pages, k_scale, v_scale, table, lengths,
                                  starts, tail_k, tail_v, o, part_acc, part_ml, kv_heads,
                                  page_size, max_pages, n_pool, tail_len, split, scale);
  return dispatch<true, true>(p, batch, n_q, true, heads, head_dim, stream);
}
