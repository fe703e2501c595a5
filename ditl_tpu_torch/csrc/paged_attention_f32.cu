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
// Bound on the card: bytes. It must read each live key's K and V once per
// slot that reads it (2 * K * D * 4 bytes per key in f32, twice the bf16
// kernel's), the live tail, q and o, and does 4 * D flops per (query head,
// key): at the decode tick (8 slots, 32 query / 8 KV heads, D = 128, 4,343
// live keys) about 35.6 MB, 0.0106 ms at 3.35 TB/s, against 0.07 GFLOP of
// products (about 1 us at FFMA's 67 TFLOP/s). The verify at the spec tick
// (Q = 9) adds 9x the q and o bytes and 9x the flops: still bytes. So FFMA
// on the CUDA cores is enough, and what counts is keeping enough bytes in
// flight: each block copies both 64-key tiles of its split by 16-byte
// cp.async at once (128 KB at D = 128), one block per SM.
//
// Design: the bf16 template's split structure, its rules and its merge.
// - The grid is (split, KV head, slot), a split being `split` positions
//   (ops/paged_attention.py SPLIT_KEYS, a multiple of the 64-key tile) of
//   the slot's axis of max_pages * page_size page positions followed by
//   tail_len tail positions (K4: none); sized from shapes alone, so the
//   wrapper reads nothing back from the card. A block whose split holds no
//   live key stops at once and writes nothing; the merge gives it no
//   weight.
// - Inside a split, one 128-thread block walks its live 64-key tiles
//   (skipping tiles with no live column), the next tile's K and V in flight
//   by cp.async while the current one is computed (two stages; rows padded
//   by 16 bytes; dead rows zero-filled by the copy itself).
// - q.k: thread t takes key t % 64 and, in blocks of four query rows, every
//   other block from t / 64: each float4 of its K row (from shared memory;
//   eight threads read eight padded rows, 32 banks) feeds four rows' FMAs,
//   q's rows read as broadcasts. The verify's rows are r = qi * G + g.
// - Online softmax, one warp per query row, in f32; p is written over the
//   scores.
// - p.V: thread t takes four output columns (a float4 of each V row) of the
//   rows t / (D / 4) + k * (512 / D): its accumulators rescale by the row's
//   alpha in registers.
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
// explicitly). ops/paged_attention.py::paged_attention_split_plain is this
// kernel's twin in f32.
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
// - The single query (ditl_paged_tail_i8_f32, and a 4-D q with Q = 1) runs
//   paged_i8_mma_f32_kernel, paged_attention.cu's K3-int8 design with f32
//   numerics. Its first form staged int8 rows in the f32 kernel's row
//   slots (about 140 KB a block at D = 128: one block, four warps, an SM)
//   and ran both products on FFMA, a 16-byte load and 16 converts a thread
//   per key: 1.6x K3-f32, which reads four times its bytes (H100 SXM, 700
//   W).
//   - Grid, walk, merge and every rule below as the f32 kernel's: (split,
//     KV head and group of 16 of the G query rows, slot); 64-key tiles,
//     dead ones skipped; a split with nothing live returns at once.
//   - Small staging tiles. A page tile (every row below the tail) comes by
//     16-byte cp.async into two stages of raw int8 tiles, D + 32 bytes a
//     key, the next page tile in flight while one is computed; its two
//     scales by 4-byte copies into a scale tile. A tile with tail rows
//     (the tail's, or one that mixes page and tail rows) takes one f32
//     tile that aliases both stages: its K rows, then after q.k its V rows
//     (page rows as int8 bytes in the first D bytes of their f32 row, tail
//     rows f32, dead rows zeros); such a tile is loaded once the one
//     before it is done, as only the axis's last tiles hold tail rows. 71
//     KB a block at D = 128 (three blocks an SM), 34 / 46 / 120 KB at D =
//     32 / 64 / 256.
//   - Both products on the tensor cores (mma.sync.m16n8k8.tf32), 3xTF32:
//     the 16 query rows (G <= 16 a block, zero-padded) are the m16 A
//     operand, so each K and V tile serves the whole group. q is split
//     once a block into TF32 hi and lo = q - hi (flash_f32.cu's split_tf32)
//     A fragments, which shared memory holds in lane order (one 16-byte
//     read a k8 step; in registers they would take D registers a thread at
//     G = 16). An int8 key is exact in TF32, so a page tile takes two MMAs
//     a product, q_lo . k then q_hi . k; a tile with tail rows splits its
//     f32 rows too and takes three, lo.hi, hi.lo, hi.hi (lo = 0 on its
//     int8 rows): a choice per tile, the same for the whole block. p times
//     V's scale is formed in f32 and split into p's hi and lo fragments by
//     the softmax; p.V takes p_lo . v, p_hi . v on a page tile, three MMAs
//     on a tile with tail rows. Each 32-deep partial (32 dimensions of q.k,
//     32 keys of p.V) sums from zero and a rounded FADD adds it on (the
//     tensor cores' own accumulation truncates).
//   - int8 to TF32 in registers from the raw tile, no convert pass: the
//     contraction of q.k is permuted alike in both operands (k8 step 4c + s
//     takes dimensions 32c + 8t + 2s and + 1 for columns t and t + 4), so
//     one 8-byte read of a key row feeds four steps; p.V's output columns
//     are permuted (column n of n8 block j is dimension w D / 4 + (D / 32)
//     n + j), so one read of D / 32 bytes of a V row feeds all of a warp's
//     column blocks. A byte converts by one byte permute into 2^23 + (v +
//     128) and one FADD, exact.
//   - Rows: G <= 16 is one block; more run in groups of 16 side by side.
//     Scores mask by each row's tail limit, and q and o rows are indexed by
//     (query, group head), so the verify's Q G rows can move onto these
//     row tiles.
// - The verify (ditl_paged_verify_i8_f32, Q > 1) keeps the FFMA split
//   kernel's kI8 instances: a live page row's D int8 values staged into the
//   first D bytes of its f32 row, q . k 16 values a 16-byte load and p . V
//   four a 4-byte load, converted to f32 in registers (exact), a row taking
//   the int8 or the f32 read by whether it is a live page key.
//
// Head dims up to 32, 64, 128 and 256, one template whose D is a capacity:
// a call's head_dim (Params::head_dim, any multiple of 16 up to 256) runs on
// the smallest instance that holds it, as in paged_attention.cu. Rows are
// read at their true stride, one 16-byte copy per chunk (an f32 row of a
// multiple of 16 is whole float4 chunks, an int8 row whole 16-byte chunks);
// chunks past head_dim are zero-filled in shared memory, so they add exact
// zeros to q.k and zero columns to acc, which are never stored (the
// partials, the merge with head_dim threads and o take the true stride);
// the scale is the caller's head_dim**-0.5. At D = 256 a stage of K and V
// tiles is 130 KB, so the block keeps one stage (Layout::kStages = 1: the
// next tile loads once the current one is done, no overlap), and the p.V
// split's two row sets of 64 float4 columns would give an 80-row verify 160
// accumulators a thread beside its q rows' 83 KB: a block takes at most 48
// rows there (kBlockRows).
// Row groups: a call with more rows than a block takes (a verify past 80
// rows, or 48 at D = 256; Llama-3.1-405B's G = 16 at spec_k = 8 is 144)
// runs ceil(rows / kR) blocks side by side (blockIdx.y: KV head, then row
// group), each walking the split's tiles for its rows (each re-reads the
// split's K and V); their partials land in the same workspace rows the
// merge reads. A single query with G > 8 (and K4 with G > 8) takes the
// 16-, 48- or 80-row instances with n_q = 1 (over int8 pools, the
// tensor-core kernel's groups of 16). ptxas -v (sm_90a) with the run-time
// head_dim: D = 32 and 64 56-168 registers (4 bytes spilled in three
// forms); D = 128 single-query 116 (K4 96), 16 / 48 / 80 rows 128 / 190 /
// 198 (K4 128 / 168 / 184, 12 bytes spilled at 48; int8 168 at each, 36
// bytes spilled at 16); D = 256 single-query 204 (K4 206), 16 / 48 rows 206
// / 255 with 132 bytes spilled (K4 202 / 255 and 128 bytes; int8 182 / 255,
// none); merge 48-145; paged_i8_mma_f32_kernel 124 / 128 / 127 / 164 at D =
// 32 / 64 / 128 / 256, no spills (the FFMA single-query int8 forms it
// replaced spilled 4 bytes at D = 32 and 8 at D = 256).
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
constexpr int kSingleRows = 8;     // the single-query form's block: G <= 8 rows
constexpr int kMaxRows = 80;       // query rows (Q * G) of one block; more run side by side
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

// Shared memory of a split block with up to kR query rows, in floats:
// kStages stages of (K, V) tiles with rows padded by 16 bytes, q's rows
// padded the same way, the scores (then p) of kR rows, and m, l, alpha per
// row; over int8 pools, kStages stages of the tile's 64 K and 64 V scales
// after them (a page row's D int8 values sit in the first D bytes of its f32
// row). Two stages at D <= 128; one at D = 256, where a stage alone is 130
// KB: its next tile loads after the current one is done. D is the
// instance's capacity (columns past head_dim hold zeros).
template <int D, int kR>
struct Layout {
  static constexpr int kStages = D == 256 ? 1 : 2;
  static constexpr int kLd = D + 4;
  static constexpr int kTileF = kTile * kLd;
  static constexpr int kQ = 2 * kStages * kTileF;
  static constexpr int kS = kQ + kR * kLd;
  static constexpr int kM = kS + kR * kTile;
  static constexpr int kL = kM + kR;
  static constexpr int kAlpha = kL + kR;
  static constexpr int kSc = kAlpha + kR;
  static constexpr int kBytes = kSc * 4;
  static constexpr int kBytesI8 = (kSc + kStages * 2 * kTile) * 4;
  static_assert(kBytesI8 <= kMaxSmem, "shared memory of a block");
};

// The most query rows one block takes at D: 80, or 48 at D = 256 (its
// accumulators and its q rows); a verify with more rows runs ceil(rows /
// kR) blocks of rows side by side, each walking the split's tiles.
template <int D>
constexpr int kBlockRows = D == 256 ? 48 : kMaxRows;

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

// Byte i of w as a signed int8, in f32 (exact).
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
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

// K and V of the tile at t0 into a stage (kb: K, kb + kTileF: V), 16 bytes
// a copy; dead rows arrive as zeros. Over int8 pools (kI8) a live page
// row's D int8 values go to the first D bytes of its f32 row, and its two
// scales to sc (K, then V kTile floats on); the scales of tail and dead rows
// arrive as zeros. Rows are head_dim wide in device memory; their chunks past
// head_dim arrive as zeros.
template <int D, bool kI8>
__device__ __forceinline__ void load_tile(const Params& p, const Live& live, int b, int kh,
                                          int t0, float* kb, float* sc) {
  constexpr int kChunks = D / 4;
  constexpr int kChunksI8 = D / 16;
  constexpr int kLd = D + 4;
  static_assert(kThreads == 2 * kTile, "one thread per K or V scale of a tile");
  const int hd = p.head_dim;
  const int* trow = p.table + (long)b * p.max_pages;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int v = t0 + r;
    const bool ok = live.key(v);
    if (kI8 && ok && v < live.tail0) {
      if (c < kChunksI8) {
        const bool in = 16 * c < hd;
        const long page = min(max(trow[v / p.page_size], 0), p.n_pool - 1);
        const long off =
            in ? ((page * p.kv_heads + kh) * p.page_size + v % p.page_size) * hd + 16 * c : 0;
        cp_async16(kb + r * kLd + 4 * c, p.k_i8 + off, in);
        cp_async16(kb + kTile * kLd + r * kLd + 4 * c, p.v_i8 + off, in);
      }
      continue;
    }
    // Dead rows and chunks past head_dim read nothing; their address is any
    // valid one.
    const bool in = ok && 4 * c < hd;
    const float* ks = kI8 ? p.tail_k : p.k_pages;
    const float* vs = kI8 ? p.tail_v : p.v_pages;
    long off = 0;
    if (in) {
      if (v < live.tail0) {
        const long page = min(max(trow[v / p.page_size], 0), p.n_pool - 1);
        off = ((page * p.kv_heads + kh) * p.page_size + v % p.page_size) * hd + 4 * c;
      } else {
        ks = p.tail_k;
        vs = p.tail_v;
        off = (((long)b * p.kv_heads + kh) * p.tail_len + (v - live.tail0)) * hd + 4 * c;
      }
    }
    cp_async16(kb + r * kLd + 4 * c, ks + off, in);
    cp_async16(kb + kTile * kLd + r * kLd + 4 * c, vs + off, in);
  }
  if (kI8) {
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
  }
  cp_commit();
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

// One split of one (KV head, slot) for up to kR query rows (8: the
// single-query form, G <= 8 rows; 16, 48 or 80: the verify's Q * G rows, or
// a single query's G > 8 rows).
template <int D, bool kTail, int kR, bool kI8>
__global__ void __launch_bounds__(kThreads) paged_split_f32_kernel(const Params p) {
  using L = Layout<D, kR>;
  constexpr int kLd = L::kLd;
  constexpr int kCols = D / 4;                // float4 column groups of a row
  constexpr int kRowSets = kThreads / kCols;  // p.V: row sets (4 at D = 128, 8 at 64)
  static_assert(kR <= kBlockRows<D>, "rows of one block");
  constexpr int kRowsPT = (kR + kRowSets - 1) / kRowSets;
  extern __shared__ __align__(16) float smem[];
  float* qsm = smem + L::kQ;
  float* ss = smem + L::kS;
  float* sm = smem + L::kM;
  float* sl = smem + L::kL;
  float* salpha = smem + L::kAlpha;
  float* ssc = smem + L::kSc;  // int8 pools: two stages of K, then V, scales

  // blockIdx.y: the KV head, then the block's group of kR query rows (one
  // group unless Q * G > kR): rows row0 + r, r < rows, of the Q * G.
  const int split = blockIdx.x, kh = blockIdx.y % p.kv_heads, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = p.groups, hd = p.head_dim;
  const int all_rows = p.n_q * groups;
  const int row0 = blockIdx.y / p.kv_heads * kR;
  const int rows = min(kR, all_rows - row0);
  const Live live = slot_live<kTail>(p, b);
  const int v0 = split * p.split, v1 = min(v0 + p.split, live.end);
  int cur = live.next(v0, v1);
  if (cur < 0) return;  // no live key: no partial (the merge weighs this split 0)

  // q's rows (r = qi * G + g) into shared memory, committed with the first
  // tile; rows past the block's and chunks past head_dim zero.
  {
    const long heads = (long)p.kv_heads * groups;
    for (int idx = tid; idx < kR * kCols; idx += kThreads) {
      const int r = idx / kCols, c = idx % kCols;
      const bool ok = r < rows && 4 * c < hd;
      const int rr = row0 + r;
      const long qrow =
          ok ? ((long)b * p.n_q + rr / groups) * heads + (long)kh * groups + rr % groups : 0;
      cp_async16(qsm + r * kLd + 4 * c, p.q + qrow * hd + 4 * c, ok);
    }
  }
  for (int r = tid; r < kR; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  const int c4 = tid % kCols, rset = tid / kCols;
  float acc[kRowsPT][4];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  load_tile<D, kI8>(p, live, b, kh, cur, smem, ssc);
  __syncthreads();  // m and l initialised
  const int key = tid & (kTile - 1), half = tid / kTile;
  for (int stage = 0; cur >= 0; stage = (stage + 1) % L::kStages) {
    const int nxt = live.next(cur + kTile, v1);
    const float* kb = smem + stage * 2 * L::kTileF;
    const float* vb = kb + L::kTileF;
    // int8 pools: this stage's K and V scales (0 on tail and dead rows)
    const float* sks = ssc + stage * 2 * kTile;
    const float* svs = sks + kTile;
    if (L::kStages == 2 && nxt >= 0) {
      load_tile<D, kI8>(p, live, b, kh, nxt, smem + (stage ^ 1) * 2 * L::kTileF,
                        ssc + (stage ^ 1) * 2 * kTile);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the tile's K and V (and q) are in shared memory

    // Scores of key `key` for row blocks half, half + 2, ...: four rows a
    // block, times the scale in f32 (int8 pools: then times K's scale for a
    // page key); columns dead for the row get the finite mask value.
    const float* krow = kb + key * kLd;
    const bool key_i8 = kI8 && int8_row(live, cur + key);
    const float k_scale = key_i8 ? sks[key] : 1.f;
    for (int r0 = 4 * half; r0 < rows; r0 += 8) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (key_i8) {
        // 16 int8 values a 16-byte load; q . k in the same order as f32 keys.
#pragma unroll 2
        for (int d = 0; d < D; d += 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const uint8_t*>(krow) + d);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qsm + (r0 + e) * kLd + d + 4 * j);
              a[e] = fmaf(qv.x, i8_at(words[j], 0), a[e]);
              a[e] = fmaf(qv.y, i8_at(words[j], 1), a[e]);
              a[e] = fmaf(qv.z, i8_at(words[j], 2), a[e]);
              a[e] = fmaf(qv.w, i8_at(words[j], 3), a[e]);
            }
          }
        }
      } else {
#pragma unroll 8
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 qv = *reinterpret_cast<const float4*>(qsm + (r0 + e) * kLd + d);
            a[e] = fmaf(qv.x, kv.x, a[e]);
            a[e] = fmaf(qv.y, kv.y, a[e]);
            a[e] = fmaf(qv.z, kv.z, a[e]);
            a[e] = fmaf(qv.w, kv.w, a[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + e;
        if (r < rows) {
          const int te = live.row_end((row0 + r) / groups);
          float sc = a[e] * p.scale;
          if (key_i8) sc *= k_scale;
          ss[r * kTile + key] = live.key_row(cur + key, te) ? sc : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per query row; p over the scores (int8
    // pools: p times V's scale on a page key, never rounded; l adds the
    // unscaled p).
    for (int r = warp; r < rows; r += kWarps) {
      const float s0 = ss[r * kTile + lane];
      const float s1 = ss[r * kTile + lane + 32];
      const float m_prev = sm[r];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_next);
      const float p1 = expf(s1 - m_next);
      const float rs = warp_sum(p0 + p1);
      float w0 = p0, w1 = p1;
      if (kI8) {
        if (cur + lane < live.tail0) w0 *= svs[lane];
        if (cur + lane + 32 < live.tail0) w1 *= svs[lane + 32];
      }
      ss[r * kTile + lane] = w0;
      ss[r * kTile + lane + 32] = w1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        salpha[r] = alpha;
        sl[r] = alpha * sl[r] + rs;
        sm[r] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p.V for this thread's rows and four columns (dead
    // keys: p = 0 and V zero-filled).
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      const int r = rset + kRowSets * i;
      const float alpha = r < rows ? salpha[r] : 0.f;
      acc[i][0] *= alpha;
      acc[i][1] *= alpha;
      acc[i][2] *= alpha;
      acc[i][3] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float4 vv;
      if (kI8 && int8_row(live, cur + j)) {  // the same for every thread of the block
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const uint8_t*>(vb + j * kLd) + 4 * c4);
        vv = make_float4(i8_at(w, 0), i8_at(w, 1), i8_at(w, 2), i8_at(w, 3));
      } else {
        vv = *reinterpret_cast<const float4*>(vb + j * kLd + 4 * c4);
      }
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const int r = rset + kRowSets * i;
        if (r < rows) {
          const float pr = ss[r * kTile + j];
          acc[i][0] = fmaf(pr, vv.x, acc[i][0]);
          acc[i][1] = fmaf(pr, vv.y, acc[i][1]);
          acc[i][2] = fmaf(pr, vv.z, acc[i][2]);
          acc[i][3] = fmaf(pr, vv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // this stage's buffers and the scores are free again
    if (L::kStages == 1 && nxt >= 0) load_tile<D, kI8>(p, live, b, kh, nxt, smem, ssc);
    cur = nxt;
  }

  // The split's partial: m and l per row, acc (its columns below head_dim).
  const long part = ((long)b * p.kv_heads + kh) * p.n_split + split;
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const int r = rset + kRowSets * i;
    if (r < rows && 4 * c4 < hd) {
      *reinterpret_cast<float4*>(p.part_acc + (part * all_rows + row0 + r) * hd + 4 * c4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  for (int r = tid; r < rows; r += kThreads) {
    p.part_ml[(part * all_rows + row0 + r) * 2] = sm[r];
    p.part_ml[(part * all_rows + row0 + r) * 2 + 1] = sl[r];
  }
}

// ---------------------------------------------------------------------------
// K3-int8-f32, the single-query form over int8 pools, on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16;  // query rows of a block: the rows of the m16 A operand

// The block's shared memory, in bytes. Two stages of raw int8 K and V tiles
// (64 rows of D bytes, padded to D + 32 so the fragment reads below reach 32
// banks); the f32 tile of a tile with tail rows (64 rows of D + 8 floats,
// holding its K rows, then its V rows) aliases both stages, which such a
// tile never needs; then q's and p's A fragments (TF32 hi, then lo, 16 bytes
// a lane a k8 step), the scores of the 16 rows, m, l and alpha, and two
// stages of the tile's 64 K and 64 V scales.
template <int D>
struct MmaLayout {
  static constexpr int kLd8 = D + 32;
  static constexpr int kTile8 = kTile * kLd8;
  static constexpr int kStage = 2 * kTile8;
  static constexpr int kLdF = D + 8;
  static constexpr int kQF = 2 * kStage;
  static constexpr int kQFrag = D / 8 * 32 * 16;      // one of q's hi or lo fragment sets
  static constexpr int kPF = kQF + 2 * kQFrag;
  static constexpr int kPFrag = kTile / 8 * 32 * 16;  // one of p's
  static constexpr int kLdS = kTile + 4;
  static constexpr int kS = kPF + 2 * kPFrag;
  static constexpr int kM = kS + kMmaRows * kLdS * 4;
  static constexpr int kL = kM + kMmaRows * 4;
  static constexpr int kAlpha = kL + kMmaRows * 4;
  static constexpr int kSc = kAlpha + kMmaRows * 4;
  static constexpr int kBytes = kSc + 2 * 2 * kTile * 4;
  static_assert(kTile * kLdF * 4 <= 2 * kStage, "the f32 tile fits the two int8 stages");
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
  using L = MmaLayout<D>;
  constexpr int kChunks = D / 16;
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
// rows into the f32 tile ft: a live page row's D int8 bytes into the first D
// bytes of its f32 row, a tail row's f32 values, a dead row zeros (chunks
// past head_dim zero).
template <int D>
__device__ __forceinline__ void load_f32_tile(const Params& p, const Live& live, int b, int kh,
                                              int t0, bool is_v, float* ft, float* sc) {
  using L = MmaLayout<D>;
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

// The float index of element (row r, contraction index k) of an m16 x k8
// A fragment set laid out lane by lane (k8 step k / 8, lane 4 (r % 8) + k %
// 4, element r / 8 + 2 ((k % 8) / 4)).
__device__ __forceinline__ int frag_at(int r, int k) {
  return ((k >> 3) * 32 + ((r & 7) << 2) + (k & 3)) * 4 + (r >> 3) + (((k >> 2) & 1) << 1);
}

// One split of one (KV head, slot) for up to 16 query rows of a single
// query (blockIdx.y: the KV head, then the block's group of 16 of the G
// rows), q.k and p.V as 3xTF32 products on mma.sync.m16n8k8 (see "Over int8
// pools" in the header).
template <int D>
__global__ void __launch_bounds__(kThreads) paged_i8_mma_f32_kernel(const Params p) {
  using L = MmaLayout<D>;
  constexpr int kNT = D / 32;  // p.V: n8 column blocks a warp (D / 4 columns)
  extern __shared__ __align__(16) uint8_t mma_smem[];
  uint8_t* smem = mma_smem;
  float* ft = reinterpret_cast<float*>(smem);  // the f32 tile (aliases both stages)
  float4* qf = reinterpret_cast<float4*>(smem + L::kQF);  // q's A fragments: hi, then lo
  float* pf = reinterpret_cast<float*>(smem + L::kPF);    // p's: hi, then lo
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  float* sm = reinterpret_cast<float*>(smem + L::kM);
  float* sl = reinterpret_cast<float*>(smem + L::kL);
  float* salpha = reinterpret_cast<float*>(smem + L::kAlpha);
  float* ssc = reinterpret_cast<float*>(smem + L::kSc);

  const int split = blockIdx.x, kh = blockIdx.y % p.kv_heads, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int groups = p.groups, hd = p.head_dim;
  const int all_rows = p.n_q * groups;
  const int row0 = blockIdx.y / p.kv_heads * kMmaRows;
  const int rows = min(kMmaRows, all_rows - row0);
  const Live live = slot_live<true>(p, b);
  const int v0 = split * p.split, v1 = min(v0 + p.split, live.end);
  int cur = live.next(v0, v1);
  if (cur < 0) return;  // no live key: no partial (the merge weighs this split 0)
  // A tile with every row below tail0 is a page tile (int8 stages, two
  // MMAs a product); else it holds tail rows (the f32 tile, three MMAs).
  bool page = cur + kTile <= live.tail0;
  if (page) {
    load_i8_tile<D>(p, live, b, kh, cur, smem, ssc);
  } else {
    load_f32_tile<D>(p, live, b, kh, cur, false, ft, ssc);
  }

  // q's rows split once into TF32 hi and lo A fragments, in the order the
  // k8 steps read the keys' bytes: step 4c + s takes, for column t (t + 4),
  // dimension 32c + 8t + 2s (+ 1), so one 8-byte read of a key row feeds
  // four steps. Rows past the block's and dimensions past head_dim zero.
  {
    const long heads = (long)p.kv_heads * groups;
    for (int idx = tid; idx < D / 8 * 32; idx += kThreads) {
      const int ks = idx >> 5, fg = (idx >> 2) & 7, ft4 = idx & 3;
      const int d0 = 32 * (ks >> 2) + 8 * ft4 + 2 * (ks & 3);
      float2 x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = fg + 8 * h, rr = row0 + r;
        x[h] = make_float2(0.f, 0.f);
        if (r < rows && d0 < hd) {
          const long qrow = ((long)b * p.n_q + rr / groups) * heads + (long)kh * groups + rr % groups;
          x[h] = *reinterpret_cast<const float2*>(p.q + qrow * hd + d0);
        }
      }
      const float a[4] = {x[0].x, x[1].x, x[0].y, x[1].y};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], hi[e], lo[e]);
      qf[idx] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                            __uint_as_float(hi[2]), __uint_as_float(hi[3]));
      qf[D / 8 * 32 + idx] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                         __uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }
  }
  for (int i = tid; i < 2 * kTile / 8 * 32 * 4; i += kThreads) pf[i] = 0.f;  // padding rows: p = 0
  if (tid < kMmaRows) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int stage = 0; cur >= 0; stage ^= 1) {
    const int nxt = live.next(cur + kTile, v1);
    // The next tile is in flight during this one only if both are page tiles.
    const bool ahead = page && nxt >= 0 && nxt + kTile <= live.tail0;
    if (ahead) {
      load_i8_tile<D>(p, live, b, kh, nxt, smem + (stage ^ 1) * L::kStage,
                      ssc + (stage ^ 1) * 2 * kTile);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the tile's K (and V) and scales, q's fragments, m, l
    const uint8_t* k8 = smem + stage * L::kStage;
    const uint8_t* v8 = k8 + L::kTile8;
    const float* sks = ssc + stage * 2 * kTile;
    const float* svs = sks + kTile;

    // Scores of warp w's 16 keys (two n8 blocks), 32 dimensions a chunk:
    // each chunk's MMAs sum from zero and a rounded FADD adds them up.
    {
      float s[2][4] = {};
#pragma unroll 2
      for (int c = 0; c < D / 32; ++c) {
        uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 16 * warp + 8 * j + g;
          if (page || int8_row(live, cur + r)) {
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
          const float4 h4 = qf[ks * 32 + lane], l4 = qf[D / 8 * 32 + ks * 32 + lane];
          const uint32_t ah[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y),
                                  __float_as_uint(h4.z), __float_as_uint(h4.w)};
          const uint32_t al[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y),
                                  __float_as_uint(l4.z), __float_as_uint(l4.w)};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (page) {  // an int8 key is exact in TF32: q_lo.k, then q_hi.k
              mma_tf32(part[j], al, bh[j][s4]);
              mma_tf32(part[j], ah, bh[j][s4]);
            } else {  // lo.hi, hi.lo, hi.hi (lo = 0 on the tile's int8 rows)
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
      // times the scale, then K's scale on a page key; keys dead for the
      // row take the finite mask value.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 8 * hf + g;
        if (r < rows) {
          const int te = live.row_end((row0 + r) / groups);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = 16 * warp + 8 * j + 2 * t;
            float s0 = s[j][2 * hf] * p.scale, s1 = s[j][2 * hf + 1] * p.scale;
            if (int8_row(live, cur + k)) s0 *= sks[k];
            if (int8_row(live, cur + k + 1)) s1 *= sks[k + 1];
            float2 sc;
            sc.x = live.key_row(cur + k, te) ? s0 : kNegInf;
            sc.y = live.key_row(cur + k + 1, te) ? s1 : kNegInf;
            *reinterpret_cast<float2*>(ss + r * L::kLdS + k) = sc;
          }
        }
      }
    }
    __syncthreads();  // the scores; the f32 tile's K rows are read
    if (!page) load_f32_tile<D>(p, live, b, kh, cur, true, ft, nullptr);

    // Online softmax, one warp per query row; p times V's scale on a page
    // key (never rounded; l adds the unscaled p), split into p's fragments.
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
        pf[kTile / 8 * 32 * 4 + frag_at(r, k)] = __uint_as_float(lo);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        salpha[r] = alpha;
        sl[r] = alpha * sl[r] + rs;
        sm[r] = m_next;
      }
    }
    if (!page) cp_wait<0>();
    __syncthreads();  // p's fragments, alpha (and the f32 tile's V rows)

    // acc = acc * alpha + p.V on warp w's D / 4 columns, 32 keys a chunk.
    // Column n of n8 block j is dimension w D / 4 + kNT n + j, so one read
    // of kNT bytes (or floats) of a V row feeds every block of the warp.
    {
      const float alpha0 = g < rows ? salpha[g] : 0.f;
      const float alpha1 = g + 8 < rows ? salpha[g + 8] : 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[j][0] = __fmul_rn(acc[j][0], alpha0);
        acc[j][1] = __fmul_rn(acc[j][1], alpha0);
        acc[j][2] = __fmul_rn(acc[j][2], alpha1);
        acc[j][3] = __fmul_rn(acc[j][3], alpha1);
      }
      const int col = warp * (D / 4) + kNT * g;
      const float4* pfh = reinterpret_cast<const float4*>(pf);
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        float part[kNT][4] = {};
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int ks = 4 * kc + s4;
          const float4 h4 = pfh[ks * 32 + lane], l4 = pfh[kTile / 8 * 32 + ks * 32 + lane];
          const uint32_t ah[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y),
                                  __float_as_uint(h4.z), __float_as_uint(h4.w)};
          const uint32_t al[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y),
                                  __float_as_uint(l4.z), __float_as_uint(l4.w)};
          uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // V rows 8 ks + t and 8 ks + t + 4
            const int r = 8 * ks + t + 4 * e;
            if (page || int8_row(live, cur + r)) {
              const uint8_t* row = page ? v8 + r * L::kLd8 : reinterpret_cast<const uint8_t*>(
                                                                  ft + r * L::kLdF);
              const uint2 w = ld_i8<kNT>(row + col);
#pragma unroll
              for (int j = 0; j < kNT; ++j) {
                bh[j][e] = i8_at8(w, j);
                bl[j][e] = 0u;
              }
            } else {
              float x[kNT];
              ld_f32<kNT>(ft + r * L::kLdF + col, x);
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
    __syncthreads();  // the stage, the f32 tile, the scores and p are free again
    if (!ahead && nxt >= 0) {  // a tile with tail rows: after this one
      load_f32_tile<D>(p, live, b, kh, nxt, false, ft, ssc + (stage ^ 1) * 2 * kTile);
    }
    page = ahead;
    cur = nxt;
  }

  // The split's partial: m and l per row; acc's row g (and g + 8) holds
  // dimensions w D / 4 + 2 t kNT .. + 2 kNT - 1 in order (columns 2t of the
  // kNT blocks, then 2t + 1), a run that head_dim (a multiple of 16) holds
  // whole or not at all.
  const long part = ((long)b * p.kv_heads + kh) * p.n_split + split;
  const int col0 = warp * (D / 4) + 2 * t * kNT;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 8 * hf + g;
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
  for (int r = tid; r < rows; r += kThreads) {
    p.part_ml[(part * all_rows + row0 + r) * 2] = sm[r];
    p.part_ml[(part * all_rows + row0 + r) * 2 + 1] = sl[r];
  }
}

template <int D>
int launch_i8_mma(const Params& p, int batch, cudaStream_t stream) {
  static bool prepared = false;
  constexpr int kSmem = MmaLayout<D>::kBytes;
  auto kernel = paged_i8_mma_f32_kernel<D>;
  if (!prepared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    prepared = true;
  }
  const int row_groups = (p.n_q * p.groups + kMmaRows - 1) / kMmaRows;
  kernel<<<dim3(p.n_split, p.kv_heads * row_groups, batch), kThreads, kSmem, stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  paged_merge_f32_kernel<D, true><<<dim3(p.n_q * p.groups, p.kv_heads, batch), p.head_dim,
                                    2 * static_cast<size_t>(p.n_split) * 4, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kTail, int kR, bool kI8>
int launch(const Params& p, int batch, cudaStream_t stream) {
  static bool prepared = false;
  constexpr int kSmem = kI8 ? Layout<D, kR>::kBytesI8 : Layout<D, kR>::kBytes;
  auto kernel = paged_split_f32_kernel<D, kTail, kR, kI8>;
  if (!prepared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    prepared = true;
  }
  const int row_groups = (p.n_q * p.groups + kR - 1) / kR;
  kernel<<<dim3(p.n_split, p.kv_heads * row_groups, batch), kThreads, kSmem, stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  paged_merge_f32_kernel<D, kTail><<<dim3(p.n_q * p.groups, p.kv_heads, batch), p.head_dim,
                                     2 * static_cast<size_t>(p.n_split) * 4, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instance for `rows` query rows: 8 for the single-query form at G <=
// 8; else 16, 48 or 80 (48 at D = 256, kBlockRows), and blocks of that many
// rows side by side past it.
template <int D, bool kTail, bool kI8>
int launch_rows(const Params& p, int batch, cudaStream_t stream, bool verify, int rows) {
  if constexpr (kI8) {  // a single query over int8 pools: the tensor-core kernel, any G
    if (!verify) return launch_i8_mma<D>(p, batch, stream);
  } else {
    if (!verify && rows <= kSingleRows) return launch<D, kTail, kSingleRows, kI8>(p, batch, stream);
  }
  if (rows <= 16) return launch<D, kTail, 16, kI8>(p, batch, stream);
  if (rows <= 48) return launch<D, kTail, 48, kI8>(p, batch, stream);
  return launch<D, kTail, kBlockRows<D>, kI8>(p, batch, stream);
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
