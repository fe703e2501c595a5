// Paged decode attention for Hopper (sm_90a), bf16 in, f32 softmax, as
// split-key flash-decoding.
//
// Replaces two Pallas TPU kernels of ditl_tpu/ops/paged_attention.py:
// - K3 _paged_tail_kernel (with _accumulate_block and _finalize_out), the
//   decode tick's kernel: one query token per slot attends the slot's KV
//   pages through the page table, positions [0, min(starts, lengths)), and
//   then the tick's contiguous tail buffer, positions [starts, lengths);
// - K4 _paged_kernel, the same without a tail: pages up to lengths.
// Entry points: ditl_paged_tail_bf16 (K3), ditl_paged_tail_i8 (K3 over int8
// pools: _paged_tail_kernel with quantized=True), ditl_paged_verify_bf16 and
// ditl_paged_verify_i8 (K3's multi-query verify: _paged_tail_kernel with
// q_groups, over float and int8 pools) and ditl_paged_bf16 (K4). Two
// kernels, each a template for head dims up to 32, 64, 128 and 256 (any
// head_dim that is a multiple of 16 up to 256 runs on the smallest instance
// that holds it, see "Head dims" below): paged_split_kernel, the single
// query at up to 8 query rows per KV head, and paged_rows_kernel, the verify
// and any call with more rows (see "The row-tile kernel" and "Row groups"
// below); one merge serves both. The same five on
// float16 q, tails and float pools (the reference's kernels take any float
// dtype with f32 sums) are the template's kF16 instances:
// ditl_paged_tail_f16, ditl_paged_tail_i8_f16, ditl_paged_verify_f16,
// ditl_paged_verify_i8_f16 and ditl_paged_f16 (see "float16" below).
//
// Bound on the card: the kernel is bytes-bound. It must read each live key's
// K and V once per slot that reads it (2 * K * D * 2 bytes per key), the live
// tail, q and o; it does 4 * D flops per (query head, key). At the serving
// shape (8 slots, 32 query / 8 KV heads, D = 128, a few hundred to ~1500 live
// keys per slot) that is a few MB per call: about 5 us at 3.35 TB/s, against
// well under a microsecond of tensor-core time. So the time goes to latency:
// how many blocks are in flight and how long each one's chain of dependent
// loads is.
//
// Design:
// - Split keys. A slot's keys lie on one axis of max_pages * page_size page
//   positions followed by tail_len tail positions (K4: no tail). The grid is
//   (split, KV head, slot), a split being a fixed run of `split` positions
//   (ops/paged_attention.py SPLIT_KEYS or, for the row-tile kernel,
//   split_keys; a multiple of the 64-key tile), so
//   the grid is sized from shapes the host knows, never from lengths or
//   starts: the wrapper reads nothing back from the card, and a decode step
//   can be captured in a CUDA graph. A block whose split holds no live key
//   stops at once and writes nothing; the merge, applying the same rule to
//   the same lengths, gives that split no weight.
// - Inside a split, one 128-thread block (the single-query form) walks its live 64-key tiles
//   (skipping tiles with no live column) with the next tile's K and V in
//   flight by cp.async while the current one is computed (two stages, 34 KB
//   each at D = 128, rows padded by 16 bytes, dead rows zero-filled by the
//   copy itself).
// - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   sums), the G = H / K query rows of a KV head (G <= 8) as rows 0-7 of
//   the 16-row A operand, so every K and V tile serves the whole GQA group.
//   q.k: each warp takes 16 keys of a tile, q's fragments in registers, K's
//   read from shared memory. p.V: each warp takes D / 4 output columns, p
//   (bf16) from shared memory, V's fragments by ldmatrix.trans. A thread per
//   (row, key) dot and per output column (the first form of this design)
//   ran at about 6 us a tile: chains of dependent shared loads, FMAs and
//   shuffles that four warps a block could not hide.
// - Online softmax per tile, one warp per query row, in f32.
// - Each block writes its partial (m and l per query row, f32 acc) to a
//   workspace the wrapper allocates. A second small kernel, one block per
//   (query row, KV head, slot), merges the partials in split order, so two
//   calls give the same bits. Its loads are issued in batches before their
//   values are used, so it costs a few L2 round trips. Merging in the last
//   block of a (slot, KV head) to finish instead (an atomic count after a
//   GPU-scope fence, on counts zeroed each call) measured slower on the card
//   (PERF.md).
// The first design (one block per slot x KV head, a serial loop over 64-key
// tiles with plain loads, a thread per (row, key) dot) gave 64 blocks for
// 132 SMs and ran at 6% of the bound, paced by the longest slot.
//
// int8 pools (ditl_paged_tail_i8). The pools hold int8 values and f32
// scales of shape (P, K, 1, ps), one per (page, KV head, position); the tail
// stays bf16. Bound at the decode tick (8 slots, 4,343 live keys, 8 KV heads,
// D = 128): 8.9 MB of int8 K/V plus 0.28 MB of scales, about 2.7 us at 3.35
// TB/s, half the float kernel's bytes. The single-query kernel's kI8
// instances (G <= 8) feed both products from the raw int8 tiles: a page
// tile's D int8 bytes a row come by cp.async (16 values a copy) into two
// stages of int8 tiles, rows padded by 16 bytes, the row's two scales by
// 4-byte cp.async into a scale stage; each B fragment is read from the int8
// tile and widened in registers by byte permutes (i8x2_exact, i8_pair;
// int8 -> bf16 or float16 is exact: |q| <= 127), q.k's contraction and
// p.V's output columns permuted so that one 4-byte read is a lane's K
// fragment of a k16 step and one read of D / 32 bytes its V column of
// every n8 block (see paged_split_kernel). No convert pass and no 16-bit
// copy of a page row: four barriers a tile, as the float kernel. A tile
// with tail rows (the axis's last ones) takes one 16-bit K and V tile over
// both stages, tail and dead rows 16-bit, page rows' int8 bytes staged in
// place (Layout::kInPlaceAt), read row by row; it loads once the tile
// before it is done. Block bytes at D = 32 / 64 / 128 / 256: 17 / 25 / 41 /
// 74 KB (the first form, with a bf16 copy of each tile and a convert pass:
// 104 KB at D = 128). K's scale multiplies each page key's f32 score (times
// the softmax scale) before the running max; V's scale multiplies p, before
// p's rounding to bf16 for the p.V product, while the row sum l adds the
// unscaled p, so acc / l is the reference's sum of (p * vs) . v over sum of
// p. Tail keys take scale 1. The row-tile kernel's int8 instances (the
// verify, G > 8) keep a convert pass into 16-bit tiles (below).
//
// The row-tile kernel (paged_rows_kernel<D, kTail, kI8, kF16, kKG>): every
// verify (ditl_paged_verify_*: q (B, Q, H, D), the speculative verify's Q =
// spec_k + 1 query tokens per slot, which share every page fetch) and every
// call with more than 8 query rows per KV head (a single query at G > 8, K4
// too). The query rows of a KV head are r = qi * G + g (Q * G of them). Row
// r's tail columns j are live when starts + j < lengths + qi (causal within
// the verify chunk), page columns below min(starts, lengths) for every row,
// and the tail is read only when lengths > starts (the Pallas kernel's _tail
// gate). Bound at the spec tick of llama3-8b (8 slots, Q = 9, 32 / 8 heads,
// D = 128, 4,343 live keys, 54 tail columns): the float K3's 17.8 MB of K/V
// plus 9x its q and o, about 19 MB, 5.7 us at 3.35 TB/s, against 0.65 GFLOP
// of products (under a microsecond): bytes-bound, each K and V tile serving
// all Q * G rows. Its first form (the single-query template's kMT = 1, 3, 5
// instances) ran the softmax one warp a row through shared memory, four
// barriers a tile, and row groups of 80 rows that each re-read the split:
// 0.0489 ms at the spec tick, 0.1849 ms at 144 rows (PERF.md §6). This one:
// - One warp per m16 row tile of 16 query rows, over the whole 64-key tile:
//   q.k from q's A fragments (ldmatrix from shared memory, where the q rows
//   sit padded as the key rows) and K's B fragments (ldmatrix, two n8 key
//   blocks a load), eight n8 score blocks a warp in registers, each score
//   masked by its row's tail limit (no masks on a tile whose keys every row
//   sees). The online softmax in registers: a thread holds two rows x 16
//   keys, the row max and sum take two __shfl_xor steps in the quad, m, l
//   and alpha live in registers. p (times V's scale over int8 pages, rounded
//   to the 16-bit type; l adds the f32 p) is packed straight into p.V's A
//   fragments: the m16n8k16 sums of two adjacent n8 score blocks are one
//   k16 step's A fragment (FlashAttention-2's layout). p.V runs over all D
//   columns a warp (acc[D / 8][4]: 64 registers at D = 128), V's fragments
//   by ldmatrix.trans from the stage every warp reads. No score, p or alpha
//   arrays in shared memory: two barriers a tile (the tile is in; its stage
//   is free), plus the int8 convert's, which widens int8 rows by byte
//   permutes (i8x16_convert_exact: the same values, fewer instructions).
// - All of a KV head's rows in one block, up to Rows<D>::kMaxTiles row tiles
//   (12 at D = 128, 16 at D <= 64, 8 at D = 256: the registers a thread may
//   take at that many warps), so each split's K and V are loaded and
//   converted once for every row (path 16's 144 rows: nine warps).
// - Few row tiles: a block keeps at least four warps to issue its copies
//   and hide latency. One row tile takes kKG = 4 warps, two or three tiles
//   kKG = 2 warps each; the kKG warps of a tile take disjoint keys of every
//   key tile (16 or 32), each with its own m, l and acc, and hand them to the
//   tile's first warp through shared memory after the last tile (the stages
//   are free), which combines them in key order, each weighted exp(m_w - max
//   m_w), 0 where m_w is the mask value (nothing live for the row in the
//   warp's keys), and writes the partial.
// - Split length. The partials (rows x D f32 per split) grow with the rows:
//   at 144 rows they are 112% of the bf16 K/V bytes a 128-key split reads.
//   The wrapper takes 256-key splits where the call holds at least 2304
//   query rows (B * Q * H), 128 below (ops/paged_attention.py split_keys,
//   measured on the card at every shape: PERF.md §6), from shapes
//   alone. The merge reads fewer partials, and blocks fewer splits.
// Shared memory at D = 128: 68 KB of stages plus 272 bytes a q row (81 KB at
// 36 rows, 106 KB at 144), over int8 pools 33 KB more; at D = 256 int8 rows
// are staged in place (Rows<256>::kInPlace), 199 KB at 128 rows.
//
// Row groups. A KV head with more row tiles than Rows<D>::kMaxTiles (e.g.
// 272 rows at D = 128, 144 at D = 256) runs as few blocks side by side as
// hold them, each of as even a size as the tiles allow: blockIdx.y is the KV
// head, then the row group. Each walks the split's tiles for its own rows
// (every row group re-reads the split's K and V) and writes its rows'
// partials into the workspace rows the merge reads. Tiles and splits stay
// live by the union over all Q rows of the slot, so a block meets tiles with
// nothing live for its rows exactly as a verify row does (the rule below);
// each row's arithmetic is the same in any grouping.
//
// The rule for rows with nothing live in a split. A tile (and a split) is
// processed when any row has a live key in it, so a verify row can meet
// tiles that hold nothing live for it: the tail crosses a 64-key tile or a
// 128-key split boundary between rows (qi = 8 reaches a split that qi = 0
// does not). A row's live keys are a prefix of each region (pages, then
// tail columns below its limit), so such tiles come after the row's live
// ones. Where the split held a live tile for the row first, its m is a real
// score and p = exp(mask - m) = 0 on the dead tile. Where the split holds
// nothing live for the row, its scores are all the finite mask value, its m
// stays -2.3819763e38 and p = exp(0) = 1 on every column: l and acc take
// junk, and the merge gives that partial weight 0, testing m == mask
// explicitly (exp(mask - m_max) would underflow to 0 as well, since every
// row of a live slot has a live key, tail column 0 at least).
// ops/paged_attention.py::paged_attention_split_plain encodes the same rule.
//
// float16. The bytes, the bound and the design are bf16's: the kF16
// instances differ only in the element type the tensor cores read
// (mma.sync m16n8k16 .f16 in place of .bf16, the same fragment layouts and
// ldmatrix loads), the int8 -> float16 widening (exact: |q| <= 127 <
// 2^11), and the rounding of p (times V's scale over int8 pages) and of o
// to float16 in place of bf16. The bf16 instances keep their code and bits
// (chip_smoke.py K3_DIGESTS).
//
// Head dims. The template's D is a capacity: a call's head_dim (Params::
// head_dim, any multiple of 16 up to 256) runs on the smallest of the 32,
// 64, 128 and 256 instances that holds it. Pool, tail and q rows are read at
// their true stride, one 16-byte copy per chunk (a multiple of 16 keeps
// every bf16, float16 and int8 row whole chunks); the chunks past head_dim
// are zero-filled in shared memory (cp.async with a zero source size; over
// int8 pools the staged chunks, which the convert pass widens to zeros), so
// q's and K's columns past head_dim add exact zeros to q.k and V's add zero
// columns to acc, which are never stored: the partials, the merge (head_dim
// threads) and o use the true stride. The scale is the caller's, the true
// head_dim**-0.5. At an instance's own head_dim every copy is live and the
// arithmetic is the earlier build's. Phi-3-mini's D = 96 runs on the 128
// instance (a quarter of its copies are zero fills and warp 3's p.V columns
// are zeros: time over bytes is what PERF.md records for it).
// D = 64 and 128 were the first instances; 32 (tiny-llama, the default
// ModelConfig) and 256 keep the design and add two rules.
// - D = 32: the single-query p.V split gives each of the four warps D / 8 /
//   4 = 1 n8 column block, so the odd last block takes ldmatrix.x2.trans
//   (one block's two 8 x 8 matrices) where the pairs take .x4; a bf16 row is
//   4 16-byte chunks (every copy and convert loop divides evenly: 64 rows x
//   4 chunks over 128 threads).
// - D = 256: a padded row is 528 bytes, two stages of K/V tiles 132 KB. The
//   row-tile kernel over int8 pools would add 64 KB of int8 staging past the
//   227 KB a block may take at 8 row tiles; there (Rows<256>::kInPlace,
//   chosen by size) a live page row's int8 bytes are staged into the last D
//   bytes of its own padded 16-bit row, and the convert pass, one thread a
//   row, widens them from the front in chunk order (chunk c's output ends
//   before chunk c + 1's input begins), so no staging tile is needed.
// ptxas -v (sm_90a), with the run-time head_dim: the single-query kernel at
// D = 32 / 64 / 128 / 256 48 / 76 / 112 / 206 registers (K4 48 / 72 / 103 /
// 192; int8 84 / 85 / 127 / 203 in bf16 and float16, no spills, its first
// form 56 / 72 / 182 / 188; at D = 256 a launch bound of three blocks an SM
// spilled 104 bytes, so it names two); blocks an SM over int8 pools (shared
// memory and registers) 5 / 5 / 4 / 2 (the first form two at D = 128);
// the row-tile kernel at kKG = 1 / 2 / 4 93-113 /
// 61-72 / 48-56 at D = 32, 113-127 / 76-87 / 72-79 at D = 64, 149-167 /
// 129-137 / 107-126 at D = 128, 247-253 / 168-218 / 168-190 at D = 256; no
// spills; merge 62-139; the bf16 and float16 instances alike.
//
// Semantics kept from the reference: the q.k scores are f32 and scaled in
// f32 (here the scale multiplies the f32 sums of the exact bf16 products,
// which differs from scaling q first by f32 rounding alone); masked columns
// of a processed tile get the finite -2.3819763e38 (never -inf); only tiles
// with a live column are processed; tail column j is live when starts + j <
// lengths; out-of-range page ids clamp into the pool; p is rounded to bf16
// (v's type) before the p.v product, which accumulates in f32, while the row
// sum l adds the f32 p; a row with l == 0 (a dead slot, length 0) writes 0;
// o is bf16. Within a split p is relative to the split's running max; the
// combine rescales each split's l and acc by exp(m_s - max_s m_s) in f32,
// with no second rounding to bf16. ops/paged_attention.py::
// paged_attention_split_plain computes the same in the same order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // the single-query kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // keys per tile; two per lane in the softmax
constexpr int kSingleRows = 8;  // the single-query form's rows: rows 0-7 of the m16 A operand
constexpr int kPLd = kTile + 8;  // bf16 p row, padded: 144 bytes
constexpr int kMergeBatch = 32;  // merge: splits whose acc values are loaded at once
constexpr int kMaxSplits = 6144;  // the merge's m and l: 48 KB of shared memory
constexpr float kNegInf = -2.3819763e38f;  // ops/attention.py NEG_INF
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take

struct Params {
  const uint16_t* q;        // (B, H, D); verify (B, Q, H, D)
  const uint16_t* k_pages;  // (P, K, ps, D), float pools
  const uint16_t* v_pages;
  const int* table;         // (B, max_pages)
  const int* lengths;       // (B,)
  const int* starts;        // (B,), K3 only
  const uint16_t* tail_k;   // (B, K, T, D), K3 only
  const uint16_t* tail_v;
  uint16_t* o;              // shaped as q
  float* part_acc;          // (B, K, n_split, R, D), R = n_q * G query rows
  float* part_ml;           // (B, K, n_split, R, 2): m, l
  int kv_heads, groups, page_size, max_pages, n_pool, tail_len, split, n_split;
  float scale;
  const int8_t* k_i8;       // (P, K, ps, D), int8 pools (ditl_paged_tail_i8)
  const int8_t* v_i8;
  const float* k_scale;     // (P, K, 1, ps)
  const float* v_scale;
  int n_q;                  // query tokens per slot: 1, or the verify's Q
  int head_dim;             // the rows' true width: a multiple of 16, <= the instance's D
  int row_tiles;            // paged_rows_kernel: m16 row tiles of a block
};

// Shared memory of the single-query split block: two stages of (K, V) tiles
// with rows padded by 16 bytes (so that 8 rows at one column reach 32
// banks), then the f32 scores, the bf16 p rows, m, l and alpha of its
// kSingleRows query rows. D is the instance's capacity (columns past
// head_dim hold zeros).
template <int D>
struct Layout {
  static constexpr int kRows = kSingleRows;
  static constexpr int kLd = D * 2 + 16;  // bytes of one padded key row
  static constexpr int kTileBytes = kTile * kLd;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kS = 2 * kStageBytes;
  static constexpr int kP = kS + kRows * kTile * 4;
  static constexpr int kM = kP + kRows * kPLd * 2;
  static constexpr int kL = kM + kRows * 4;
  static constexpr int kAlpha = kL + kRows * 4;
  static constexpr int kBytes = kAlpha + kRows * 4;
  // int8 pools (paged_rows_kernel): two stages of raw int8 K and V tiles (D
  // bytes a key), then two stages of the tile's 64 K and 64 V scales. Where
  // raw tiles do not fit beside the rest (at D = 256), a page row's int8
  // values are staged in place instead: into the last D bytes of its own
  // padded 16-bit row, which the convert pass then fills from the front
  // (the single-query kernel's tile with tail rows stages them there too,
  // and reads them in place).
  static constexpr int kQTile = kTile * D;
  static constexpr int kQStage = 2 * kQTile;
  static constexpr int kQ = kBytes;
  static constexpr int kScStage = 2 * kTile * 4;
  static constexpr int kSc = kQ + 2 * kQStage;
  static constexpr int kInPlaceAt = kLd - D;  // a row's staged int8 bytes
};

// Shared memory of the single-query block over int8 pools (paged_split_kernel's
// kI8 instances): two stages of raw int8 K and V tiles, rows of D bytes
// padded by 16 (so the 4-byte fragment reads of 8 keys x 4 lanes reach 32
// banks), which a tile with tail rows overlays with one 16-bit K and V tile
// (Layout's padded rows; its page rows' int8 bytes staged in place, at
// kInPlaceAt of their own rows); then the f32 scores, the 16-bit p rows, m,
// l and alpha of the kSingleRows query rows, and two stages of the tile's
// 64 K and 64 V scales.
template <int D>
struct SingleI8 {
  static constexpr int kLd8 = D + 16;
  static constexpr int kTile8 = kTile * kLd8;
  static constexpr int kStage = 2 * kTile8;  // K, then V
  static constexpr int kS = 2 * kStage;
  static constexpr int kP = kS + kSingleRows * kTile * 4;
  static constexpr int kM = kP + kSingleRows * kPLd * 2;
  static constexpr int kL = kM + kSingleRows * 4;
  static constexpr int kAlpha = kL + kSingleRows * 4;
  static constexpr int kSc = kAlpha + kSingleRows * 4;
  static constexpr int kScStage = 2 * kTile * 4;
  static constexpr int kBytes = kSc + 2 * kScStage;
  static_assert(Layout<D>::kStageBytes <= kS, "the 16-bit tile fits the two int8 stages");
};

// paged_rows_kernel's shared memory at capacity D and nt row tiles: the
// single-query block's two K/V stages, then nt * 16 q rows padded as the
// key rows; over int8 pools the raw int8 stages (none in place) and the
// scale stages. No score, p, m, l or alpha arrays: they live in registers.
// kMaxTiles caps a block's row tiles (one warp each, the thread bound
// below it); past it, row groups run side by side.
template <int D>
struct Rows {
  using L = Layout<D>;
  static constexpr int kMaxTiles = D == 256 ? 8 : D == 128 ? 12 : 16;
  static constexpr int kQRows = L::kS;
  static constexpr int kTileQ = 16 * L::kLd;  // a row tile's q rows
  static constexpr bool kInPlace =
      kQRows + kMaxTiles * kTileQ + 2 * L::kQStage + 2 * L::kScStage > kMaxSmem;
  static constexpr int kStaging = kInPlace ? 0 : 2 * L::kQStage;
  __host__ __device__ static constexpr int qi8(int nt) { return kQRows + nt * kTileQ; }
  __host__ __device__ static constexpr int sc(int nt) { return qi8(nt) + kStaging; }
  __host__ __device__ static constexpr int bytes(int nt, bool i8) {
    return i8 ? sc(nt) + 2 * L::kScStage : qi8(nt);
  }
};

// Threads of a paged_rows_kernel block with kKG warps a row tile: one row
// tile (kKG 4), two or three (kKG 2), or up to Rows<D>::kMaxTiles (kKG 1).
template <int D, int kKG>
struct RowsBlock {
  static constexpr int kTiles = kKG == 4 ? 1 : kKG == 2 ? 3 : Rows<D>::kMaxTiles;
  static constexpr int kThreads = 32 * kKG * kTiles;
  static_assert(Rows<D>::bytes(kTiles, true) <= kMaxSmem, "shared memory of a block");
  // kKG > 1: the warps' acc, m and l and the rows' weights, combined after
  // the last tile, fit the stages.
  static_assert(kKG == 1 || kKG * kTiles * 16 * (D + 3) * 4 <= Layout<D>::kS,
                "combine buffer");
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// 16 bytes global -> shared, in flight until cp_wait; with valid == false
// the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (a scale); with valid == false, zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// A float rounded to the kernel's 16-bit type (kF16: float16, else bf16),
// as its bits.
template <bool kF16>
__device__ __forceinline__ uint16_t to_bits(float x) {
  if constexpr (kF16) return __half_as_ushort(__float2half_rn(x));
  else return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Two floats rounded to the 16-bit type, packed: x in the low half.
template <bool kF16>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  return static_cast<uint32_t>(to_bits<kF16>(x)) | (static_cast<uint32_t>(to_bits<kF16>(y)) << 16);
}

// Two int8 values (bits lo..lo+15 of w) as a pair of the 16-bit type; exact
// in both (|q| <= 127).
template <bool kF16>
__device__ __forceinline__ uint32_t i8x2_to_x2(uint32_t w, int lo) {
  const float a = static_cast<float>(static_cast<int8_t>((w >> lo) & 0xffu));
  const float b = static_cast<float>(static_cast<int8_t>((w >> (lo + 8)) & 0xffu));
  return static_cast<uint32_t>(to_bits<kF16>(a)) |
         (static_cast<uint32_t>(to_bits<kF16>(b)) << 16);
}

// 16 int8 values at src -> 16 values of the 16-bit type at dst (both in
// shared memory, 16-byte aligned).
template <bool kF16>
__device__ __forceinline__ void i8x16_convert(const uint8_t* src, uint8_t* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  uint4 lo, hi;
  lo.x = i8x2_to_x2<kF16>(w.x, 0);
  lo.y = i8x2_to_x2<kF16>(w.x, 16);
  lo.z = i8x2_to_x2<kF16>(w.y, 0);
  lo.w = i8x2_to_x2<kF16>(w.y, 16);
  hi.x = i8x2_to_x2<kF16>(w.z, 0);
  hi.y = i8x2_to_x2<kF16>(w.z, 16);
  hi.z = i8x2_to_x2<kF16>(w.w, 0);
  hi.w = i8x2_to_x2<kF16>(w.w, 16);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// 16 int8 values at src -> 16 values of the 16-bit type at dst, exact, by
// byte permutes: each byte, biased by 128 (b ^ 0x80), is placed under an
// exponent whose unit is 1 (f32 2^23 + u, rounded in pairs to bf16 by one
// cvt; float16 1024 + u), and the bias is taken off. The same values as
// i8x16_convert in fewer instructions.
template <bool kF16>
__device__ __forceinline__ uint32_t i8x2_exact(uint32_t u, int k) {
  if constexpr (kF16) {
    uint32_t h = __byte_perm(u, 0x64u, k | 0x40 | ((k + 1) << 8) | 0x4000);
    __half2 x = __hsub2(*reinterpret_cast<__half2*>(&h), __floats2half2_rn(1152.f, 1152.f));
    return *reinterpret_cast<uint32_t*>(&x);
  } else {
    const float a = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440 | k)) - 8388736.f;
    const float b = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440 | (k + 1))) - 8388736.f;
    __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&x);
  }
}

template <bool kF16>
__device__ __forceinline__ void i8x16_convert_exact(const uint8_t* src, uint8_t* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
  uint4 lo, hi;
  lo.x = i8x2_exact<kF16>(u[0], 0);
  lo.y = i8x2_exact<kF16>(u[0], 2);
  lo.z = i8x2_exact<kF16>(u[1], 0);
  lo.w = i8x2_exact<kF16>(u[1], 2);
  hi.x = i8x2_exact<kF16>(u[2], 0);
  hi.y = i8x2_exact<kF16>(u[2], 2);
  hi.z = i8x2_exact<kF16>(u[3], 0);
  hi.w = i8x2_exact<kF16>(u[3], 2);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// Two int8 values, byte j (0-3) of a and byte j of b, whose sign bits were
// flipped (w ^ 0x80808080: the byte is v + 128), as a pair of the 16-bit
// type (a's in the low half), exact. bf16: each byte under 2^23 by a byte
// permute, the bias taken off by an FADD (the f32 value's low 16 bits are
// zero, so a permute packs the two bf16 halves); float16: both bytes under
// 1024 by a permute and an AND-OR, the bias taken off by one HSUB2.
template <bool kF16>
__device__ __forceinline__ uint32_t i8_pair(uint32_t a, uint32_t b, int j) {
  if constexpr (kF16) {
    uint32_t h = (__byte_perm(a, b, j | ((j + 4) << 8)) & 0x00ff00ffu) | 0x64006400u;
    __half2 x = __hsub2(*reinterpret_cast<__half2*>(&h), __floats2half2_rn(1152.f, 1152.f));
    return *reinterpret_cast<uint32_t*>(&x);
  } else {
    const float x = __uint_as_float(__byte_perm(a, 0x4B00u, 0x5440 | j)) - 8388736.f;
    const float y = __uint_as_float(__byte_perm(b, 0x4B00u, 0x5440 | j)) - 8388736.f;
    return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
  }
}

// N consecutive int8 bytes at shared address addr (N = 1, 2, 4 or 8,
// aligned to N), sign bits flipped: bytes 0-3 in .x, 4-7 in .y.
template <int N>
__device__ __forceinline__ uint2 lds_i8(uint32_t addr) {
  uint2 w = make_uint2(0u, 0u);
  if constexpr (N == 8) {
    asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(w.x), "=r"(w.y) : "r"(addr));
  } else if constexpr (N == 4) {
    w.x = lds32(addr);
  } else if constexpr (N == 2) {
    uint16_t h;
    asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(h) : "r"(addr));
    w.x = h;
  } else {
    uint16_t h;
    asm volatile("ld.shared.u8 %0, [%1];\n" : "=h"(h) : "r"(addr));
    w.x = h;
  }
  return make_uint2(w.x ^ 0x80808080u, w.y ^ 0x80808080u);
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 w;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(w.x), "=r"(w.y) : "r"(addr));
  return w;
}

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  uint16_t h;
  asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(h) : "r"(addr));
  return h;
}

__device__ __forceinline__ int lds_s8(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a . b on the tensor cores, m16n8k16, the 16-bit type in (kF16:
// float16, else bf16; the fragment layouts are the same), f32 sums.
template <bool kF16>
__device__ __forceinline__ void mma16816_x4(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint32_t b0, uint32_t b1) {
  if constexpr (kF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

// The single-query product. a: rows lane / 4 (a[0], k 2 (lane % 4)..; a[1],
// k + 8) of the 16; rows 8-15, which no query head fills, are zero. b: k 2 (lane % 4).. and k + 8,
// column lane / 4. c: row lane / 4, columns 2 (lane % 4), + 1 (c[2], c[3]:
// rows 8-15).
template <bool kF16>
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t b0,
                                         uint32_t b1) {
  mma16816_x4<kF16>(c, a0, 0u, a1, 0u, b0, b1);
}

// The same product with all 16 rows of A: a[0] rows 0-7 and a[1] rows 8-15
// at k 2 (lane % 4).., a[2] and a[3] the same at k + 8 (ldmatrix.x4's order
// below); c[2], c[3] hold rows 8-15.
template <bool kF16>
__device__ __forceinline__ void mma16816_m16(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  mma16816_x4<kF16>(c, a[0], a[1], a[2], a[3], b0, b1);
}

// Four 8 x 8 16-bit matrices: the A fragment of a 16 x 16 block of a
// row-major tile when lane l gives the address of row l % 16, column 8 (l /
// 16); or, from a row-major (key, dim) tile, the B fragments of two n8 key
// blocks at one 16-dimension step when lane l gives key l % 8 + 8 (l / 16),
// dimension 8 ((l / 8) % 2).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8 x 8 16-bit matrices, transposed: the B fragments of two n8 column
// blocks of a row-major (key, dim) tile; each lane gives one row's address.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two of them: the B fragments of one n8 column block (lanes 0-15 give the
// rows' addresses; the others' are ignored).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Where a slot's live keys lie on its axis of page positions, then tail
// positions: [0, page_limit) for every query, and [tail0, row_end(qi)) for
// query qi; tail_end is the last query's end (the union), and the axis ends
// at end.
struct Live {
  int page_limit, tail0, tail_end, end;
  int tail_q0;    // query 0's tail end, when the slot has a tail
  int tail_max;   // tail0 + tail_len
  bool has_tail;  // lengths > starts: the Pallas kernel's _tail gate

  // Query qi's tail end: its columns j < lengths + qi - starts.
  __device__ __forceinline__ int row_end(int qi) const {
    return has_tail ? min(tail_q0 + qi, tail_max) : tail0;
  }
  // Key v is live for some query (the union: tiles, splits, loads).
  __device__ __forceinline__ bool key(int v) const {
    return v < page_limit || (v >= tail0 && v < tail_end);
  }
  // Key v is live for the query whose tail ends at te.
  __device__ __forceinline__ bool key_row(int v, int te) const {
    return v < page_limit || (v >= tail0 && v < te);
  }
  __device__ __forceinline__ bool tile(int t0) const {
    return t0 < page_limit || max(t0, tail0) < min(t0 + kTile, tail_end);
  }
  // The first tile at or after t0 and before t1 with a live key, or -1.
  __device__ __forceinline__ int next(int t0, int t1) const {
    for (; t0 < t1; t0 += kTile) {
      if (tile(t0)) return t0;
    }
    return -1;
  }
  // Whether split s (of `split` positions) holds a live key.
  __device__ __forceinline__ bool split_live(int s, int split) const {
    return next(s * split, min(s * split + split, end)) >= 0;
  }
};

// Slot b's live keys, from its length (and start: K3) and its p.n_q queries.
template <bool kTail>
__device__ __forceinline__ Live slot_live(const Params& p, int b) {
  const int length = p.lengths[b];
  const int start = kTail ? p.starts[b] : length;
  Live live;
  live.tail0 = p.max_pages * p.page_size;
  // Keys past the table's last page are absent, as in the reference.
  live.page_limit = min(min(start, length), live.tail0);
  live.has_tail = kTail && length > start;
  live.tail_q0 = live.tail0 + (length - start);
  live.tail_max = live.tail0 + (kTail ? p.tail_len : 0);
  live.tail_end = live.row_end(p.n_q - 1);
  live.end = live.tail_max;
  return live;
}

// Page id of page position v (< live.tail0) of slot row trow. Out-of-range
// page ids clamp into the pool, as JAX's gather does.
__device__ __forceinline__ long page_of(const Params& p, const int* trow, int v) {
  return min(max(trow[v / p.page_size], 0), p.n_pool - 1);
}

// K and V of the tile at t0 into stage buffers kb / vb (shared addresses),
// 16 bytes a copy; dead rows arrive as zeros. int8 pools (kI8): a live page
// row's int8 values go to the staging tiles at qb (K, then V kQTile bytes
// on) and its two scales to sb (K, then V 256 bytes on), the page rows'
// bf16 rows being filled by the convert pass after the wait; the scales of
// tail and dead rows arrive as zeros. kInPlace: a live page row's int8
// values go to the last D bytes of its own row in kb / vb instead (qb unused).
// Rows are head_dim wide in device memory; their chunks past head_dim arrive
// as zeros (staged int8 chunks too, which the convert pass widens to zeros).
// kThr > 0: a block of kThr threads (the single-query kernel's loop, kept
// as it was); kThr = 0: a block of nthr threads, any count.
template <int D, bool kI8, bool kInPlace, int kThr = kThreads>
__device__ __forceinline__ void load_tile(const Params& p, const Live& live, int b, int kh,
                                          int t0, uint32_t kb, uint32_t vb, uint32_t qb,
                                          uint32_t sb, int nthr = kThr) {
  using L = Layout<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
  constexpr int kChunksI8 = D / 16;  // of an int8 row
  static_assert(kThr == 0 || kThr == 2 * kTile, "one thread per K or V scale of a tile");
  const int hd = p.head_dim;
  const int* trow = p.table + (long)b * p.max_pages;
  auto copy = [&](int idx) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int v = t0 + r;
    const bool ok = live.key(v);
    if (kI8 && ok && v < live.tail0) {
      if (c < kChunksI8) {
        const bool in = 16 * c < hd;
        const long off = in ? ((page_of(p, trow, v) * p.kv_heads + kh) * p.page_size +
                               v % p.page_size) * hd + 16 * c
                            : 0;
        if constexpr (kInPlace) {
          const uint32_t at = r * L::kLd + L::kInPlaceAt + c * 16;
          cp_async16(kb + at, p.k_i8 + off, in);
          cp_async16(vb + at, p.v_i8 + off, in);
        } else {
          const uint32_t at = r * D + c * 16;
          cp_async16(qb + at, p.k_i8 + off, in);
          cp_async16(qb + L::kQTile + at, p.v_i8 + off, in);
        }
      }
      return;
    }
    // Dead rows and chunks past head_dim read nothing; their address is any
    // valid one.
    const bool in = ok && 8 * c < hd;
    const uint16_t* ks = kI8 ? p.tail_k : p.k_pages;
    const uint16_t* vs = kI8 ? p.tail_v : p.v_pages;
    long off = 0;
    if (in) {
      if (v < live.tail0) {
        off = ((page_of(p, trow, v) * p.kv_heads + kh) * p.page_size + v % p.page_size) * hd +
              8 * c;
      } else {
        ks = p.tail_k;
        vs = p.tail_v;
        off = (((long)b * p.kv_heads + kh) * p.tail_len + (v - live.tail0)) * hd + 8 * c;
      }
    }
    const uint32_t at = r * L::kLd + c * 16;
    cp_async16(kb + at, ks + off, in);
    cp_async16(vb + at, vs + off, in);
  };
  auto scale = [&](int i) {  // i < 64: K's scale of row i; else V's of row i - 64
    const int r = i % kTile;
    const bool is_v = i >= kTile;
    const int v = t0 + r;
    const bool ok = live.key(v) && v < live.tail0;
    const long off = ok ? (page_of(p, trow, v) * p.kv_heads + kh) * p.page_size +
                              v % p.page_size
                        : 0;
    cp_async4(sb + (is_v ? kTile * 4 : 0) + r * 4, (is_v ? p.v_scale : p.k_scale) + off, ok);
  };
  if constexpr (kThr > 0) {
#pragma unroll
    for (int i = 0; i < kTile * kChunks / kThr; ++i) copy(threadIdx.x + i * kThr);
    if (kI8) scale(threadIdx.x);
  } else {
    for (int idx = threadIdx.x; idx < kTile * kChunks; idx += nthr) copy(idx);
    if (kI8) {
      for (int i = threadIdx.x; i < 2 * kTile; i += nthr) scale(i);
    }
  }
  cp_commit();
}

// A page tile of the single-query block over int8 pools (every row below
// tail0: page keys, or dead keys that arrive as zeros) into an int8 stage
// (K at k8, V kTile8 bytes on), a live row's D bytes by 16-byte cp.async,
// chunks past head_dim zero; its K and V scales to sc (V 256 bytes on; 0 on
// dead rows).
template <int D>
__device__ __forceinline__ void load_i8_stage(const Params& p, const Live& live, int b, int kh,
                                              int t0, uint32_t k8, uint32_t sc) {
  using L = SingleI8<D>;
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
    const long off =
        in ? ((page_of(p, trow, v) * p.kv_heads + kh) * p.page_size + v % p.page_size) * hd +
                 16 * c
           : 0;
    cp_async16(k8 + r * L::kLd8 + 16 * c, p.k_i8 + off, in);
    cp_async16(k8 + L::kTile8 + r * L::kLd8 + 16 * c, p.v_i8 + off, in);
  }
  const int r = threadIdx.x % kTile;
  const bool is_v = threadIdx.x >= kTile;
  const int v = t0 + r;
  const bool ok = live.key(v);
  const long off =
      ok ? (page_of(p, trow, v) * p.kv_heads + kh) * p.page_size + v % p.page_size : 0;
  cp_async4(sc + (is_v ? kTile * 4 : 0) + r * 4, (is_v ? p.v_scale : p.k_scale) + off, ok);
  cp_commit();
}

// Merge: one block of D threads per (query row r, KV head kh, slot b); thread
// d writes o[r, d], row r = qi * G + g being query qi's head kh * G + g. The
// partials of every split with a key live for some row (the others wrote
// none and weigh 0; a dead slot's o is 0) are summed in split order: two
// calls give the same bits. A partial whose m is the mask value (a verify
// row with nothing live in that split) weighs 0 too. All m and l come in one
// round trip, then the column's acc values kMergeBatch splits at a time, so
// at the decode tick (17 splits) the merge waits on three loads in a row:
// lengths, m and l, acc. The block has head_dim threads (D is the
// instance's capacity).
template <int D, bool kTail, bool kF16>
__global__ void __launch_bounds__(D) paged_merge_kernel(const Params p) {
  extern __shared__ float sml[];  // m, then l, of each split
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int rows = p.n_q * p.groups, n = p.n_split, hd = p.head_dim;
  const long bk = (long)b * p.kv_heads + kh;
  const Live live = slot_live<kTail>(p, b);
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml) + bk * n * rows + r;
  for (int s = d; s < n; s += hd) {
    const float2 v = live.split_live(s, p.split) ? __ldcg(ml + s * rows)
                                                 : make_float2(kNegInf, 0.f);
    sml[s] = v.x;
    sml[n + s] = v.y;
  }
  __syncthreads();
  float m_max = kNegInf;
  for (int s = 0; s < n; ++s) m_max = fmaxf(m_max, sml[s]);
  // A split's weight exp(m_s - max), 0 for a split without a live key for
  // this row (its m stays the mask value); a weight of 0 skips the split's
  // loads.
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
  p.o[orow * hd + d] = to_bits<kF16>(o);
}

// The single-query form: at most kSingleRows query rows (G <= 8), q in
// registers as rows 0-7 of the m16 A operand; four warps split each tile's
// keys for q.k and its columns for p.V, the softmax one warp a row through
// shared memory. Every call with more rows takes paged_rows_kernel.
//
// Over int8 pools (kI8) a page tile feeds both products from its raw int8
// stage, each fragment widened in registers (no convert pass): q.k's
// contraction is permuted alike in q and K (k16 step s takes, for column
// pair t, dimensions 16 s + 4 t, + 1 as k 2t, 2t + 1 and 16 s + 4 t + 2, + 3
// as k 2t + 8, 2t + 9), so one 4-byte read of a key row is a lane's B
// fragment of a step, and q's A fragment one 8-byte read; p.V's output
// columns are permuted (column n of the warp's n8 block j is dimension w D /
// 4 + kNTiles n + j), so one read of kNTiles bytes of a V row gives a lane
// its column in every block, two keys' bytes paired by a byte permute
// (i8_pair). A tile with tail rows takes one 16-bit tile over both stages
// (tail rows 16-bit, page rows' int8 bytes in place), loaded once the tile
// before it is done; its fragments are read row by row from either.
//
// The least blocks an SM over int8 pools, three (two at D = 256, where three
// would spill), caps its registers at 168 (255); the float instances name
// none, as before.
template <int D, bool kI8>
constexpr int kSingleMinBlocks = !kI8 ? 0 : D == 256 ? 2 : 3;

template <int D, bool kTail, bool kI8, bool kF16>
__global__ void __launch_bounds__(kThreads, kSingleMinBlocks<D, kI8>)
    paged_split_kernel(const Params p) {
  using L = Layout<D>;
  using LI = SingleI8<D>;
  constexpr int kKSteps = D / 16;       // q.k: 16 dimensions a product
  constexpr int kNTiles = D / 8 / kWarps;  // p.V: n8 column blocks a warp
  extern __shared__ __align__(16) uint8_t smem[];
  float* ss = reinterpret_cast<float*>(smem + (kI8 ? LI::kS : L::kS));
  uint16_t* sp = reinterpret_cast<uint16_t*>(smem + (kI8 ? LI::kP : L::kP));
  float* sm = reinterpret_cast<float*>(smem + (kI8 ? LI::kM : L::kM));
  float* sl = reinterpret_cast<float*>(smem + (kI8 ? LI::kL : L::kL));
  float* salpha = reinterpret_cast<float*>(smem + (kI8 ? LI::kAlpha : L::kAlpha));
  const uint32_t base = smem_addr(smem);

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = lane >> 2, quad = lane & 3;  // fragment row (query head) and pair
  const int groups = p.groups, hd = p.head_dim;
  const long row0 = ((long)b * p.kv_heads + kh) * groups;  // q/o row of group 0
  const Live live = slot_live<kTail>(p, b);
  const int v0 = split * p.split, v1 = min(v0 + p.split, live.end);
  int cur = live.next(v0, v1);
  if (cur < 0) return;  // no live key: no partial (the merge weighs this split 0)

  // int8 pools: a page tile (every row below tail0) comes into an int8
  // stage; a tile with tail rows into the 16-bit tile over both stages.
  bool page = kI8 && cur + kTile <= live.tail0;
  if constexpr (kI8) {
    if (page) {
      load_i8_stage<D>(p, live, b, kh, cur, base, base + LI::kSc);
    } else {
      load_tile<D, true, true>(p, live, b, kh, cur, base, base + L::kTileBytes, 0u,
                               base + LI::kSc);
    }
  }
  // q as the A fragments of every 16-dimension step (bf16 as stored; the
  // f32 scale multiplies the f32 sums), rows past the group count and steps
  // past head_dim zero; over int8 pools in the permuted order, one 8-byte
  // read a step.
  uint32_t qa[kKSteps][2];
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(p.q + (row0 + row) * hd);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const bool in = row < groups && 16 * ks < hd;
    if constexpr (kI8) {
      const uint2 w = in ? *reinterpret_cast<const uint2*>(qrow + ks * 8 + 2 * quad)
                         : make_uint2(0u, 0u);
      qa[ks][0] = w.x;
      qa[ks][1] = w.y;
    } else {
      qa[ks][0] = in ? qrow[ks * 8 + quad] : 0u;
      qa[ks][1] = in ? qrow[ks * 8 + 4 + quad] : 0u;
    }
  }
  if (tid < L::kRows) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  float acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if constexpr (!kI8) {
    load_tile<D, kI8, false>(p, live, b, kh, cur, base, base + L::kTileBytes, base + L::kQ,
                             base + L::kSc);
  }
  __syncthreads();  // m and l initialised
  for (int stage = 0; cur >= 0; stage ^= 1) {
    const int nxt = live.next(cur + kTile, v1);
    const uint32_t kb = base + stage * L::kStageBytes, vb = kb + L::kTileBytes;
    // int8 pools: this stage's K and V scales (0 on tail and dead rows)
    const float* sks = reinterpret_cast<const float*>(
        smem + (kI8 ? LI::kSc + stage * LI::kScStage : L::kSc + stage * L::kScStage));
    const float* svs = sks + kTile;
    // int8 pools: the next tile is in flight during this one only if both
    // are page tiles (a tile with tail rows takes both stages).
    bool ahead = false;
    if constexpr (kI8) {
      ahead = page && nxt >= 0 && nxt + kTile <= live.tail0;
      if (ahead) {
        load_i8_stage<D>(p, live, b, kh, nxt, base + (stage ^ 1) * LI::kStage,
                         base + LI::kSc + (stage ^ 1) * LI::kScStage);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    } else if (nxt >= 0) {
      const int ns = stage ^ 1;
      const uint32_t nb = base + ns * L::kStageBytes;
      load_tile<D, kI8, false>(p, live, b, kh, nxt, nb, nb + L::kTileBytes,
                               base + L::kQ + ns * L::kQStage, base + L::kSc + ns * L::kScStage);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the tile's K and V (int8: raw pages and scales) are in shared memory
    // int8 pools: the stage's raw tiles, or the 16-bit tile (K at base, V
    // kTileBytes on) of a tile with tail rows.
    const uint32_t k8 = base + stage * LI::kStage, v8 = k8 + LI::kTile8;
    auto int8_row = [&](int r) { return live.key(cur + r) && cur + r < live.tail0; };

    // Scores of warp w's 16 keys (two n8 blocks), times the scale in f32;
    // keys dead for the row get the finite mask value.
    {
      float c[2][4] = {};
      if constexpr (kI8) {
        if (page) {
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t u =
                  lds32(k8 + (16 * warp + 8 * j + row) * LI::kLd8 + ks * 16 + quad * 4) ^
                  0x80808080u;
              mma16816<kF16>(c[j], qa[ks][0], qa[ks][1], i8x2_exact<kF16>(u, 0),
                             i8x2_exact<kF16>(u, 2));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = 16 * warp + 8 * j + row;
            const uint32_t at = base + r * L::kLd;
            const bool i8 = int8_row(r);
#pragma unroll
            for (int ks = 0; ks < kKSteps; ++ks) {
              uint32_t b0, b1;
              if (i8) {
                const uint32_t u = lds32(at + L::kInPlaceAt + ks * 16 + quad * 4) ^ 0x80808080u;
                b0 = i8x2_exact<kF16>(u, 0);
                b1 = i8x2_exact<kF16>(u, 2);
              } else {
                const uint2 w = lds64(at + (ks * 16 + quad * 4) * 2);
                b0 = w.x;
                b1 = w.y;
              }
              mma16816<kF16>(c[j], qa[ks][0], qa[ks][1], b0, b1);
            }
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t at = kb + (16 * warp + 8 * j + row) * L::kLd + ks * 32 + quad * 4;
            mma16816<kF16>(c[j], qa[ks][0], qa[ks][1], lds32(at), lds32(at + 16));
          }
        }
      }
      if (row < groups) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 16 * warp + 8 * j + 2 * quad;
          float s0 = c[j][0] * p.scale, s1 = c[j][1] * p.scale;
          if (kI8) {  // K's scale on a page key's score
            if (cur + r < live.tail0) s0 *= sks[r];
            if (cur + r + 1 < live.tail0) s1 *= sks[r + 1];
          }
          float2 sc;
          sc.x = live.key(cur + r) ? s0 : kNegInf;
          sc.y = live.key(cur + r + 1) ? s1 : kNegInf;
          *reinterpret_cast<float2*>(ss + row * kTile + r) = sc;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per query row; p to bf16 for the product
    // (int8: p times V's scale; l adds the unscaled p).
    for (int g = warp; g < groups; g += kWarps) {
      const float s0 = ss[g * kTile + lane];
      const float s1 = ss[g * kTile + lane + 32];
      const float m_prev = sm[g];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_next);
      const float p1 = expf(s1 - m_next);
      const float rs = warp_sum(p0 + p1);
      float w0 = p0, w1 = p1;
      if (kI8) {
        if (cur + lane < live.tail0) w0 *= svs[lane];
        if (cur + lane + 32 < live.tail0) w1 *= svs[lane + 32];
      }
      sp[g * kPLd + lane] = to_bits<kF16>(w0);
      sp[g * kPLd + lane + 32] = to_bits<kF16>(w1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        salpha[g] = alpha;
        sl[g] = alpha * sl[g] + rs;
        sm[g] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p.V for warp w's columns (dead keys: p = 0 and V
    // zero-filled).
    {
      const float alpha = row < groups ? salpha[row] : 0.f;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        acc[j][0] *= alpha;
        acc[j][1] *= alpha;
      }
      const uint32_t pa = base + (kI8 ? LI::kP : L::kP) + row * kPLd * 2 + quad * 4;
      // int8 pools: the lane's column of each n8 block (permuted)
      const int col = warp * (D / 4) + kNTiles * row;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        const uint32_t a0 = row < groups ? lds32(pa + ks * 32) : 0u;
        const uint32_t a1 = row < groups ? lds32(pa + ks * 32 + 16) : 0u;
        if constexpr (kI8) {
          // keys 16 ks + 2 quad, + 1 (b0) and + 8, + 9 (b1)
          const int k0 = 16 * ks + 2 * quad;
          if (page) {
            uint2 u[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              u[e] = lds_i8<kNTiles>(v8 + (k0 + (e & 1) + 8 * (e >> 1)) * LI::kLd8 + col);
            }
#pragma unroll
            for (int j = 0; j < kNTiles; ++j) {
              const bool hi = j >= 4;
              mma16816<kF16>(acc[j], a0, a1,
                             i8_pair<kF16>(hi ? u[0].y : u[0].x, hi ? u[1].y : u[1].x, j & 3),
                             i8_pair<kF16>(hi ? u[2].y : u[2].x, hi ? u[3].y : u[3].x, j & 3));
            }
          } else {
            // A tile with tail rows, value by value: a page row's int8 byte
            // (in place) widened, or a tail or dead row's 16-bit value.
            auto v16 = [&](int k, int j) -> uint32_t {
              const uint32_t at = base + L::kTileBytes + k * L::kLd;
              if (int8_row(k)) {
                return to_bits<kF16>(static_cast<float>(lds_s8(at + L::kInPlaceAt + col + j)));
              }
              return lds16(at + (col + j) * 2);
            };
#pragma unroll
            for (int j = 0; j < kNTiles; ++j) {
              mma16816<kF16>(acc[j], a0, a1, v16(k0, j) | (v16(k0 + 1, j) << 16),
                             v16(k0 + 8, j) | (v16(k0 + 9, j) << 16));
            }
          }
        } else {
          // lane l: row (key) 16 ks + 8 ((l / 8) % 2) + l % 8, columns + 8 (l / 16)
          const uint32_t va = vb + (16 * ks + (lane & 15)) * L::kLd +
                              (warp * kNTiles * 8 + 8 * (lane >> 4)) * 2;
#pragma unroll
          for (int j = 0; j < kNTiles; j += 2) {
            uint32_t bf[4];
            if (j + 1 < kNTiles) {
              ldsm_x4_trans(va + j * 16, bf);
              mma16816<kF16>(acc[j], a0, a1, bf[0], bf[1]);
              mma16816<kF16>(acc[j + 1], a0, a1, bf[2], bf[3]);
            } else {  // an odd last column block (D = 32: the warp's only one)
              ldsm_x2_trans(va + j * 16, bf);
              mma16816<kF16>(acc[j], a0, a1, bf[0], bf[1]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage's buffers, the scores and p are free again
    if constexpr (kI8) {
      if (!ahead && nxt >= 0) {  // a tile with tail rows: after this one
        load_tile<D, true, true>(p, live, b, kh, nxt, base, base + L::kTileBytes, 0u,
                                 base + LI::kSc + (stage ^ 1) * LI::kScStage);
      }
      page = ahead;
    }
    cur = nxt;
  }

  // The split's partial: m and l per row, acc (its columns below head_dim).
  // Over int8 pools the lane's acc holds dimensions w D / 4 + 2 quad kNTiles
  // .. + 2 kNTiles - 1 in order (columns 2 quad of its blocks, then 2 quad +
  // 1), a run that head_dim (a multiple of 16) holds whole or not at all.
  const long part = ((long)b * p.kv_heads + kh) * p.n_split + split;
  if (row < groups) {
    if constexpr (kI8) {
      const int col0 = warp * (D / 4) + 2 * quad * kNTiles;
      if (col0 < hd) {
        float run[2 * kNTiles];
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          run[j] = acc[j][0];
          run[kNTiles + j] = acc[j][1];
        }
        float* dst = p.part_acc + (part * groups + row) * hd + col0;
        if constexpr (kNTiles == 1) {
          *reinterpret_cast<float2*>(dst) = make_float2(run[0], run[1]);
        } else {
#pragma unroll
          for (int i = 0; i < 2 * kNTiles; i += 4) {
            *reinterpret_cast<float4*>(dst + i) =
                make_float4(run[i], run[i + 1], run[i + 2], run[i + 3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int col = warp * kNTiles * 8 + 8 * j + 2 * quad;
        if (col < hd) {
          *reinterpret_cast<float2*>(p.part_acc + (part * groups + row) * hd + col) =
              make_float2(acc[j][0], acc[j][1]);
        }
      }
    }
  }
  for (int r = tid; r < groups; r += kThreads) {
    p.part_ml[(part * groups + r) * 2] = sm[r];
    p.part_ml[(part * groups + r) * 2 + 1] = sl[r];
  }
}

// The row-tile form (the verify, and any call with more than kSingleRows
// rows): a block takes nt = p.row_tiles m16 tiles of the KV head's query
// rows r = qi * G + g, one warp each (kKG = 1), or, at one to three tiles,
// kKG warps each that split every key tile between them (see "The
// row-tile kernel" above). blockIdx.y is the KV head, then the row group of
// 16 nt rows.
template <int D, bool kTail, bool kI8, bool kF16, int kKG>
__global__ void __launch_bounds__(RowsBlock<D, kKG>::kThreads) paged_rows_kernel(const Params p) {
  using L = Layout<D>;
  using R = Rows<D>;
  constexpr int kKeys = kTile / kKG;  // keys of a tile a warp takes
  constexpr int kNB = kKeys / 8;      // their n8 score blocks
  constexpr int kKSteps = D / 16;     // q.k: 16 dimensions a product
  constexpr int kNCols = D / 8;       // p.V: every n8 column block
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_addr(smem);

  const int nt = p.row_tiles, nthr = blockDim.x;
  const int split = blockIdx.x, kh = blockIdx.y % p.kv_heads, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, quad = lane & 3;  // fragment row and pair
  const int tile = warp / kKG, k0 = warp % kKG * kKeys;  // the warp's row tile, first key
  const int groups = p.groups, hd = p.head_dim;
  const int all_rows = p.n_q * groups;  // query rows of this KV head
  const int rbase = blockIdx.y / p.kv_heads * 16 * nt;  // the block's first row of them
  const int rows = min(16 * nt, all_rows - rbase);     // and its count
  const bool active = 16 * tile < rows;                // the warp's tile holds a row
  const Live live = slot_live<kTail>(p, b);
  const int v0 = split * p.split, v1 = min(v0 + p.split, live.end);
  int cur = live.next(v0, v1);
  if (cur < 0) return;  // no live key: no partial (the merge weighs this split 0)

  // q's rows into shared memory (committed with the first tile), rows past
  // the block's and chunks past head_dim zero.
  {
    constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
    const long heads = (long)p.kv_heads * groups;
    for (int idx = tid; idx < 16 * nt * kChunks; idx += nthr) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool ok = r < rows && 8 * c < hd;
      const int rr = rbase + r;
      const long qrow = ok ? ((long)b * p.n_q + rr / groups) * heads + (long)kh * groups +
                                 rr % groups
                           : 0;
      cp_async16(base + R::kQRows + r * L::kLd + c * 16, p.q + qrow * hd + 8 * c, ok);
    }
  }
  // The thread's rows g and g + 8 of its tile: their tail ends, running
  // max m and sum l; acc over every column of the two rows.
  int te[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) te[h] = live.row_end((rbase + 16 * tile + g + 8 * h) / groups);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNCols][4];
#pragma unroll
  for (int n = 0; n < kNCols; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // lane l's ldmatrix rows: q row l % 16 of the tile at dimensions + 8 (l /
  // 16); K key l % 8 + 8 (l / 16) of the warp's at + 8 ((l / 8) % 2); V key
  // l % 16 of a 16-key step at columns + 8 (l / 16).
  const uint32_t qa = base + R::kQRows + (16 * tile + (lane & 15)) * L::kLd + (lane >> 4) * 16;
  const int ka = (k0 + (lane & 7) + ((lane >> 4) << 3)) * L::kLd + ((lane >> 3) & 1) * 16;
  const int va = (k0 + (lane & 15)) * L::kLd + (lane >> 4) * 16;

  load_tile<D, kI8, R::kInPlace, 0>(p, live, b, kh, cur, base, base + L::kTileBytes,
                                    base + R::qi8(nt), base + R::sc(nt), nthr);
  for (int stage = 0; cur >= 0; stage ^= 1) {
    const int nxt = live.next(cur + kTile, v1);
    const uint32_t kb = base + stage * L::kStageBytes, vb = kb + L::kTileBytes;
    // int8 pools: this stage's K and V scales (0 on tail and dead rows)
    const float* sks = reinterpret_cast<const float*>(smem + R::sc(nt) + stage * L::kScStage);
    const float* svs = sks + kTile;
    if (nxt >= 0) {
      const int ns = stage ^ 1;
      const uint32_t nb = base + ns * L::kStageBytes;
      load_tile<D, kI8, R::kInPlace, 0>(p, live, b, kh, nxt, nb, nb + L::kTileBytes,
                                        base + R::qi8(nt) + ns * L::kQStage,
                                        base + R::sc(nt) + ns * L::kScStage, nthr);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the tile's K and V (int8: raw pages and scales) are in shared memory
    if constexpr (kI8) {
      // The page rows' int8 values into the 16-bit tiles.
      constexpr int kChunksI8 = D / 16;
      uint8_t* kt = smem + stage * L::kStageBytes;
      if constexpr (R::kInPlace) {
        // Row i % 64 of K (i < 64) or V, its chunks in order: chunk c's 32
        // output bytes end before chunk c + 1's 16 input bytes begin (32 (c
        // + 1) <= kInPlaceAt + 16 (c + 1) for c < D / 16).
        for (int i = tid; i < 2 * kTile; i += nthr) {
          const int r = i % kTile;
          const int v = cur + r;
          if (live.key(v) && v < live.tail0) {
            uint8_t* row = kt + (i / kTile) * L::kTileBytes + r * L::kLd;
            for (int c = 0; c < kChunksI8; ++c) {
              i8x16_convert_exact<kF16>(row + L::kInPlaceAt + c * 16, row + c * 32);
            }
          }
        }
      } else {
        const uint8_t* qk = smem + R::qi8(nt) + stage * L::kQStage;
        for (int idx = tid; idx < kTile * kChunksI8; idx += nthr) {
          const int r = idx / kChunksI8, c = idx % kChunksI8;
          const int v = cur + r;
          if (live.key(v) && v < live.tail0) {
            i8x16_convert_exact<kF16>(qk + r * D + c * 16, kt + r * L::kLd + c * 32);
            i8x16_convert_exact<kF16>(qk + L::kQTile + r * D + c * 16,
                                kt + L::kTileBytes + r * L::kLd + c * 32);
          }
        }
      }
      __syncthreads();
    }

    if (active) {
      // q.k of the tile's 16 rows and the warp's kKeys keys, in registers.
      float s[kNB][4];
#pragma unroll
      for (int j = 0; j < kNB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        uint32_t a[4];
        ldsm_x4(qa + ks * 32, a);
#pragma unroll
        for (int j = 0; j < kNB; j += 2) {
          uint32_t bk[4];
          ldsm_x4(kb + ka + j * 8 * L::kLd + ks * 32, bk);
          mma16816_m16<kF16>(s[j], a, bk[0], bk[1]);
          mma16816_m16<kF16>(s[j + 1], a, bk[2], bk[3]);
        }
      }
      // Scores times the scale in f32 (int8: times K's scale on a page
      // key); keys dead for the row get the finite mask value (none on a
      // tile of page keys every row sees whole). Then the online softmax
      // of rows g and g + 8, their max and sum over the quad's four lanes.
      const bool whole = cur + kTile <= live.page_limit;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + 8 * j + 2 * quad + (e & 1);
          float x = s[j][e] * p.scale;
          if (whole) {
            if (kI8) x *= sks[k];
          } else {
            if (kI8 && cur + k < live.tail0) x *= sks[k];
            x = live.key_row(cur + k, te[e >> 1]) ? x : kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_next = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_next);
        m[h] = m_next;
      }
      // p, rounded to the 16-bit type for p.V (int8: p times V's scale on a
      // page key), packed as the A fragments of the 16-key steps: the
      // m16n8k16 sums of n8 blocks 2i and 2i + 1 are step i's A fragment.
      uint32_t pa[kNB][2];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int k = k0 + 8 * j + 2 * quad;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = expf(s[j][2 * h] - m[h]);
          const float p1 = expf(s[j][2 * h + 1] - m[h]);
          rs[h] += p0 + p1;
          float w0 = p0, w1 = p1;
          if (kI8) {
            if (cur + k < live.tail0) w0 *= svs[k];
            if (cur + k + 1 < live.tail0) w1 *= svs[k + 1];
          }
          pa[j][h] = pack2<kF16>(w0, w1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[h] = alpha[h] * l[h] + rs[h];
      }
#pragma unroll
      for (int n = 0; n < kNCols; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // acc += p.V over every column (dead keys: p = 0 and V zero-filled;
      // columns past head_dim are zeros, never stored), V's fragments by
      // ldmatrix.trans. Guarding the columns or q.k's steps by head_dim
      // measured slower at every shape, head_dim 96 included.
#pragma unroll
      for (int i = 0; i < kNB / 2; ++i) {
        const uint32_t a[4] = {pa[2 * i][0], pa[2 * i][1], pa[2 * i + 1][0], pa[2 * i + 1][1]};
#pragma unroll
        for (int n = 0; n < kNCols; n += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(vb + va + 16 * i * L::kLd + n * 16, bv);
          mma16816_m16<kF16>(acc[n], a, bv[0], bv[1]);
          mma16816_m16<kF16>(acc[n + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage's buffers are free again
    cur = nxt;
  }

  // The split's partial, m and l per row and acc (its columns below
  // head_dim), in the workspace rows of the block's row group.
  const long part = ((long)b * p.kv_heads + kh) * p.n_split + split;
  float* pacc = p.part_acc + (part * all_rows + rbase) * hd;
  float* pml = p.part_ml + (part * all_rows + rbase) * 2;
  const int kw = warp % kKG;  // the warp's key part
  if constexpr (kKG > 1) {
    // The kKG warps of a row tile hold the same rows over disjoint keys: the
    // others hand their m, l and acc to the tile's first warp through shared
    // memory (the stages are free), which combines them in key order, each
    // part weighted exp(m_w - max m_w) (0 where m_w is the mask value:
    // nothing live for the row in the warp's keys).
    float* cacc = reinterpret_cast<float*>(smem);  // [warp][16][D]
    float* cml = cacc + nt * kKG * 16 * D;         // [warp][16]: m, l
    if (kw > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = warp * 16 + g + 8 * h;
#pragma unroll
        for (int n = 0; n < kNCols; ++n) {
          *reinterpret_cast<float2*>(cacc + i * D + 8 * n + 2 * quad) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        }
        if (quad == 0) *reinterpret_cast<float2*>(cml + 2 * i) = make_float2(m[h], l[h]);
      }
    }
    __syncthreads();
    if (kw == 0 && active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = warp * 16 + g + 8 * h;
        float mw[kKG], lw[kKG], wt[kKG];
        mw[0] = m[h];
        lw[0] = l[h];
        float mm = m[h];
#pragma unroll
        for (int w = 1; w < kKG; ++w) {
          const float2 v = *reinterpret_cast<const float2*>(cml + 2 * (i + 16 * w));
          mw[w] = v.x;
          lw[w] = v.y;
          mm = fmaxf(mm, v.x);
        }
        float ll = 0.f;
#pragma unroll
        for (int w = 0; w < kKG; ++w) {
          wt[w] = mw[w] == kNegInf ? 0.f : expf(mw[w] - mm);
          ll += wt[w] * lw[w];
        }
        m[h] = mm;
        l[h] = ll;
#pragma unroll
        for (int n = 0; n < kNCols; ++n) {
          float o0 = wt[0] * acc[n][2 * h], o1 = wt[0] * acc[n][2 * h + 1];
#pragma unroll
          for (int w = 1; w < kKG; ++w) {
            const float2 a = *reinterpret_cast<const float2*>(cacc + (i + 16 * w) * D + 8 * n +
                                                              2 * quad);
            o0 += wt[w] * a.x;
            o1 += wt[w] * a.y;
          }
          acc[n][2 * h] = o0;
          acc[n][2 * h + 1] = o1;
        }
      }
    }
  }
  if (kw == 0 && active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * tile + g + 8 * h;
      if (r < rows) {
#pragma unroll
        for (int n = 0; n < kNCols; ++n) {
          const int col = 8 * n + 2 * quad;
          if (col < hd) {
            *reinterpret_cast<float2*>(pacc + r * hd + col) =
                make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
          }
        }
        if (quad == 0) *reinterpret_cast<float2*>(pml + 2 * r) = make_float2(m[h], l[h]);
      }
    }
  }
}

// The merge of every form: one block of head_dim threads per (query row,
// KV head, slot).
template <int D, bool kTail, bool kF16>
int launch_merge(const Params& p, int batch, cudaStream_t stream) {
  paged_merge_kernel<D, kTail, kF16><<<dim3(p.n_q * p.groups, p.kv_heads, batch), p.head_dim,
                                       2 * static_cast<size_t>(p.n_split) * 4, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kTail, bool kI8, bool kF16>
int launch_single(const Params& p, int batch, cudaStream_t stream) {
  static bool prepared = false;
  constexpr int kSmem = kI8 ? SingleI8<D>::kBytes : Layout<D>::kBytes;
  auto kernel = paged_split_kernel<D, kTail, kI8, kF16>;
  if (!prepared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    prepared = true;
  }
  kernel<<<dim3(p.n_split, p.kv_heads, batch), kThreads, kSmem, stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return launch_merge<D, kTail, kF16>(p, batch, stream);
}

template <int D, bool kTail, bool kI8, bool kF16, int kKG>
int launch_rows_kg(Params p, int batch, int nt, int row_groups, cudaStream_t stream) {
  static bool prepared = false;
  auto kernel = paged_rows_kernel<D, kTail, kI8, kF16, kKG>;
  if (!prepared) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Rows<D>::bytes(RowsBlock<D, kKG>::kTiles, kI8));
    if (err != cudaSuccess) return static_cast<int>(err);
    prepared = true;
  }
  p.row_tiles = nt;
  kernel<<<dim3(p.n_split, p.kv_heads * row_groups, batch), 32 * kKG * nt,
           Rows<D>::bytes(nt, kI8), stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return launch_merge<D, kTail, kF16>(p, batch, stream);
}

// The row-tile form: the KV head's Q * G rows in m16 tiles, at most
// Rows<D>::kMaxTiles a block (past that, row groups of as even a size as
// the tiles allow, side by side); one tile takes four warps over each key
// tile, two or three tiles two warps each, more one warp each.
template <int D, bool kTail, bool kI8, bool kF16>
int launch_rows(const Params& p, int batch, cudaStream_t stream) {
  const int tiles = (p.n_q * p.groups + 15) / 16;
  const int row_groups = (tiles + Rows<D>::kMaxTiles - 1) / Rows<D>::kMaxTiles;
  const int nt = (tiles + row_groups - 1) / row_groups;
  if (nt == 1) return launch_rows_kg<D, kTail, kI8, kF16, 4>(p, batch, nt, row_groups, stream);
  if (nt < 4) return launch_rows_kg<D, kTail, kI8, kF16, 2>(p, batch, nt, row_groups, stream);
  return launch_rows_kg<D, kTail, kI8, kF16, 1>(p, batch, nt, row_groups, stream);
}

template <int D, bool kTail, bool kI8, bool kF16>
int launch(const Params& p, int batch, cudaStream_t stream, bool single) {
  return single ? launch_single<D, kTail, kI8, kF16>(p, batch, stream)
                : launch_rows<D, kTail, kI8, kF16>(p, batch, stream);
}

template <bool kTail, bool kI8, bool kF16>
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
  // The single-query form for at most kSingleRows rows; else the row-tile
  // form.
  const bool single = !verify && n_q * p.groups <= kSingleRows;
  const long keys = (long)p.max_pages * p.page_size + (kTail ? p.tail_len : 0);
  const long n_split = (keys + p.split - 1) / p.split;
  if (n_split > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  p.n_split = static_cast<int>(n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The smallest instance that holds head_dim.
  if (head_dim <= 32) return launch<32, kTail, kI8, kF16>(p, batch, s, single);
  if (head_dim <= 64) return launch<64, kTail, kI8, kF16>(p, batch, s, single);
  if (head_dim <= 128) return launch<128, kTail, kI8, kF16>(p, batch, s, single);
  return launch<256, kTail, kI8, kF16>(p, batch, s, single);
}

Params tail_params(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale, const void* table,
                   const void* lengths, const void* starts, const void* tail_k,
                   const void* tail_v, void* o, void* part_acc, void* part_ml, int kv_heads,
                   int page_size, int max_pages, int n_pool, int tail_len, int split,
                   float scale, bool i8) {
  Params p{static_cast<const uint16_t*>(q), nullptr, nullptr, static_cast<const int*>(table),
           static_cast<const int*>(lengths), static_cast<const int*>(starts),
           static_cast<const uint16_t*>(tail_k), static_cast<const uint16_t*>(tail_v),
           static_cast<uint16_t*>(o), static_cast<float*>(part_acc),
           static_cast<float*>(part_ml), kv_heads, 0, page_size, max_pages, n_pool,
           tail_len, split, 0, scale};
  if (i8) {
    p.k_i8 = static_cast<const int8_t*>(k_pages);
    p.v_i8 = static_cast<const int8_t*>(v_pages);
    p.k_scale = static_cast<const float*>(k_scale);
    p.v_scale = static_cast<const float*>(v_scale);
  } else {
    p.k_pages = static_cast<const uint16_t*>(k_pages);
    p.v_pages = static_cast<const uint16_t*>(v_pages);
  }
  return p;
}

// K3 and its verify (n_q > 1 with verify), over float (kI8 false: k_scale
// and v_scale unused) or int8 pools, on the 16-bit type of kF16.
template <bool kI8, bool kF16>
int tail_entry(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
               const void* v_scale, const void* table, const void* lengths, const void* starts,
               const void* tail_k, const void* tail_v, void* o, void* part_acc, void* part_ml,
               int batch, int n_q, bool verify, int heads, int kv_heads, int head_dim,
               int page_size, int max_pages, int n_pool, int tail_len, int split, float scale,
               void* stream) {
  const Params p = tail_params(q, k_pages, v_pages, k_scale, v_scale, table, lengths, starts,
                               tail_k, tail_v, o, part_acc, part_ml, kv_heads, page_size,
                               max_pages, n_pool, tail_len, split, scale, kI8);
  return dispatch<true, kI8, kF16>(p, batch, n_q, verify, heads, head_dim, stream);
}

// K4 on the 16-bit type of kF16.
template <bool kF16>
int no_tail_entry(const void* q, const void* k_pages, const void* v_pages, const void* table,
                  const void* lengths, void* o, void* part_acc, void* part_ml, int batch,
                  int heads, int kv_heads, int head_dim, int page_size, int max_pages,
                  int n_pool, int split, float scale, void* stream) {
  const Params p{static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k_pages),
                 static_cast<const uint16_t*>(v_pages), static_cast<const int*>(table),
                 static_cast<const int*>(lengths), nullptr, nullptr, nullptr,
                 static_cast<uint16_t*>(o), static_cast<float*>(part_acc),
                 static_cast<float*>(part_ml), kv_heads, 0, page_size, max_pages, n_pool, 0,
                 split, 0, scale};
  return dispatch<false, false, kF16>(p, batch, 1, false, heads, head_dim, stream);
}

}  // namespace

// K3. q (B, H, D); pools (P, K, ps, D) with P = n_pool; table (B, maxp)
// int32; lengths and starts (B,) int32; tails (B, K, T, D); o (B, H, D), with
// D = head_dim a multiple of 16 up to 256 and any H / K. bf16
// tensors, all contiguous. Workspace: part_acc f32 (B, K, n_split, H / K, D)
// and part_ml f32 (B, K, n_split, H / K, 2) with n_split = ceil((maxp * ps +
// T) / split), split a multiple of 64. Returns cudaGetLastError() after the
// two launches (0 = launched).
extern "C" int ditl_paged_tail_bf16(const void* q, const void* k_pages, const void* v_pages,
                                    const void* table, const void* lengths, const void* starts,
                                    const void* tail_k, const void* tail_v, void* o,
                                    void* part_acc, void* part_ml, int batch, int heads,
                                    int kv_heads, int head_dim, int page_size, int max_pages,
                                    int n_pool, int tail_len, int split, float scale,
                                    void* stream) {
  return tail_entry<false, false>(q, k_pages, v_pages, nullptr, nullptr, table, lengths, starts,
                                  tail_k, tail_v, o, part_acc, part_ml, batch, 1, false, heads,
                                  kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                  split, scale, stream);
}

// K3 over int8 pools: as ditl_paged_tail_bf16, with int8 pools (P, K, ps, D)
// and their f32 scales k_scale, v_scale (P, K, 1, ps); q and the tails bf16.
extern "C" int ditl_paged_tail_i8(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale, const void* table,
                                  const void* lengths, const void* starts, const void* tail_k,
                                  const void* tail_v, void* o, void* part_acc, void* part_ml,
                                  int batch, int heads, int kv_heads, int head_dim,
                                  int page_size, int max_pages, int n_pool, int tail_len,
                                  int split, float scale, void* stream) {
  return tail_entry<true, false>(q, k_pages, v_pages, k_scale, v_scale, table, lengths, starts,
                                 tail_k, tail_v, o, part_acc, part_ml, batch, 1, false, heads,
                                 kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                 split, scale, stream);
}

// K3's multi-query verify: as ditl_paged_tail_bf16 with q and o (B, Q, H, D),
// n_q = Q, and the workspace's H / K rows replaced by R = Q * H / K (any count:
// row groups side by side past a block's row tiles).
extern "C" int ditl_paged_verify_bf16(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* lengths,
                                      const void* starts, const void* tail_k,
                                      const void* tail_v, void* o, void* part_acc,
                                      void* part_ml, int batch, int n_q, int heads,
                                      int kv_heads, int head_dim, int page_size,
                                      int max_pages, int n_pool, int tail_len, int split,
                                      float scale, void* stream) {
  return tail_entry<false, false>(q, k_pages, v_pages, nullptr, nullptr, table, lengths, starts,
                                  tail_k, tail_v, o, part_acc, part_ml, batch, n_q, true, heads,
                                  kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                  split, scale, stream);
}

// The verify over int8 pools: ditl_paged_verify_bf16's shapes with
// ditl_paged_tail_i8's pools and scales.
extern "C" int ditl_paged_verify_i8(const void* q, const void* k_pages, const void* v_pages,
                                    const void* k_scale, const void* v_scale,
                                    const void* table, const void* lengths,
                                    const void* starts, const void* tail_k,
                                    const void* tail_v, void* o, void* part_acc,
                                    void* part_ml, int batch, int n_q, int heads,
                                    int kv_heads, int head_dim, int page_size, int max_pages,
                                    int n_pool, int tail_len, int split, float scale,
                                    void* stream) {
  return tail_entry<true, false>(q, k_pages, v_pages, k_scale, v_scale, table, lengths, starts,
                                 tail_k, tail_v, o, part_acc, part_ml, batch, n_q, true, heads,
                                 kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                 split, scale, stream);
}

// K4: the same without a tail; pages up to lengths; n_split = ceil(maxp * ps
// / split).
extern "C" int ditl_paged_bf16(const void* q, const void* k_pages, const void* v_pages,
                               const void* table, const void* lengths, void* o, void* part_acc,
                               void* part_ml, int batch, int heads, int kv_heads, int head_dim,
                               int page_size, int max_pages, int n_pool, int split, float scale,
                               void* stream) {
  return no_tail_entry<false>(q, k_pages, v_pages, table, lengths, o, part_acc, part_ml, batch,
                              heads, kv_heads, head_dim, page_size, max_pages, n_pool, split,
                              scale, stream);
}

// The float16 instances: each takes its bf16 twin's arguments, with q, o,
// the tails and the float pools float16 (int8 pools and f32 scales as
// before).
extern "C" int ditl_paged_tail_f16(const void* q, const void* k_pages, const void* v_pages,
                                   const void* table, const void* lengths, const void* starts,
                                   const void* tail_k, const void* tail_v, void* o,
                                   void* part_acc, void* part_ml, int batch, int heads,
                                   int kv_heads, int head_dim, int page_size, int max_pages,
                                   int n_pool, int tail_len, int split, float scale,
                                   void* stream) {
  return tail_entry<false, true>(q, k_pages, v_pages, nullptr, nullptr, table, lengths, starts,
                                 tail_k, tail_v, o, part_acc, part_ml, batch, 1, false, heads,
                                 kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                 split, scale, stream);
}

extern "C" int ditl_paged_tail_i8_f16(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scale, const void* v_scale,
                                      const void* table, const void* lengths,
                                      const void* starts, const void* tail_k,
                                      const void* tail_v, void* o, void* part_acc,
                                      void* part_ml, int batch, int heads, int kv_heads,
                                      int head_dim, int page_size, int max_pages, int n_pool,
                                      int tail_len, int split, float scale, void* stream) {
  return tail_entry<true, true>(q, k_pages, v_pages, k_scale, v_scale, table, lengths, starts,
                                tail_k, tail_v, o, part_acc, part_ml, batch, 1, false, heads,
                                kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                split, scale, stream);
}

extern "C" int ditl_paged_verify_f16(const void* q, const void* k_pages, const void* v_pages,
                                     const void* table, const void* lengths,
                                     const void* starts, const void* tail_k,
                                     const void* tail_v, void* o, void* part_acc,
                                     void* part_ml, int batch, int n_q, int heads,
                                     int kv_heads, int head_dim, int page_size, int max_pages,
                                     int n_pool, int tail_len, int split, float scale,
                                     void* stream) {
  return tail_entry<false, true>(q, k_pages, v_pages, nullptr, nullptr, table, lengths, starts,
                                 tail_k, tail_v, o, part_acc, part_ml, batch, n_q, true, heads,
                                 kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                 split, scale, stream);
}

extern "C" int ditl_paged_verify_i8_f16(const void* q, const void* k_pages,
                                        const void* v_pages, const void* k_scale,
                                        const void* v_scale, const void* table,
                                        const void* lengths, const void* starts,
                                        const void* tail_k, const void* tail_v, void* o,
                                        void* part_acc, void* part_ml, int batch, int n_q,
                                        int heads, int kv_heads, int head_dim, int page_size,
                                        int max_pages, int n_pool, int tail_len, int split,
                                        float scale, void* stream) {
  return tail_entry<true, true>(q, k_pages, v_pages, k_scale, v_scale, table, lengths, starts,
                                tail_k, tail_v, o, part_acc, part_ml, batch, n_q, true, heads,
                                kv_heads, head_dim, page_size, max_pages, n_pool, tail_len,
                                split, scale, stream);
}

extern "C" int ditl_paged_f16(const void* q, const void* k_pages, const void* v_pages,
                              const void* table, const void* lengths, void* o, void* part_acc,
                              void* part_ml, int batch, int heads, int kv_heads, int head_dim,
                              int page_size, int max_pages, int n_pool, int split, float scale,
                              void* stream) {
  return no_tail_entry<true>(q, k_pages, v_pages, table, lengths, o, part_acc, part_ml, batch,
                             heads, kv_heads, head_dim, page_size, max_pages, n_pool, split,
                             scale, stream);
}
