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
// pools: _paged_tail_kernel with quantized=True) and ditl_paged_bf16 (K4).
// All are instances of one template, for head_dim 64 and 128, in
// single-query form (the multi-query verify is not here).
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
//   (ops/paged_attention.py SPLIT_KEYS, a multiple of the 64-key tile), so
//   the grid is sized from shapes the host knows, never from lengths or
//   starts: the wrapper reads nothing back from the card, and a decode step
//   can be captured in a CUDA graph. A block whose split holds no live key
//   stops at once and writes nothing; the merge, applying the same rule to
//   the same lengths, gives that split no weight.
// - Inside a split, one 128-thread block walks its live 64-key tiles
//   (skipping tiles with no live column) with the next tile's K and V in
//   flight by cp.async while the current one is computed (two stages, 34 KB
//   each at D = 128, rows padded by 16 bytes, dead rows zero-filled by the
//   copy itself).
// - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   sums), the G = H / K query rows of a KV head (at most 8) as rows 0-7 of
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
// TB/s, half the float kernel's bytes. The design is the float kernel's with
// a staging step, the simplest that keeps its tensor-core path: a page row's
// D int8 bytes come by cp.async (16 values a copy) into a raw int8 tile, and
// the row's two scales by 4-byte cp.async into a scale tile, both double
// buffered beside the bf16 tiles; tail rows and dead rows go to the bf16
// tile as before. After the wait, one pass converts the page rows to bf16
// into the bf16 tile (int8 -> bf16 is exact: |q| <= 127), so the q.k and
// p.V products and their ldmatrix/mma.sync fragments are unchanged. K's
// scale multiplies each page key's f32 score (times the softmax scale)
// before the running max; V's scale multiplies p, before p's rounding to
// bf16 for the p.V product, while the row sum l adds the unscaled p, so acc
// / l is the reference's sum of (p * vs) . v over sum of p. Tail keys take
// scale 1. Converting in registers on the way to the products, TMA and
// wgmma are later work.
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // keys per tile; two per lane in the softmax
constexpr int kMaxGroups = 8;  // query heads per KV head
constexpr int kPLd = kTile + 8;  // bf16 p row, padded: 144 bytes
constexpr int kMergeBatch = 32;  // merge: splits whose acc values are loaded at once
constexpr int kMaxSplits = 6144;  // the merge's m and l: 48 KB of shared memory
constexpr float kNegInf = -2.3819763e38f;  // ops/attention.py NEG_INF

struct Params {
  const uint16_t* q;        // (B, H, D)
  const uint16_t* k_pages;  // (P, K, ps, D), float pools
  const uint16_t* v_pages;
  const int* table;         // (B, max_pages)
  const int* lengths;       // (B,)
  const int* starts;        // (B,), K3 only
  const uint16_t* tail_k;   // (B, K, T, D), K3 only
  const uint16_t* tail_v;
  uint16_t* o;              // (B, H, D)
  float* part_acc;          // (B, K, n_split, G, D)
  float* part_ml;           // (B, K, n_split, G, 2): m, l
  int kv_heads, groups, page_size, max_pages, n_pool, tail_len, split, n_split;
  float scale;
  const int8_t* k_i8;       // (P, K, ps, D), int8 pools (ditl_paged_tail_i8)
  const int8_t* v_i8;
  const float* k_scale;     // (P, K, 1, ps)
  const float* v_scale;
};

// Shared memory of a split block: two stages of (K, V) tiles with rows
// padded by 16 bytes (so that 8 rows at one column reach 32 banks), then the
// f32 scores, the bf16 p rows, m, l and alpha.
template <int D>
struct Layout {
  static constexpr int kLd = D * 2 + 16;  // bytes of one padded key row
  static constexpr int kTileBytes = kTile * kLd;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kS = 2 * kStageBytes;
  static constexpr int kP = kS + kMaxGroups * kTile * 4;
  static constexpr int kM = kP + kMaxGroups * kPLd * 2;
  static constexpr int kL = kM + kMaxGroups * 4;
  static constexpr int kAlpha = kL + kMaxGroups * 4;
  static constexpr int kBytes = kAlpha + kMaxGroups * 4;
  // int8 pools: two stages of raw int8 K and V tiles (D bytes a key), then
  // two stages of the tile's 64 K and 64 V scales.
  static constexpr int kQTile = kTile * D;
  static constexpr int kQStage = 2 * kQTile;
  static constexpr int kQ = kBytes;
  static constexpr int kScStage = 2 * kTile * 4;
  static constexpr int kSc = kQ + 2 * kQStage;
  static constexpr int kBytesI8 = kSc + 2 * kScStage;
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

// Two int8 values (bits lo..lo+15 of w) as a bf16 pair; exact.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, int lo) {
  const float a = static_cast<float>(static_cast<int8_t>((w >> lo) & 0xffu));
  const float b = static_cast<float>(static_cast<int8_t>((w >> (lo + 8)) & 0xffu));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

// 16 int8 values at src -> 16 bf16 values at dst (both in shared memory,
// 16-byte aligned).
__device__ __forceinline__ void i8x16_to_bf16(const uint8_t* src, uint8_t* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  uint4 lo, hi;
  lo.x = i8x2_bf16x2(w.x, 0);
  lo.y = i8x2_bf16x2(w.x, 16);
  lo.z = i8x2_bf16x2(w.y, 0);
  lo.w = i8x2_bf16x2(w.y, 16);
  hi.x = i8x2_bf16x2(w.z, 0);
  hi.y = i8x2_bf16x2(w.z, 16);
  hi.z = i8x2_bf16x2(w.w, 0);
  hi.w = i8x2_bf16x2(w.w, 16);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a . b on the tensor cores, m16n8k16, bf16 in, f32 sums. a: rows
// lane / 4 (a[0], k 2 (lane % 4)..; a[1], k + 8) of the 16; rows 8-15, which
// no query head fills, are zero. b: k 2 (lane % 4).. and k + 8, column lane /
// 4. c: row lane / 4, columns 2 (lane % 4), + 1 (c[2], c[3]: rows 8-15).
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a1), "r"(0u), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: the B fragments of two n8 column
// blocks of a row-major (key, dim) tile; each lane gives one row's address.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Where a slot's live keys lie on its axis of page positions, then tail
// positions: [0, page_limit) and [tail0, tail_end); the axis ends at end.
struct Live {
  int page_limit, tail0, tail_end, end;

  __device__ __forceinline__ bool key(int v) const {
    return v < page_limit || (v >= tail0 && v < tail_end);
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

// Slot b's live keys, from its length (and start: K3).
template <bool kTail>
__device__ __forceinline__ Live slot_live(const Params& p, int b) {
  const int length = p.lengths[b];
  const int start = kTail ? p.starts[b] : length;
  Live live;
  live.tail0 = p.max_pages * p.page_size;
  // Keys past the table's last page are absent, as in the reference.
  live.page_limit = min(min(start, length), live.tail0);
  live.tail_end = live.tail0 + (kTail ? max(0, min(length, start + p.tail_len) - start) : 0);
  live.end = live.tail0 + (kTail ? p.tail_len : 0);
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
// tail and dead rows arrive as zeros.
template <int D, bool kI8>
__device__ __forceinline__ void load_tile(const Params& p, const Live& live, int b, int kh,
                                          int t0, uint32_t kb, uint32_t vb, uint32_t qb,
                                          uint32_t sb) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
  constexpr int kChunksI8 = D / 16;  // of an int8 row
  static_assert(kThreads == 2 * kTile, "one thread per K or V scale of a tile");
  const int* trow = p.table + (long)b * p.max_pages;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int v = t0 + r;
    const bool ok = live.key(v);
    if (kI8 && ok && v < live.tail0) {
      if (c < kChunksI8) {
        const long off = ((page_of(p, trow, v) * p.kv_heads + kh) * p.page_size +
                          v % p.page_size) * D + 16 * c;
        const uint32_t at = r * D + c * 16;
        cp_async16(qb + at, p.k_i8 + off, true);
        cp_async16(qb + Layout<D>::kQTile + at, p.v_i8 + off, true);
      }
      continue;
    }
    // Dead rows read nothing; their address is any valid one.
    const uint16_t* ks = kI8 ? p.tail_k : p.k_pages;
    const uint16_t* vs = kI8 ? p.tail_v : p.v_pages;
    long off = 0;
    if (ok) {
      if (v < live.tail0) {
        off = ((page_of(p, trow, v) * p.kv_heads + kh) * p.page_size + v % p.page_size) * D;
      } else {
        ks = p.tail_k;
        vs = p.tail_v;
        off = (((long)b * p.kv_heads + kh) * p.tail_len + (v - live.tail0)) * D;
      }
    }
    const uint32_t at = r * Layout<D>::kLd + c * 16;
    cp_async16(kb + at, ks + off + 8 * c, ok);
    cp_async16(vb + at, vs + off + 8 * c, ok);
  }
  if (kI8) {
    const int r = threadIdx.x % kTile;
    const bool is_v = threadIdx.x >= kTile;
    const int v = t0 + r;
    const bool ok = live.key(v) && v < live.tail0;
    const long off = ok ? (page_of(p, trow, v) * p.kv_heads + kh) * p.page_size +
                              v % p.page_size
                        : 0;
    cp_async4(sb + (is_v ? kTile * 4 : 0) + r * 4, (is_v ? p.v_scale : p.k_scale) + off, ok);
  }
  cp_commit();
}

// Merge: one block of D threads per (query row g, KV head kh, slot b); thread
// d writes o[g, d]. The partials of every split with a live key (the others
// wrote none and weigh 0; a dead slot's o is 0) are summed in split order:
// two calls give the same bits. All m and l come in one round trip, then the
// column's acc values kMergeBatch splits at a time, so at the decode tick
// (17 splits) the merge waits on three loads in a row: lengths, m and l,
// acc.
template <int D, bool kTail>
__global__ void __launch_bounds__(D) paged_merge_kernel(const Params p) {
  extern __shared__ float sml[];  // m, then l, of each split
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int groups = p.groups, n = p.n_split;
  const long bk = (long)b * p.kv_heads + kh;
  const Live live = slot_live<kTail>(p, b);
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml) + bk * n * groups + g;
  for (int s = d; s < n; s += D) {
    const float2 v = live.split_live(s, p.split) ? __ldcg(ml + s * groups)
                                                 : make_float2(kNegInf, 0.f);
    sml[s] = v.x;
    sml[n + s] = v.y;
  }
  __syncthreads();
  float m_max = kNegInf;
  for (int s = 0; s < n; ++s) m_max = fmaxf(m_max, sml[s]);
  // A split's weight exp(m_s - max), 0 for a split without a live key (its m
  // stays the mask value); a weight of 0 skips the split's loads.
  auto weight = [&](int s) { return sml[s] == kNegInf ? 0.f : expf(sml[s] - m_max); };
  float l = 0.f;
  for (int s = 0; s < n; ++s) l += weight(s) * sml[n + s];
  const float* acc = p.part_acc + (bk * n * groups + g) * D + d;
  float o = 0.f;
  for (int s0 = 0; s0 < n; s0 += kMergeBatch) {
    float av[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int s = s0 + j;
      av[j] = s < n && sml[s] != kNegInf ? __ldcg(acc + (long)s * groups * D) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      if (s0 + j < n) o += weight(s0 + j) * av[j];
    }
  }
  o /= (l == 0.f ? 1.f : l);
  p.o[(bk * groups + g) * D + d] = __bfloat16_as_ushort(__float2bfloat16_rn(o));
}

template <int D, bool kTail, bool kI8>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int kKSteps = D / 16;       // q.k: 16 dimensions a product
  constexpr int kNTiles = D / 8 / kWarps;  // p.V: n8 column blocks a warp
  extern __shared__ __align__(16) uint8_t smem[];
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  uint16_t* sp = reinterpret_cast<uint16_t*>(smem + L::kP);
  float* sm = reinterpret_cast<float*>(smem + L::kM);
  float* sl = reinterpret_cast<float*>(smem + L::kL);
  float* salpha = reinterpret_cast<float*>(smem + L::kAlpha);
  const uint32_t base = smem_addr(smem);

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = lane >> 2, quad = lane & 3;  // fragment row (query head) and pair
  const int groups = p.groups;
  const long row0 = ((long)b * p.kv_heads + kh) * groups;  // q/o row of group 0
  const Live live = slot_live<kTail>(p, b);
  const int v0 = split * p.split, v1 = min(v0 + p.split, live.end);
  int cur = live.next(v0, v1);
  if (cur < 0) return;  // no live key: no partial (the merge weighs this split 0)

  // q as the A fragments of every 16-dimension step (bf16 as stored; the
  // f32 scale multiplies the f32 sums), rows past the group count zero.
  uint32_t qa[kKSteps][2];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(p.q + (row0 + row) * D);
    qa[ks][0] = row < groups ? qrow[ks * 8 + quad] : 0u;
    qa[ks][1] = row < groups ? qrow[ks * 8 + 4 + quad] : 0u;
  }
  if (tid < kMaxGroups) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  float acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  load_tile<D, kI8>(p, live, b, kh, cur, base, base + L::kTileBytes, base + L::kQ,
                    base + L::kSc);
  __syncthreads();  // m and l initialised
  for (int stage = 0; cur >= 0; stage ^= 1) {
    const int nxt = live.next(cur + kTile, v1);
    const uint32_t kb = base + stage * L::kStageBytes, vb = kb + L::kTileBytes;
    // int8 pools: this stage's K and V scales (0 on tail and dead rows)
    const float* sks = reinterpret_cast<const float*>(smem + L::kSc + stage * L::kScStage);
    const float* svs = sks + kTile;
    if (nxt >= 0) {
      const int ns = stage ^ 1;
      const uint32_t nb = base + ns * L::kStageBytes;
      load_tile<D, kI8>(p, live, b, kh, nxt, nb, nb + L::kTileBytes,
                        base + L::kQ + ns * L::kQStage, base + L::kSc + ns * L::kScStage);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the tile's K and V (int8: raw pages and scales) are in shared memory
    if (kI8) {
      // The page rows' int8 values into the bf16 tiles.
      constexpr int kChunksI8 = D / 16;
      const uint8_t* qk = smem + L::kQ + stage * L::kQStage;
      uint8_t* kt = smem + stage * L::kStageBytes;
#pragma unroll
      for (int i = 0; i < kTile * kChunksI8 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kChunksI8, c = idx % kChunksI8;
        const int v = cur + r;
        if (live.key(v) && v < live.tail0) {
          i8x16_to_bf16(qk + r * D + c * 16, kt + r * L::kLd + c * 32);
          i8x16_to_bf16(qk + L::kQTile + r * D + c * 16,
                        kt + L::kTileBytes + r * L::kLd + c * 32);
        }
      }
      __syncthreads();
    }

    // Scores of warp w's 16 keys (two n8 blocks), times the scale in f32;
    // dead keys get the finite mask value.
    {
      float c[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t at = kb + (16 * warp + 8 * j + row) * L::kLd + ks * 32 + quad * 4;
          mma16816(c[j], qa[ks][0], qa[ks][1], lds32(at), lds32(at + 16));
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
      sp[g * kPLd + lane] = __bfloat16_as_ushort(__float2bfloat16_rn(w0));
      sp[g * kPLd + lane + 32] = __bfloat16_as_ushort(__float2bfloat16_rn(w1));
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
      const uint32_t pa = base + L::kP + row * kPLd * 2 + quad * 4;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        const uint32_t a0 = row < groups ? lds32(pa + ks * 32) : 0u;
        const uint32_t a1 = row < groups ? lds32(pa + ks * 32 + 16) : 0u;
        // lane l: row (key) 16 ks + 8 ((l / 8) % 2) + l % 8, columns + 8 (l / 16)
        const uint32_t va = vb + (16 * ks + (lane & 15)) * L::kLd +
                            (warp * kNTiles * 8 + 8 * (lane >> 4)) * 2;
#pragma unroll
        for (int j = 0; j < kNTiles; j += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(va + j * 16, bf);
          mma16816(acc[j], a0, a1, bf[0], bf[1]);
          mma16816(acc[j + 1], a0, a1, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage's buffers, the scores and p are free again
    cur = nxt;
  }

  // The split's partial: m and l per row, acc.
  const long part = ((long)b * p.kv_heads + kh) * p.n_split + split;
  if (row < groups) {
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int col = warp * kNTiles * 8 + 8 * j + 2 * quad;
      *reinterpret_cast<float2*>(p.part_acc + (part * groups + row) * D + col) =
          make_float2(acc[j][0], acc[j][1]);
    }
  }
  if (tid < groups) {
    p.part_ml[(part * groups + tid) * 2] = sm[tid];
    p.part_ml[(part * groups + tid) * 2 + 1] = sl[tid];
  }
}

template <int D, bool kTail, bool kI8>
int launch(const Params& p, int batch, cudaStream_t stream) {
  static bool prepared = false;
  constexpr int kSmem = kI8 ? Layout<D>::kBytesI8 : Layout<D>::kBytes;
  auto kernel = paged_split_kernel<D, kTail, kI8>;
  if (!prepared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    prepared = true;
  }
  kernel<<<dim3(p.n_split, p.kv_heads, batch), kThreads, kSmem, stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  paged_merge_kernel<D, kTail><<<dim3(p.groups, p.kv_heads, batch), D,
                                 2 * static_cast<size_t>(p.n_split) * 4, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTail, bool kI8>
int dispatch(Params p, int batch, int heads, int head_dim, void* stream) {
  if (batch < 1 || p.kv_heads < 1 || heads % p.kv_heads || heads / p.kv_heads > kMaxGroups ||
      p.page_size < 1 || p.max_pages < 1 || p.n_pool < 1 || (kTail && p.tail_len < 1) ||
      p.split < kTile || p.split % kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.groups = heads / p.kv_heads;
  const long keys = (long)p.max_pages * p.page_size + (kTail ? p.tail_len : 0);
  const long n_split = (keys + p.split - 1) / p.split;
  if (n_split > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  p.n_split = static_cast<int>(n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, kTail, kI8>(p, batch, s);
    case 128:
      return launch<128, kTail, kI8>(p, batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K3. q (B, H, D); pools (P, K, ps, D) with P = n_pool; table (B, maxp)
// int32; lengths and starts (B,) int32; tails (B, K, T, D); o (B, H, D). bf16
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
  const Params p{static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k_pages),
                 static_cast<const uint16_t*>(v_pages), static_cast<const int*>(table),
                 static_cast<const int*>(lengths), static_cast<const int*>(starts),
                 static_cast<const uint16_t*>(tail_k), static_cast<const uint16_t*>(tail_v),
                 static_cast<uint16_t*>(o), static_cast<float*>(part_acc),
                 static_cast<float*>(part_ml), kv_heads, 0, page_size, max_pages, n_pool,
                 tail_len, split, 0, scale};
  return dispatch<true, false>(p, batch, heads, head_dim, stream);
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
  const Params p{static_cast<const uint16_t*>(q), nullptr, nullptr,
                 static_cast<const int*>(table), static_cast<const int*>(lengths),
                 static_cast<const int*>(starts), static_cast<const uint16_t*>(tail_k),
                 static_cast<const uint16_t*>(tail_v), static_cast<uint16_t*>(o),
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml), kv_heads, 0,
                 page_size, max_pages, n_pool, tail_len, split, 0, scale,
                 static_cast<const int8_t*>(k_pages), static_cast<const int8_t*>(v_pages),
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  return dispatch<true, true>(p, batch, heads, head_dim, stream);
}

// K4: the same without a tail; pages up to lengths; n_split = ceil(maxp * ps
// / split).
extern "C" int ditl_paged_bf16(const void* q, const void* k_pages, const void* v_pages,
                               const void* table, const void* lengths, void* o, void* part_acc,
                               void* part_ml, int batch, int heads, int kv_heads, int head_dim,
                               int page_size, int max_pages, int n_pool, int split, float scale,
                               void* stream) {
  const Params p{static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k_pages),
                 static_cast<const uint16_t*>(v_pages), static_cast<const int*>(table),
                 static_cast<const int*>(lengths), nullptr, nullptr, nullptr,
                 static_cast<uint16_t*>(o), static_cast<float*>(part_acc),
                 static_cast<float*>(part_ml), kv_heads, 0, page_size, max_pages, n_pool, 0,
                 split, 0, scale};
  return dispatch<false, false>(p, batch, heads, head_dim, stream);
}
