// FlashAttention forward and backward on float32 operands for Hopper
// (sm_90a): K1-f32, K2a-f32 and K2b-f32, f32 in, f32-accurate products, f32
// sums, f32 out.
//
// Replaces, for float32 inputs (the reference's kernels take any float dtype
// and sum in f32; in f32 their p.astype(v.dtype) is a no-op):
// - K1 ditl_tpu/ops/flash_attention.py::_fwd_kernel (:127, pallas_call :276):
//   entry point ditl_flash_fwd_f32, o and the per-row log-sum-exp;
// - K2a ::_dq_kernel (:300, :504): ditl_flash_bwd_dq_f32, dq = scale * sum
//   ds . k;
// - K2b ::_dkv_kernel (:362, :557): ditl_flash_bwd_dkv_f32 and, when the
//   wrapper splits the work (below), ditl_flash_bwd_dkv_split_f32: dv = sum
//   p^T . do and dk = sum ds^T . (scale q), summed over the GQA group's query
//   heads and the query tiles, in the reference's folded order (group head,
//   then query tile): race-free, and two calls give the same bits.
// The bf16 kernels (flash_fwd.cu, flash_bwd.cu) stay as they are: wgmma
// takes tf32 only K-major, and a single pass of TF32 keeps about three
// decimal digits, so it is no port of an f32 dot.
//
// Bound on the card (H100 SXM: 3.35 TB/s; f32-accurate products at 165
// TFLOP/s by 3xTF32 on the tensor cores, 67 TFLOP/s by FFMA), computed by
// chip_smoke.py from its run's inputs (each input read once, each output
// written once; 4 D flops per attended pair and head for K1, 6 D for K2a,
// 8 D for K2b):
// - serving prefill, B=4, S=512, 32/8 heads, D=128, right-padded ids: about
//   84 MB (0.025 ms) against about 8.6 GFLOP (0.05 ms at 165 TFLOP/s):
//   operations;
// - training, B=4, S=2048, 14/2 heads, D=64, the pipeline's packed rows: 68
//   MB (0.020 ms) against about 6 GFLOP (0.036 ms): operations; one packed
//   row at D = 256, 8 heads on 1 (path 15): K2b-f32 0.042 ms, operations.
// So these kernels are bound by their products. All three do only the work
// the masks leave (tile skipping).
//
// K1-f32: 3xTF32 on wgmma from operands split once into shared memory.
// What held its first, FFMA design back (PR 13: 8.6-11.9% of its bound):
// FFMA's 67 TFLOP/s, Q read from shared memory again for each key tile, and
// no copy in flight at D = 256. This design:
// - Split once. Every f32 operand element is split once a block into a TF32
//   hi tile and a lo = x - hi tile (split_tf32's rounding), both K-major
//   under the 128-byte swizzle that wgmma reads (a tf32 k8 step is 32 bytes
//   of a row, as a bf16 k16 step, so hopper.cuh's descriptors carry over).
//   Q (scaled by `scale` in f32 first) is split in place once and kept for
//   every key tile; K is split to the same swizzled offsets; V, MN-major for
//   P.V, is transposed by its split pass into V^T, each thread a 4 x 4 block
//   in registers. Every thread copies (cp.async, 16 bytes) and splits its
//   own chunks, so no barrier sits between a copy and its split.
// - Products. S = Q.K^T is wgmma m64nNk8 with both operands in shared
//   memory; O += P.V takes P from registers: the S accumulator of an n8
//   column group holds a thread's keys 2t and 2t + 1, which become the A
//   fragment's k = t and k = t + 4, and V^T's split pass stores key 2e + par
//   of each group of 8 at position 4 par + e to match. A k8 step is three
//   wgmmas, lo.hi, hi.lo, hi.hi; each 32-deep chunk of a contraction sums
//   from zero (scale-d = 0; the asm's "=f" form, so no partial is kept live
//   across sub-tiles) into a partial that a rounded FADD adds to the running
//   sum (the reference-accuracy rule of gemm_f32.cu's header).
// - Tiles (Fwd<D>, ops/flash_attention.py::f32_fwd_block): two warpgroups,
//   no producer. At D = 64 and 128 each owns 64 query rows (a block of
//   128) over 64- and 32-key sub-tiles: Q hi/lo 64 / 128 KB, a sub-tile's K
//   hi/lo, V^T hi/lo and raw K and V 16 KB each: 162 / 226 KB. At D = 256 Q
//   hi/lo alone are 128 KB at 64 rows, so both warpgroups take the block's
//   64 rows and each half of the head dim (kDSplit): its half of S's
//   contraction, the two halves added in one order through shared memory
//   (kX), and its half of O's columns; 16-key sub-tiles (V^T rows of 16
//   keys, the 64-byte swizzle), K copied into K hi and split in place: 218
//   KB. One block an SM. A sub-tile is two block barriers: after the S
//   products the threads split its V^T and put the next sub-tile's V in
//   flight, then the softmax; before (D = 64, 128) or beside (D = 256) the
//   P.V products they split the next sub-tile's K and put the one after in
//   flight. S's partials are in flight kSGroup at a time (two at D = 128,
//   where four spilled), everything that decides whether a warpgroup issues
//   wgmmas is broadcast from lane 0 (warp-uniform to the compiler), and the
//   copies of a sub-tile that does not exist zero-fill instead of branching.
// - What bounds it now: the products take about half of a sub-tile's
//   time; the rest is the V and K splits, the softmax and the drains, run
//   in lock step by both warpgroups (a clock64 trace of the phases, not
//   kept). A warp stalls issuing its wgmmas until the tensor cores take
//   them, so its own split does not run beside them, and the shared
//   sub-tile keeps one warpgroup's products from covering the other's
//   softmax. At D = 256 a branch on the visit test across the barrier
//   before the softmax made ptxas serialize every wgmma (C7518, "WG.DP in
//   divergent path"); the walk now stops at the block's last row, which
//   is both warpgroups' there, so the test is a constant.
// ptxas -v (sm_90a): 248 / 232 / 200 registers at D = 64 / 128 / 256, no
// spills.
//
// K2a-f32 and K2b-f32: 3xTF32 on the tensor cores (mma.sync.m16n8k8.tf32),
// as csrc/gemm_f32.cu runs K5/K6-f32. Each f32 operand x is split into
// hi, x rounded to the nearest TF32 value (cvt.rna's result, by two
// integer operations), and lo = x - hi (exact; the tensor cores truncate it
// to TF32, see split_tf32); a k-step accumulates lo.hi, then hi.lo, then
// hi.hi (each product good to about 2^-20). The tensor cores' own
// accumulation truncates, so every product sums each 32-deep chunk of its
// contraction from zero and adds that partial to its running f32 sum with a
// rounded FADD (warp_mma). No FFMA dot product is left in either kernel.
// The products, read from shared memory by 32-bit fragment loads, so
// K-major and MN-major operands are one helper:
// - K2a: S = Q.K^T and dP = dO.V^T (K-major, in one loop), dQ += dS.K (K
//   MN-major);
// - K2b: S^T = K.Q^T and dP^T = V.dO^T (K-major, in one loop), dV += P^T.dO
//   and dK += dS^T.Q (dO, Q MN-major, in one loop).
// What held their first, FFMA design back, and what this one does about it:
// 1. FFMA's ceiling (67 TFLOP/s) and a shared-memory load for every two
//    FMAs: the tensor cores, 165 TFLOP/s for f32-accurate products.
// 2. K2b's grid, (KV heads, batch, key tiles), 32 blocks on 132 SMs at path
//    15's row: a split of each KV head's items (group head, query tile),
//    below.
// 3. No copy in flight at D = 256 (64-row tiles did not fit twice): tiles
//    of kR = 32 rows at D = 256 (64 at D = 64, 128), so two stages of the
//    streamed tiles fit beside the block's own, and the next tile's cp.async
//    lands while the current one is computed at every head dim.
// What bounds them now: the instructions around each MMA, not the tensor
// cores (chip_smoke.py's [f32-timing] and [hd-timing] put them at 11-15% of
// the 3xTF32 bound on an H100 SXM at 700 W). mma.sync needs every operand
// split by the threads: per fragment value a 32-bit shared load, the split
// and its address, so a warp runs several instructions for each MMA.
// What cut them: both products of a pair in one loop, the split in integer
// operations with lo unrounded, and XOR-free addresses inside the chunk
// loop; separate accumulators for the hi.hi and the correction MMAs did
// not. wgmma, which reads both operands from shared memory without the
// threads, takes tf32 only K-major, so the MN-major products would need a
// transposed copy.
//
// Tiles (Bwd<D>): a block owns kR rows (K2a: query rows of one head; K2b:
// keys of one KV head) and streams tiles of kR rows (K2a: keys, K and V;
// K2b: query rows of the group's heads, Q, dO, lse, delta and ids), two
// stages; 256 threads, 8 warps as kR / 16 row blocks of 16 by 8 / (kR / 16)
// column blocks over every product's output (a warp's S is 16 x 32 at kR =
// 64, 16 x 8 at kR = 32; its dQ, dK or dV 16 x D / 2 or 16 x D / 4, two n8
// tiles a pass). dS (K2a) and P^T, dS^T (K2b) go through shared memory as
// the second products' A operands. Shared memory is unpadded and swizzled:
// element (r, c) of a tile with rows of W floats lies at r W + (c ^
// swz(r)), swz(r) = (r & 3) << 3 | (r & 4), which keeps both a warp's
// K-major fragment reads (8 rows x 4 columns) and its MN-major ones (4 rows
// x 8 columns) on 32 distinct banks, and every 16-byte chunk whole. K2a
// 116.2 / 214.5 / 202.0 KB at D = 64 / 128 / 256 (Q, dO, two K/V stages,
// dS); K2b 133.6 / 232.0 / 206.6 KB (K, V, two Q/dO stages, P^T, dS^T); one
// block an SM. ptxas -v (sm_90a): K2a-f32 183 / 224 / 183 registers at D =
// 64 / 128 / 256, K2b-f32 221 / 255 / 254, the split sum 32; no spills.
//
// K2b-f32's split (ops/flash_attention.py::f32_dkv_splits, a pure function
// of the shapes and the H100 SXM's 132 SMs, as K6-f32's split): when KV
// heads x batch x key tiles is under two waves (2 x 132 blocks), each KV
// head's items, in the folded order i = g n_q + t, are cut into `splits`
// contiguous runs of `chunk` items (at most 16 runs); grid (KV heads x
// splits, batch, key tiles). Each run writes its partial dK and dV into an
// f32 workspace (2, splits, B, Skv, K, D) that the wrapper allocates, and
// flash_dkv_f32_sum_kernel adds the runs in the order 0, 1, ..., splits -
// 1. No atomics: two calls give the same bits. At path 15's row (8 heads
// on 1, S = 2048, D = 256): 64 key blocks, 5 runs of 103 items, 320 blocks.
//
// Tile skipping, the bf16 kernels' rule: a (query tile, key tile) pair is
// visited unless causal and the key tile starts past the query tile's last
// row, or the two tiles' segment-id ranges [min, max] are disjoint (then no
// pair in them is admitted, for any ids). ops/flash_attention.py::
// tile_schedule is this rule at (f32_fwd_block(D)[0] rows, F32_BLOCK keys)
// (K1-f32) and f32_bwd_block(D) (K2a-f32, K2b-f32). A block marks the tiles
// it visits once, in shared memory (a bit each), then walks them; K1-f32
// walks each marked 64-key tile in sub-tiles, and a warpgroup skips a
// sub-tile that starts past its last row (f32_fwd_visits). On the training pipeline's
// packed rows the attended pairs are about a fifth of the causal ones.
// Blocks with the longest loops start first: K1 and K2a walk the query
// tiles from the last, K2b the key tiles from the first.
//
// Semantics, the reference's in f32: q is scaled in f32 before the q.k
// product (q * scale, then the dot); masked scores take the finite
// -2.3819763e38, so a tile fully masked for a row gives p = exp(0) = 1 that
// the next real key's rescale zeroes, as in the reference (never inf -
// inf); keys past Skv take -inf (weight exactly 0; the reference has no
// ragged edge); p stays f32 for p.v; rows whose normaliser is 0 write 0;
// lse = m + log(l), natural log. In the backward p = exp(s - lse), ds = p
// (dp - delta) with delta = rowsum(do * o) an input (computed by PyTorch,
// as the reference computes it outside its kernels); rows past Sq take p =
// 0. Exponents by expf (not the fast intrinsic).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // smem_addr, make_desc, the wgmma fence/commit/wait, fence_regs

namespace {

constexpr int kB = 64;           // keys of a tile K1-f32 marks (F32_BLOCK)
constexpr int kThreads = 256;    // K2a-f32's and K2b-f32's blocks
constexpr int kMaxTiles = 4096;  // 64-key tiles a block can mark: S <= 262,144
constexpr float kNegInf = -2.3819763e38f;  // ops/attention.py NEG_INF

// 16 bytes global -> shared, in flight until cp_wait; with valid == false
// the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; with valid == false, zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// [min, max] of ids[r0 .. r1) (r1 > r0) into lo / hi, by the first warp.
__device__ __forceinline__ void id_range(const int* ids, int r0, int r1, int* out) {
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = r0 + threadIdx.x; r < r1; r += 32) {
      lo = min(lo, ids[r]);
      hi = max(hi, ids[r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (threadIdx.x == 0) {
      out[0] = lo;
      out[1] = hi;
    }
  }
}

// ---------------------------------------------------------------------------
// K2a-f32 and K2b-f32: 3xTF32 on mma.sync over swizzled shared-memory tiles.
// ---------------------------------------------------------------------------

// The backward kernels' tiles at head dim D (ops/flash_attention.py::
// f32_bwd_block): a block owns kR rows and streams tiles of kR rows; its 8
// warps are kWM row blocks of 16 by kWN column blocks of every product's
// output, kNS n8 tiles a warp in a kR-wide product (S, dP), kND in a D-wide
// one (dQ, dK, dV), taken kNP at a time.
template <int D>
struct Bwd {
  static constexpr int kR = D == 256 ? 32 : 64;
  static constexpr int kWM = kR / 16;
  static constexpr int kWN = 8 / kWM;
  static constexpr int kNS = kR / kWN / 8;
  static constexpr int kND = D / kWN / 8;
  static constexpr int kNP = 2;  // n8 tiles a pass of a D-wide product (its partials' registers)
  static constexpr int kTile = kR * D;  // floats of a kR x D tile
  static constexpr int kSq = kR * kR;   // floats of a kR x kR tile
};

constexpr int kMaxBits = 8192;  // tiles a backward block can mark: S <= 262,144 at kR = 32

// Element (r, c) of a swizzled tile whose rows hold W floats (W a multiple
// of 32): a warp's fragment reads, 8 rows x 4 columns (K-major) or 4 rows x
// 8 columns (MN-major) from a row a multiple of 8 or 4, reach 32 distinct
// banks, and a 16-byte chunk (c a multiple of 4) stays whole.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

template <int W>
__device__ __forceinline__ int at_sw(int r, int c) {
  return r * W + (c ^ swz(r));
}

// Rows [r0, r0 + R) of a matrix whose rows lie row_stride floats apart (D
// floats each, from src) into a swizzled R x D tile; rows >= n arrive as
// zeros. scale_tile walks the same chunks.
template <int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long row_stride, int r0,
                                          int n) {
  constexpr int kChunks = D / 4;
  static_assert(R * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = 4 * (idx % kChunks);
    const bool ok = r0 + r < n;
    cp_async16(dst + at_sw<D>(r, c), ok ? src + (long)(r0 + r) * row_stride + c : src, ok);
  }
}

// Multiplies the chunks this thread copied with load_tile by scale, once
// they have landed (the barrier after this makes them visible to the
// block): q * scale in f32.
template <int R, int D>
__device__ __forceinline__ void scale_tile(float* tile, float scale) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    float4* p = reinterpret_cast<float4*>(tile + at_sw<D>(idx / kChunks, 4 * (idx % kChunks)));
    float4 x = *p;
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *p = x;
  }
}

// x = hi + lo, hi a TF32 value and lo = x - hi exact (as mma operand bits).
// hi is x rounded to the nearest TF32 value, ties away from zero: cvt.rna.
// tf32.f32's result for every finite x (and for inf), in two integer
// operations where the cvt takes four. lo is handed over unrounded: the
// tensor cores read the top 19 bits of a tf32 operand, so they truncate it,
// by less than 2^-10 |lo| < 2^-20 |x|, the size of the lo.lo term that
// 3xTF32 drops anyway. Against cvt.rna of both halves this changed the
// kernels' errors within their last digit and cut the instructions that
// bound them (below).
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

// Element (i, kl) of a warp's operand in a swizzled tile with rows of W
// floats: i its output row (A) or column (B), kl its contraction index, both
// counted from s, the tile advanced to the warp's chunk (kc columns of a
// K-major tile, whose rows hold i; kc rows of an MN-major one, whose rows
// hold kl; kc a multiple of 32) and to the warp's first row (K-major, a
// multiple of 8) or column (MN-major, a multiple of 32); i < 64, kl < 32.
// Every XOR then depends on the thread and on constants alone, so the
// compiler computes it once, outside the chunk loop.
template <int W, bool MN>
__device__ __forceinline__ float operand(const float* s, int i, int kl) {
  return MN ? s[kl * W + (i & ~31) + ((i & 31) ^ swz(kl))] : s[i * W + (kl ^ swz(i))];
}

// acc[o] (the warp's rows m0 .. m0 + 15, columns n0 .. n0 + 8 NT - 1) +=
// A_o . B_o over the contraction k < K, for the NOPS products o (a[o], b[o]:
// whole tiles) in one loop, so their MMAs interleave; NP n8 tiles a pass.
// 3xTF32: a k-step accumulates lo.hi, then hi.lo, then hi.hi; each 32-deep
// chunk's MMAs are summed from zero, then added to acc by a rounded FADD. A
// fragment: rows g and g + 8, k t and t + 4; B fragment: column g of an n8
// tile, k t and t + 4; acc[o][j]: rows g, g + 8, columns 2t, 2t + 1 of n8
// tile j (g = lane / 4, t = lane % 4).
template <int NOPS, int NT, int NP, int K, int WA, bool AMN, int WB, bool BMN>
__device__ __forceinline__ void warp_mma(float (&acc)[NOPS][NT][4], const float* const* a,
                                         int m0, const float* const* b, int n0) {
  static_assert(K % 32 == 0 && NT % NP == 0, "whole chunks and passes");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kc = 0; kc < K; kc += 32) {
    const float* ac[NOPS];
    const float* bc[NOPS];
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
      ac[o] = a[o] + (AMN ? kc * WA + m0 : m0 * WA + kc);
      bc[o] = b[o] + (BMN ? kc * WB + n0 : n0 * WB + kc);
    }
#pragma unroll
    for (int p = 0; p < NT; p += NP) {
      float part[NOPS][NP][4];
#pragma unroll
      for (int o = 0; o < NOPS; ++o) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[o][j][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 32; kk += 8) {
#pragma unroll
        for (int o = 0; o < NOPS; ++o) {
          uint32_t ah[4], al[4];
          split_tf32(operand<WA, AMN>(ac[o], g, kk + t), ah[0], al[0]);
          split_tf32(operand<WA, AMN>(ac[o], g + 8, kk + t), ah[1], al[1]);
          split_tf32(operand<WA, AMN>(ac[o], g, kk + t + 4), ah[2], al[2]);
          split_tf32(operand<WA, AMN>(ac[o], g + 8, kk + t + 4), ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            uint32_t bh[2], bl[2];
            split_tf32(operand<WB, BMN>(bc[o], 8 * (p + j) + g, kk + t), bh[0], bl[0]);
            split_tf32(operand<WB, BMN>(bc[o], 8 * (p + j) + g, kk + t + 4), bh[1], bl[1]);
            mma_tf32(part[o][j], al, bh);
            mma_tf32(part[o][j], ah, bl);
            mma_tf32(part[o][j], ah, bh);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < NOPS; ++o) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[o][p + j][e] = __fadd_rn(acc[o][p + j][e], part[o][j][e]);
          }
        }
      }
    }
  }
}

// Marks, as bits of vis, the streamed tiles t < n (tile positions from t *
// tile, real ones < len) that a block visits: mark_tiles' rule at tiles of
// `tile` rows. Every thread runs the same number of rounds (the ballot).
__device__ __forceinline__ void mark_bits(uint32_t* vis, int n, int tile, int len, const int* ids,
                                          const int* range, bool kv_stream, bool causal,
                                          int limit) {
  for (int base = 0; base < n; base += kThreads) {
    const int tt = base + threadIdx.x;
    bool visit = false;
    if (tt < n) {
      const int p0 = tt * tile, p1 = min(len, p0 + tile);
      visit = !causal || (kv_stream ? p0 <= limit : p1 - 1 >= limit);
      if (visit && ids != nullptr) {
        int lo = INT_MAX, hi = INT_MIN;
        for (int p = p0; p < p1; ++p) {
          lo = min(lo, ids[p]);
          hi = max(hi, ids[p]);
        }
        visit = lo <= range[1] && hi >= range[0];
      }
    }
    const uint32_t word = __ballot_sync(0xffffffffu, visit);
    if ((threadIdx.x & 31) == 0 && tt < n) vis[tt >> 5] = word;
  }
}

// The first marked tile after t (t >= -1), or n.
__device__ __forceinline__ int next_bit(const uint32_t* vis, int t, int n) {
  for (++t; t < n; t = (t | 31) + 1) {
    const uint32_t w = vis[t >> 5] >> (t & 31);
    if (w != 0) return t + __ffs(w) - 1;
  }
  return n;
}

// Shared memory of the backward kernels, in floats, then the tile marks.
template <int D>
struct DqSmem {  // Q, dO, two K/V stages, dS, key ids of two stages, id range
  using C = Bwd<D>;
  static constexpr int kQ = 0, kDo = C::kTile, kKV = 2 * C::kTile;
  static constexpr int kDs = kKV + 4 * C::kTile;
  static constexpr int kIds = kDs + C::kSq, kRange = kIds + 2 * C::kR, kVis = kRange + 4;
  static constexpr int kBytes = (kVis + kMaxBits / 32) * 4;
};

template <int D>
struct DkvSmem {  // K, V, two Q/dO stages, P^T, dS^T, (lse, delta, ids) x 2, id range
  using C = Bwd<D>;
  static constexpr int kK = 0, kV = C::kTile, kQdo = 2 * C::kTile;
  static constexpr int kP = kQdo + 4 * C::kTile, kDs = kP + C::kSq;
  static constexpr int kStats = kDs + C::kSq, kRange = kStats + 2 * 3 * C::kR;
  static constexpr int kVis = kRange + 4;
  static constexpr int kBytes = (kVis + kMaxBits / 32) * 4;
};

// ---------------------------------------------------------------------------
// K2a-f32: grid (heads, batch, query tiles of kR rows), dq.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, float* __restrict__ dq, int sq, int skv,
                    int heads, int kv_heads, int causal, float scale) {
  using C = Bwd<D>;
  using L = DqSmem<D>;
  constexpr int kR = C::kR;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQ;
  float* dos = smem + L::kDo;
  float* dss = smem + L::kDs;
  int* kid = reinterpret_cast<int*>(smem + L::kIds);
  int* range = reinterpret_cast<int*>(smem + L::kRange);
  uint32_t* vis = reinterpret_cast<uint32_t*>(smem + L::kVis);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kR;  // longest causal rows first
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int m0 = warp / C::kWN * 16;               // the warp's rows of every product
  const int ns = warp % C::kWN * (kR / C::kWN);   // its columns of S and dP
  const int nd = warp % C::kWN * (D / C::kWN);    // its columns of dQ
  const int* ids = seg != nullptr ? seg + (long)b * skv : nullptr;  // Sq == Skv
  const int q_last = min(sq, q0 + kR) - 1;
  const int n_kv = (skv + kR - 1) / kR;
  const long q_stride = (long)heads * D, kv_stride = (long)kv_heads * D;
  const long qoff = (long)b * sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const float* vb = v + (long)b * skv * kv_stride + (long)kh * D;
  const long stat = ((long)b * heads + h) * sq;

  if (ids != nullptr) id_range(ids, q0, q_last + 1, range);
  __syncthreads();
  mark_bits(vis, n_kv, kR, skv, ids, range, true, causal, q_last);
  int rid[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // this thread's rows g and g + 8 of the warp's
    const int row = q0 + m0 + g + 8 * i;
    rid[i] = ids != nullptr ? ids[min(row, sq - 1)] : 0;
    lse_r[i] = row < sq ? lse[stat + row] : INFINITY;  // rows past Sq: p = 0
    delta_r[i] = row < sq ? delta[stat + row] : 0.f;
  }
  __syncthreads();

  auto load_kv = [&](int tile, int stage) {
    float* ks = smem + L::kKV + 2 * stage * C::kTile;
    load_tile<kR, D>(ks, kb, kv_stride, tile * kR, skv);
    load_tile<kR, D>(ks + C::kTile, vb, kv_stride, tile * kR, skv);
    if (ids != nullptr && tid < kR) {
      const int p = tile * kR + tid;
      cp_async4(kid + stage * kR + tid, ids + min(p, skv - 1), p < skv);
    }
  };

  int cur = next_bit(vis, -1, n_kv);
  load_tile<kR, D>(qs, q + qoff, q_stride, q0, sq);
  load_tile<kR, D>(dos, dout + qoff, q_stride, q0, sq);
  if (cur < n_kv) load_kv(cur, 0);
  cp_commit();

  float acc[1][C::kND][4];
#pragma unroll
  for (int j = 0; j < C::kND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  }
  for (int stage = 0, first = 1; cur < n_kv; stage ^= 1, first = 0) {
    const int nxt = next_bit(vis, cur, n_kv);
    if (nxt < n_kv) {
      load_kv(nxt, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if (first) scale_tile<kR, D>(qs, scale);
    __syncthreads();  // this stage's K, V and ids (and Q, dO) are in shared memory
    const float* ks = smem + L::kKV + 2 * stage * C::kTile;
    const float* vs = ks + C::kTile;
    const int* kids = kid + stage * kR;
    const int k0 = cur * kR;
    float sp[2][C::kNS][4];  // S = Q.K^T, dP = dO.V^T
#pragma unroll
    for (int j = 0; j < C::kNS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[0][j][e] = sp[1][j][e] = 0.f;
    }
    const float* sa[2] = {qs, dos};
    const float* sb[2] = {ks, vs};
    warp_mma<2, C::kNS, C::kNS, D, D, false, D, false>(sp, sa, m0, sb, ns);
    const float(&s)[C::kNS][4] = sp[0];
    const float(&dp)[C::kNS][4] = sp[1];
    // dS = P (dP - delta) into the dS tile, P from the scores with the
    // masks, lse and delta of this thread's rows.
#pragma unroll
    for (int j = 0; j < C::kNS; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + g + 8 * i, row = q0 + r, c = ns + 8 * j + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + c + e;
          float x = s[j][2 * i + e];
          if (col >= skv) {
            x = -INFINITY;  // not a key at all: weight exactly 0
          } else if ((causal && col > row) || (ids != nullptr && kids[c + e] != rid[i])) {
            x = kNegInf;
          }
          const float p = expf(x - lse_r[i]);
          ds[e] = p * (dp[j][2 * i + e] - delta_r[i]);
        }
        *reinterpret_cast<float2*>(dss + at_sw<kR>(r, c)) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // dS complete
    warp_mma<1, C::kND, C::kNP, kR, kR, false, D, true>(acc, &dss, m0, &ks, nd);  // dQ += dS.K
    __syncthreads();  // this stage and dS are free again
    cur = nxt;
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + m0 + g + 8 * i;
    if (row >= sq) continue;
    float* out = dq + qoff + (long)row * q_stride;
#pragma unroll
    for (int j = 0; j < C::kND; ++j) {
      *reinterpret_cast<float2*>(out + nd + 8 * j + 2 * t) =
          make_float2(scale * acc[0][j][2 * i], scale * acc[0][j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2b-f32: grid (KV heads x splits, batch, key tiles of kR keys), dk and dv.
// A block walks its run of the KV head's items (group head i / n_q, query
// tile i % n_q) for i in [split chunk, split chunk + chunk), the tiles it
// visits only; run `split` writes dk + split split_stride (dv likewise).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, float* __restrict__ dk, float* __restrict__ dv,
                     long split_stride, int sq, int skv, int heads, int kv_heads, int causal,
                     int splits, int chunk, float scale) {
  using C = Bwd<D>;
  using L = DkvSmem<D>;
  constexpr int kR = C::kR;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* pts = smem + L::kP;
  float* dss = smem + L::kDs;
  int* range = reinterpret_cast<int*>(smem + L::kRange);
  uint32_t* vis = reinterpret_cast<uint32_t*>(smem + L::kVis);

  const int split = blockIdx.x % splits, kh = blockIdx.x / splits, b = blockIdx.y;
  const int k0 = blockIdx.z * kR;  // the first key blocks have the longest loops
  const int groups = heads / kv_heads;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int m0 = warp / C::kWN * 16;              // the warp's keys of every product
  const int ns = warp % C::kWN * (kR / C::kWN);  // its query columns of S^T and dP^T
  const int nd = warp % C::kWN * (D / C::kWN);   // its columns of dK and dV
  const int* ids = seg != nullptr ? seg + (long)b * skv : nullptr;  // Sq == Skv
  const int k_last = min(skv, k0 + kR) - 1;
  const int n_q = (sq + kR - 1) / kR;
  const int i0 = split * chunk, i1 = min(groups * n_q, i0 + chunk);
  const long q_stride = (long)heads * D, kv_stride = (long)kv_heads * D;
  const long kvoff = (long)b * skv * kv_stride + (long)kh * D;

  if (ids != nullptr) id_range(ids, k0, k_last + 1, range);
  __syncthreads();
  mark_bits(vis, n_q, kR, sq, ids, range, false, causal, k0);
  int kid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kid[i] = ids != nullptr ? ids[min(k0 + m0 + g + 8 * i, skv - 1)] : 0;
  __syncthreads();

  // The first visited item after item i in this run, or i1.
  auto next_item = [&](int i) {
    for (int c = i + 1; c < i1;) {
      const int base = c - c % n_q;
      const int tq = next_bit(vis, c - base - 1, n_q);
      if (tq < n_q) return min(base + tq, i1);
      c = base + n_q;
    }
    return i1;
  };
  // Item i's Q and dO rows into a stage, its lse, delta and ids beside.
  auto load_item = [&](int i, int stage) {
    const int hq = kh * groups + i / n_q, r0 = i % n_q * kR;
    const long qoff = (long)b * sq * q_stride + (long)hq * D;
    float* qs = smem + L::kQdo + 2 * stage * C::kTile;
    load_tile<kR, D>(qs, q + qoff, q_stride, r0, sq);
    load_tile<kR, D>(qs + C::kTile, dout + qoff, q_stride, r0, sq);
    float* st = smem + L::kStats + stage * 3 * kR;
    const long stat = ((long)b * heads + hq) * sq;
    if (tid < 3 * kR) {
      const int which = tid / kR, p = r0 + tid % kR, pc = min(p, sq - 1);
      const bool ok = p < sq && (which < 2 || ids != nullptr);
      const void* src = which == 0 ? static_cast<const void*>(lse + stat + pc)
                        : which == 1 ? static_cast<const void*>(delta + stat + pc)
                                     : static_cast<const void*>(ids != nullptr ? ids + pc
                                                                               : nullptr);
      cp_async4(st + tid, ok ? src : lse + stat, ok);
    }
  };

  int it = next_item(i0 - 1);
  load_tile<kR, D>(ks, k + kvoff, kv_stride, k0, skv);
  load_tile<kR, D>(vs, v + kvoff, kv_stride, k0, skv);
  if (it < i1) load_item(it, 0);
  cp_commit();

  float dvk[2][C::kND][4];  // dV += P^T.dO, dK += dS^T.Q
#pragma unroll
  for (int j = 0; j < C::kND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dvk[0][j][e] = dvk[1][j][e] = 0.f;
  }
  const float(&dv_acc)[C::kND][4] = dvk[0];
  const float(&dk_acc)[C::kND][4] = dvk[1];
  for (int stage = 0; it < i1; stage ^= 1) {
    const int nit = next_item(it);
    if (nit < i1) {
      load_item(nit, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    float* qs = smem + L::kQdo + 2 * stage * C::kTile;
    const float* dos = qs + C::kTile;
    scale_tile<kR, D>(qs, scale);
    __syncthreads();  // this stage's Q (scaled), dO, lse, delta and ids (and K, V)
    const float* st = smem + L::kStats + stage * 3 * kR;
    const int* rids = reinterpret_cast<const int*>(st + 2 * kR);
    const int r0 = it % n_q * kR;
    float sp[2][C::kNS][4];  // S^T = K.Q^T (keys x queries), dP^T = V.dO^T
#pragma unroll
    for (int j = 0; j < C::kNS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[0][j][e] = sp[1][j][e] = 0.f;
    }
    const float* sa[2] = {ks, vs};
    const float* sb[2] = {qs, dos};
    warp_mma<2, C::kNS, C::kNS, D, D, false, D, false>(sp, sa, m0, sb, ns);
    const float(&s)[C::kNS][4] = sp[0];
    const float(&dp)[C::kNS][4] = sp[1];
    // P^T and dS^T = P^T (dP^T - delta) into their tiles, with the masks and
    // the item's lse and delta.
#pragma unroll
    for (int j = 0; j < C::kNS; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + g + 8 * i, key = k0 + r, c = ns + 8 * j + 2 * t;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + c + e;
          float x = s[j][2 * i + e];
          if ((causal && key > row) || (ids != nullptr && rids[c + e] != kid[i])) x = kNegInf;
          p[e] = row < sq ? expf(x - st[c + e]) : 0.f;
          ds[e] = p[e] * (dp[j][2 * i + e] - st[kR + c + e]);
        }
        *reinterpret_cast<float2*>(pts + at_sw<kR>(r, c)) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(dss + at_sw<kR>(r, c)) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // P^T and dS^T complete
    const float* da[2] = {pts, dss};
    const float* db[2] = {dos, qs};
    warp_mma<2, C::kND, C::kNP, kR, kR, false, D, true>(dvk, da, m0, db, nd);
    __syncthreads();  // this stage, P^T and dS^T are free again
    it = nit;
  }
  cp_wait<0>();

  float* dko = dk + split * split_stride + kvoff;
  float* dvo = dv + split * split_stride + kvoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + m0 + g + 8 * i;
    if (key >= skv) continue;
#pragma unroll
    for (int j = 0; j < C::kND; ++j) {
      const long off = (long)key * kv_stride + nd + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dko + off) = make_float2(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dvo + off) = make_float2(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// dk and dv (n floats each) = the sums of K2b-f32's runs in work (2, splits,
// n: dk's runs, then dv's), four floats a thread, the runs in the order 0,
// 1, ..., splits - 1.
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_sum_kernel(
    const float* __restrict__ work, float* __restrict__ dk, float* __restrict__ dv, long n,
    int splits) {
  const long i = ((long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;  // n is a multiple of 4: a group lies in one output
  const long e = is_v ? i - n : i;
  const float* src = work + (is_v ? (long)splits * n : 0) + e;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<float4*>((is_v ? dv : dk) + e) = acc;
}

// ---------------------------------------------------------------------------
// K1-f32: 3xTF32 on wgmma from operands split once into shared memory.
// ---------------------------------------------------------------------------

// m64nNk8 products on tf32 operands, f32 sums d[N / 2] a thread in the
// m64nN accumulator layout. _ss: A (64 x 8) and B (N x 8) both K-major in
// shared memory (tf32 takes no transposed operand); _rs: A from registers,
// the mma.m16n8k8.tf32 A fragment of each warp's 16 rows: (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4). Each asm is a macro of d's constraint:
// kAcc adds to d ("+f", scale-d = 1); otherwise d is written from zero
// ("=f", scale-d = 0), so its old values are dead to the compiler and a
// partial is not kept live from one sub-tile to the next.
#define DITL_TF32_SS_N16(C)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7}, "  \
      "%8, %9, p, 1, 1;\n}\n"  \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7])  \
      : "l"(a), "l"(b), "r"(scale_d))

#define DITL_TF32_SS_N32(C)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "  \
      "%16, %17, p, 1, 1;\n}\n"  \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),  \
        C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15])  \
      : "l"(a), "l"(b), "r"(scale_d))

#define DITL_TF32_SS_N64(C)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "%32, %33, p, 1, 1;\n}\n"  \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),  \
        C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]),  \
        C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]),  \
        C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])  \
      : "l"(a), "l"(b), "r"(scale_d))

#define DITL_TF32_RS_N64(C)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"  \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),  \
        C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]),  \
        C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]),  \
        C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

#define DITL_TF32_RS_N128(C)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"  \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),  \
        C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]),  \
        C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]),  \
        C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31]),  \
        C(d[32]), C(d[33]), C(d[34]), C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]),  \
        C(d[40]), C(d[41]), C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]),  \
        C(d[48]), C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]),  \
        C(d[56]), C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

template <int N, bool kAcc>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t a, uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64, "key sub-tile");
  const int scale_d = kAcc;
  if constexpr (kAcc) {
    if constexpr (N == 16) DITL_TF32_SS_N16("+f");
    else if constexpr (N == 32) DITL_TF32_SS_N32("+f");
    else DITL_TF32_SS_N64("+f");
  } else {
    if constexpr (N == 16) DITL_TF32_SS_N16("=f");
    else if constexpr (N == 32) DITL_TF32_SS_N32("=f");
    else DITL_TF32_SS_N64("=f");
  }
}

template <int N, bool kAcc>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a, uint64_t b) {
  static_assert(N == 64 || N == 128, "columns of a P.V pass");
  const int scale_d = kAcc;
  if constexpr (kAcc) {
    if constexpr (N == 64) DITL_TF32_RS_N64("+f");
    else DITL_TF32_RS_N128("+f");
  } else {
    if constexpr (N == 64) DITL_TF32_RS_N64("=f");
    else DITL_TF32_RS_N128("=f");
  }
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x = hi + lo four floats at a time, split_tf32's rounding.
__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  uint32_t h, l;
  split_tf32(x.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  split_tf32(x.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  split_tf32(x.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  split_tf32(x.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

// Its argument, opaque to the compiler: what is computed from it inside a
// loop stays there, instead of being hoisted into registers held across the
// loop (K1-f32's copies and splits recompute their addresses from it).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// cp_async4 where `active`, as a predicated instruction: no branch, so no
// divergent path sits between a warpgroup's wgmmas and their wait (ptxas
// serializes the wgmmas of a warpgroup whose code may diverge there).
__device__ __forceinline__ void cp_async4_if(void* dst, const void* src, bool valid,
                                             bool active) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p cp.async.ca.shared.global [%0], [%1], 4, %2;\n}\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(valid ? 4 : 0), "r"(static_cast<int>(active))
      : "memory");
}

// K1-f32's tiles and shared memory at head dim D (ops/flash_attention.py::
// f32_fwd_block): two warpgroups walk the visited 64-key tiles in sub-tiles
// of kN keys. At D = 64 and 128 each owns 64 query rows (a block of 128)
// and all of D; at D = 256 (kDSplit), where Q's hi and lo tiles alone fill
// 128 KB at 64 rows, both take the block's 64 rows and each one half of D:
// its half of S's contraction (the halves summed through shared memory, kX)
// and its half of O's columns. Byte offsets from a 1024-aligned base; every
// operand tile starts on a 1024-byte boundary.
template <int D>
struct Fwd {
  static constexpr bool kDSplit = D == 256;
  static constexpr int kThreads = 256;
  static constexpr int kRows = kDSplit ? 64 : 128;              // query rows a block
  static constexpr int kN = D == 64 ? 64 : D == 128 ? 32 : 16;  // keys a sub-tile
  static constexpr int kSub = kB / kN;                          // sub-tiles a 64-key tile
  static constexpr int kVW = kN < 32 ? kN : 32;                 // keys a row of a V^T panel
  static constexpr uint64_t kVLayout = kVW == 32 ? 1 : 2;       // 128- or 64-byte swizzle
  static constexpr int kChunks = kDSplit ? 4 : D / 32;          // S's 32-deep chunks a warpgroup
  static constexpr int kSGroup = D == 128 ? 2 : kChunks;        // of them in flight at once
  static constexpr int kCols = kDSplit ? D / 2 : D;             // O's columns a warpgroup
  static constexpr int kPVK = kN < 32 ? kN : 32;                // keys a P.V partial
  static constexpr int kQ = kRows * D * 4;  // bytes of Q hi (or Q lo)
  static constexpr int kKV = kN * D * 4;    // bytes of one sub-tile operand
  static constexpr int kQHi = 0, kQLo = kQ;
  static constexpr int kKHi = 2 * kQ, kKLo = kKHi + kKV;
  static constexpr int kVHi = kKLo + kKV, kVLo = kVHi + kKV;
  static constexpr int kRawV = kVLo + kKV;
  // Raw K beside (D = 64, 128) or, at D = 256, loaded into K hi and split in
  // place; there the halves of S go through kX (a warpgroup's partial sums).
  static constexpr int kRawK = kDSplit ? kKHi : kRawV + kKV;
  static constexpr int kX = kRawV + kKV;
  static constexpr int kIds = kDSplit ? kX + 2 * 128 * kN / 2 * 4 : kRawK + kKV;
  static constexpr int kRange = kIds + 8 * kN;  // key ids of two sub-tiles before it
  static constexpr int kVis = kRange + 16;      // marks of the 64-key tiles, bits
  static constexpr int kSmem = kVis + kMaxTiles / 8;
  static constexpr int kSmemAlloc = kSmem + 1024;  // room to align the base
  // A thread's share of a sub-tile: four K chunks and one 4 x 4 V unit.
  static_assert(kN * D / 4 == 4 * kThreads && kN * D / 16 == kThreads, "per-thread shares");
};

// Byte offset of 16-byte chunk c (floats 4c .. 4c + 3) of row r in a
// K-major tile of R rows: panels of 32 floats (128 bytes) a row, each
// R x 128 bytes, the 128-byte swizzle (chunk c % 8 at (c % 8) ^ (r % 8)).
template <int R>
__device__ __forceinline__ int kmaj_off(int r, int c) {
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Raw V (N keys of D floats): chunk c of key row kap at kap D + (c ^
// rsw(kap)), so the eight lanes that read one row chunk in the split reach
// eight bank groups.
template <int D>
__device__ __forceinline__ int rawv_off(int kap, int c) {
  return kap * D * 4 + ((c ^ ((kap & 1) | (((kap >> 3) & 3) << 1))) << 4);
}

// V^T, the B operand of P.V, K-major: row d holds the sub-tile's keys in
// panels of VW (32 keys, 128-byte swizzle; 16 keys at D = 256, 64-byte
// swizzle). Within each group of 8 keys, key 2e + par sits at 4 par + e:
// a thread's P accumulator holds keys 2t, 2t + 1 of an n8 column group,
// which are the A fragment's k = t and t + 4 (see the header). Chunk `chunk`
// (0-7) of panel kp of row d.
template <int D, int VW>
__device__ __forceinline__ int vt_off(int kp, int d, int chunk) {
  const int swz = VW == 32 ? (d & 7) : ((d >> 1) & 3);
  return kp * D * VW * 4 + d * VW * 4 + ((chunk ^ swz) << 4);
}

// S's partials of kSGroup 32-deep chunks of d, one each (3xTF32 a k8
// step: lo.hi, hi.lo, hi.hi, the first from zero), one commit group. q_hi
// .. k_lo: shared addresses of the warpgroup's Q rows and of K at the
// group's first chunk; a k8 step adds its panel and its 32 bytes within the
// row to the descriptors, constants.
template <int D>
__device__ __forceinline__ void fwd_issue_s(float (&sp)[Fwd<D>::kSGroup][Fwd<D>::kN / 2],
                                            uint32_t q_hi, uint32_t q_lo, uint32_t k_hi,
                                            uint32_t k_lo) {
  using F = Fwd<D>;
  const uint64_t dqh = make_desc(q_hi, 16, 1024, 1), dql = make_desc(q_lo, 16, 1024, 1);
  const uint64_t dkh = make_desc(k_hi, 16, 1024, 1), dkl = make_desc(k_lo, 16, 1024, 1);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < F::kSGroup; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t qo = (c * F::kRows * 128 + kk * 32) >> 4;
      const uint64_t ko = (c * F::kN * 128 + kk * 32) >> 4;
      if (kk == 0) wgmma_tf32_ss<F::kN, false>(sp[c], dql + qo, dkh + ko);
      else wgmma_tf32_ss<F::kN, true>(sp[c], dql + qo, dkh + ko);
      wgmma_tf32_ss<F::kN, true>(sp[c], dqh + qo, dkl + ko);
      wgmma_tf32_ss<F::kN, true>(sp[c], dqh + qo, dkh + ko);
    }
  }
  wgmma_commit();
}

// Waits for fwd_issue_s' group and adds its partials to s in chunk order,
// each by a rounded FADD (the first group's first partial starts s).
template <int D>
__device__ __forceinline__ void fwd_fold_s(float (&s)[Fwd<D>::kN / 2],
                                           float (&sp)[Fwd<D>::kSGroup][Fwd<D>::kN / 2],
                                           bool first) {
  using F = Fwd<D>;
  wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < F::kSGroup; ++c) fence_regs<F::kN / 2>(sp[c]);
#pragma unroll
  for (int j = 0; j < F::kN / 2; ++j) {
    float x = first ? sp[0][j] : __fadd_rn(s[j], sp[0][j]);
#pragma unroll
    for (int c = 1; c < F::kSGroup; ++c) x = __fadd_rn(x, sp[c][j]);
    s[j] = x;
  }
}

// P.V's partial over keys 32 kc .. 32 kc + kPVK - 1 for the warpgroup's O
// columns: A = P's fragments, B = V^T's rows of those columns at shared
// addresses v_hi, v_lo; one commit group.
template <int D>
__device__ __forceinline__ void fwd_issue_pv(float (&part)[Fwd<D>::kCols / 2],
                                             const uint32_t (&ph)[Fwd<D>::kPVK / 8][4],
                                             const uint32_t (&pl)[Fwd<D>::kPVK / 8][4],
                                             uint32_t v_hi, uint32_t v_lo, int kc) {
  using F = Fwd<D>;
  const uint64_t dvh = make_desc(v_hi, 16, 8 * F::kVW * 4, F::kVLayout);
  const uint64_t dvl = make_desc(v_lo, 16, 8 * F::kVW * 4, F::kVLayout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < F::kPVK / 8; ++kk) {  // keys 32 kc + 8 kk .. + 7
    const uint64_t vo = (kc * D * F::kVW * 4 + kk * 32) >> 4;
    if (kk == 0) wgmma_tf32_rs<F::kCols, false>(part, pl[kk], dvh + vo);
    else wgmma_tf32_rs<F::kCols, true>(part, pl[kk], dvh + vo);
    wgmma_tf32_rs<F::kCols, true>(part, ph[kk], dvl + vo);
    wgmma_tf32_rs<F::kCols, true>(part, ph[kk], dvh + vo);
  }
  wgmma_commit();
}

// Chunk i (0-3) of thread me's four chunks of a sub-tile's K: hi and lo
// from the raw chunk, at the same offsets (at D = 256 in place: hi over the
// raw value).
template <int D>
__device__ __forceinline__ void fwd_split_k(uint8_t* sm, int me, int i) {
  using F = Fwd<D>;
  constexpr int kC = D / 4;
  const int c = me + i * F::kThreads, off = kmaj_off<F::kN>(c / kC, c % kC);
  float4 hi, lo;
  split4(*reinterpret_cast<const float4*>(sm + F::kRawK + off), hi, lo);
  *reinterpret_cast<float4*>(sm + F::kKHi + off) = hi;
  *reinterpret_cast<float4*>(sm + F::kKLo + off) = lo;
}

// Thread me's V unit (keys 8 (cc / 2) + 2 e + cc % 2, e = 0..3, by columns
// 4 ch .. 4 ch + 3; cc = me % (N / 4), ch = me / (N / 4)) from raw V.
template <int D>
__device__ __forceinline__ void fwd_load_vx(const uint8_t* sm, int me, float4 (&x)[4]) {
  using F = Fwd<D>;
  const int cc = me % (F::kN / 4), ch = me / (F::kN / 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kap = 8 * (cc >> 1) + 2 * e + (cc & 1);
    x[e] = *reinterpret_cast<const float4*>(sm + F::kRawV + rawv_off<D>(kap, ch));
  }
}

// Row 4 ch + j of V^T from the unit, transposed in registers: its hi and lo
// written as whole chunks.
template <int D>
__device__ __forceinline__ void fwd_split_v(uint8_t* sm, int me, const float4 (&x)[4], int j) {
  using F = Fwd<D>;
  const int cc = me % (F::kN / 4), ch = me / (F::kN / 4);
  const int off = vt_off<D, F::kVW>(cc >> 3, 4 * ch + j, cc & 7);
  float4 hi, lo;
  split4(make_float4(at(x[0], j), at(x[1], j), at(x[2], j), at(x[3], j)), hi, lo);
  *reinterpret_cast<float4*>(sm + F::kVHi + off) = hi;
  *reinterpret_cast<float4*>(sm + F::kVLo + off) = lo;
}

// Grid (heads, batch, query blocks of kRows); two warpgroups, no producer:
// every thread copies (cp.async) and splits its own chunks of each tile, so
// a copy needs no barrier before its split. Accumulator layout of an m64nN
// product, warp w of a warpgroup, g = lane / 4, t = lane % 4: d[4i + 0, 1]
// at row 16w + g, columns 8i + 2t, +1; d[4i + 2, 3] at row 16w + g + 8.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ o, float* __restrict__ lse, int sq, int skv, int heads,
                     int kv_heads, int causal, float scale) {
  using F = Fwd<D>;
  constexpr int N = F::kN, T = F::kThreads, kC = D / 4;  // kC: 16-byte chunks a row
  static_assert(T == kThreads, "mark_bits walks the tiles kThreads at a time");
  extern __shared__ __align__(16) uint8_t fwd_smem[];
  uint8_t* sm = fwd_smem + ((1024u - (smem_addr(fwd_smem) & 1023u)) & 1023u);
  const uint32_t sb = smem_addr(sm);
  int* kid = reinterpret_cast<int*>(sm + F::kIds);
  int* range = reinterpret_cast<int*>(sm + F::kRange);
  uint32_t* vis = reinterpret_cast<uint32_t*>(sm + F::kVis);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * F::kRows;  // longest causal rows first
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x, g = (tid & 31) >> 2, t = tid & 3;
  // Warp-uniform to the compiler (broadcast from lane 0), as is all that
  // decides whether a warpgroup issues wgmmas.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // this thread's warpgroup
  const int wq0 = F::kDSplit ? q0 : q0 + 64 * wg;          // its first row
  const int w_last = min(sq, wq0 + 64) - 1;                // its last real row (< wq0: none)
  const int row0 = wq0 + 16 * ((tid >> 5) & 3) + g, row1 = row0 + 8;
  const int col0 = F::kDSplit ? wg * F::kCols : 0;         // its first column of O
  const int* ids = seg != nullptr ? seg + (long)b * skv : nullptr;  // Sq == Skv
  const int q_last = min(sq, q0 + F::kRows) - 1;
  const int n64 = (skv + kB - 1) / kB;
  const long q_stride = (long)heads * D, kv_stride = (long)kv_heads * D;
  const float* qb = q + (long)b * sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const float* vb = v + (long)b * skv * kv_stride + (long)kh * D;

  // Q's copy first (raw, into Q hi's layout): its latency runs beside the
  // marking. It joins the first cp.async group, with the first K.
#pragma unroll 4
  for (int i = 0; i < F::kRows * kC / T; ++i) {
    const int c = tid + i * T, r = c / kC, ch = c % kC;
    const bool ok = q0 + r < sq;
    cp_async16(sm + F::kQHi + kmaj_off<F::kRows>(r, ch),
               ok ? qb + (long)(q0 + r) * q_stride + 4 * ch : qb, ok);
  }
  if (ids != nullptr) id_range(ids, q0, q_last + 1, range);
  __syncthreads();
  mark_bits(vis, n64, kB, skv, ids, range, true, causal, q_last);
  const int rid0 = ids != nullptr ? ids[min(row0, sq - 1)] : 0;
  const int rid1 = ids != nullptr ? ids[min(row1, sq - 1)] : 0;
  __syncthreads();

  // The first sub-tile after u (u >= -1; none after -2) that the block
  // visits, or -1: the rest of u's 64-key tile, then the next marked one;
  // when causal, none that starts past the block's last row (no pair of it
  // is admitted, and the walk goes up the keys). Broadcast from lane 0, so
  // the compiler sees it warp-uniform.
  auto next_sub = [&](int u) {
    int w = -1;
    if (u >= 0 && (u + 1) % F::kSub != 0 && (u + 1) * N < skv) {
      w = u + 1;
    } else if (u >= -1) {
      const int tile = next_bit(vis, u < 0 ? -1 : u / F::kSub, n64);
      w = tile < n64 ? tile * F::kSub : -1;
    }
    if (causal && w * N > q_last) w = -1;
    return __shfl_sync(0xffffffffu, w, 0);
  };
  // This thread's chunks of sub-tile u's K (raw, in K hi's layout) and, by
  // the first N threads, its key ids into slot `slot`. No branch: for u < 0
  // (no such sub-tile) every copy zero-fills and nothing reads it.
  auto load_k = [&](int u, int slot) {
    const int me = opaque(tid), k0 = max(u, 0) * N;
#pragma unroll
    for (int i = 0; i < N * kC / T; ++i) {
      const int c = me + i * T, r = c / kC, ch = c % kC;
      const bool ok = u >= 0 && k0 + r < skv;
      cp_async16(sm + F::kRawK + kmaj_off<N>(r, ch),
                 ok ? kb + (long)(k0 + r) * kv_stride + 4 * ch : kb, ok);
    }
    const int p = k0 + me % N;
    cp_async4_if(kid + slot * N + me % N, ids + min(p, skv - 1), u >= 0 && p < skv,
                 ids != nullptr && me < N);
  };
  // A V unit: keys 8 (cc / 2) + 2 e + cc % 2 (e = 0..3) by columns 4 ch ..
  // 4 ch + 3; the lane's low three bits are cc % 8, its chunk of V^T.
  auto load_v = [&](int u) {
    const int me = opaque(tid), k0 = max(u, 0) * N;
#pragma unroll
    for (int i = 0; i < N * D / 16 / T; ++i) {
      const int unit = me + i * T, cc = unit % (N / 4), ch = unit / (N / 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kap = 8 * (cc >> 1) + 2 * e + (cc & 1);
        const bool ok = u >= 0 && k0 + kap < skv;
        cp_async16(sm + F::kRawV + rawv_off<D>(kap, ch),
                   ok ? vb + (long)(k0 + kap) * kv_stride + 4 * ch : vb, ok);
      }
    }
  };
  // K and V of the first sub-tile; then Q scaled and split in place (hi
  // over x, lo beside) and K split. cp.async groups from here on, in order:
  // [Q, K], [V]; then at D = 64, 128 the next sub-tile's K goes in flight,
  // [K next].
  int cur = next_sub(-1);
  int nxt = next_sub(cur < 0 ? -2 : cur);
  if (cur >= 0) load_k(cur, 0);
  cp_commit();
  if (cur >= 0) load_v(cur);
  cp_commit();
  cp_wait<1>();
#pragma unroll 4
  for (int i = 0; i < F::kRows * kC / T; ++i) {
    const int c = tid + i * T, off = kmaj_off<F::kRows>(c / kC, c % kC);
    float4 x = *reinterpret_cast<const float4*>(sm + F::kQHi + off), hi, lo;
    x.x *= scale;  // q * scale in f32, as the reference scales q before its products
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    split4(x, hi, lo);
    *reinterpret_cast<float4*>(sm + F::kQHi + off) = hi;
    *reinterpret_cast<float4*>(sm + F::kQLo + off) = lo;
  }
  if (cur >= 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fwd_split_k<D>(sm, tid, i);
  }
  if (!F::kDSplit) {
    if (nxt >= 0) load_k(nxt, 1);
    cp_commit();
  }
  fence_async();
  __syncthreads();

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[F::kCols / 2];  // this warpgroup's O columns
#pragma unroll
  for (int j = 0; j < F::kCols / 2; ++j) acc[j] = 0.f;

  for (int it = 0; cur >= 0; ++it) {
    const int nn = next_sub(nxt < 0 ? -2 : nxt);
    const int k0 = cur * N;
    // The warpgroup's own test: a sub-tile past its last row holds no pair
    // the causal mask admits, so skipping it changes no sum. At D = 256 both
    // warpgroups hold the block's rows, which the walk already stops at, so
    // every sub-tile is visited: a constant, so no branch on it sits between
    // the barrier before the softmax and the wgmmas (ptxas serialized them).
    const bool visit =
        F::kDSplit ||
        __shfl_sync(0xffffffffu, static_cast<int>(w_last >= wq0 && (!causal || k0 <= w_last)), 0);
    const int base = opaque(sb);

    // S = Q.K^T: each 32-deep chunk of d into its own partial, kSGroup of
    // them in flight; the partials added in order (at D = 256 the
    // warpgroup's half).
    float s[N / 2];
    {
      float sp[F::kSGroup][N / 2];
      // The warpgroup's Q rows (D = 64, 128) or its half of d (D = 256).
      const int qo = F::kDSplit ? wg * F::kChunks * F::kRows * 128 : wg * 64 * 128;
      const int ko = F::kDSplit ? wg * F::kChunks * N * 128 : 0;
      if (visit) fwd_issue_s<D>(sp, base + F::kQHi + qo, base + F::kQLo + qo,
                                base + F::kKHi + ko, base + F::kKLo + ko);
      // Then this sub-tile's V^T from this thread's raw V, and the next
      // sub-tile's V in flight.
      cp_wait<F::kDSplit ? 0 : 1>();
      {
        const int me = opaque(tid);
        float4 vx[4];
        fwd_load_vx<D>(sm, me, vx);
#pragma unroll
        for (int j = 0; j < 4; ++j) fwd_split_v<D>(sm, me, vx, j);
      }
      load_v(nxt);
      cp_commit();
      fence_async();
      if (visit) {
        fwd_fold_s<D>(s, sp, true);
#pragma unroll
        for (int c = F::kSGroup; c < F::kChunks; c += F::kSGroup) {
          fwd_issue_s<D>(sp, base + F::kQHi + qo + c * F::kRows * 128,
                         base + F::kQLo + qo + c * F::kRows * 128,
                         base + F::kKHi + ko + c * N * 128, base + F::kKLo + ko + c * N * 128);
          fwd_fold_s<D>(s, sp, false);
        }
      }
    }
    if constexpr (F::kDSplit) {
      // The two halves of S through shared memory, thread to its twin in
      // the other warpgroup (same rows and columns); both add them in the
      // same order, so both hold the same S.
      float* xs = reinterpret_cast<float*>(sm + F::kX) + (tid & 127) * (N / 2);
      if (visit) {
#pragma unroll
        for (int j = 0; j < N / 2; j += 4) {
          *reinterpret_cast<float4*>(xs + wg * 128 * (N / 2) + j) =
              make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
        }
      }
      __syncthreads();  // both halves written; every S of this sub-tile done, K is free
      load_k(nxt, (it + 1) & 1);  // into K hi, split in place below
      cp_commit();
      if (visit) {
#pragma unroll
        for (int j = 0; j < N / 2; j += 4) {
          const float4 x0 = *reinterpret_cast<const float4*>(xs + j);
          const float4 x1 = *reinterpret_cast<const float4*>(xs + 128 * (N / 2) + j);
          s[j] = __fadd_rn(x0.x, x1.x);
          s[j + 1] = __fadd_rn(x0.y, x1.y);
          s[j + 2] = __fadd_rn(x0.z, x1.z);
          s[j + 3] = __fadd_rn(x0.w, x1.w);
        }
      }
    }

    if (visit) {
      // Mask only where a mask can bite on this warp's 16 rows: the ragged
      // key edge, keys past its first row, or ids not all one (its rows'
      // and the sub-tile's keys').
      const int* kids = kid + (it & 1) * N;
      bool mask = k0 + N > skv || (causal && k0 + N - 1 > wq0 + 16 * ((tid >> 5) & 3));
      if (!mask && ids != nullptr) {
        const int r = __shfl_sync(0xffffffffu, rid0, 0);
        bool one = rid0 == r && rid1 == r;
#pragma unroll
        for (int c = 0; c < N; c += 32) one = one && kids[(c + (tid & 31)) % N] == r;
        mask = !__all_sync(0xffffffffu, one);
      }
      if (mask) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * i + 2 * t + (e & 1), col = k0 + c;
            float x = s[4 * i + e];
            if (col >= skv) {
              x = -INFINITY;  // not a key at all: weight exactly 0
            } else if ((causal && col > (e < 2 ? row0 : row1)) ||
                       (ids != nullptr && kids[c] != (e < 2 ? rid0 : rid1))) {
              x = kNegInf;
            }
            s[4 * i + e] = x;
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = -INFINITY;
#pragma unroll
        for (int j = 0; j < N / 2; j += 4) x = fmaxf(x, fmaxf(s[j + 2 * r], s[j + 2 * r + 1]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[r], x);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      // P = exp(S - m) in f32, in place of S; the row sums.
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        s[j] = expf(s[j] - m[(j >> 1) & 1]);
        rs[(j >> 1) & 1] += s[j];
      }
      l[0] = alpha[0] * l[0] + rs[0];
      l[1] = alpha[1] * l[1] + rs[1];
      if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row max moved (x 1 changes no bit)
#pragma unroll
        for (int j = 0; j < F::kCols / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      }
    }
    if constexpr (!F::kDSplit) {
      __syncthreads();  // V^T is whole; every S of this sub-tile is done, K is free
    }

    // O += P.V, 32 keys (all kN below 32) a partial: P's A fragments for
    // those keys (k8 step i: keys 8i .. 8i + 7, this thread's (g, 2t), (g +
    // 8, 2t) as k = t and (g, 2t + 1), (g + 8, 2t + 1) as k = t + 4), their
    // products, then the partial added. The threads split the next
    // sub-tile's K first at D = 64, 128 (it landed an iteration ago; the one
    // after it then goes in flight), so its registers are not live beside
    // the partial's; at D = 256 (its copy issued just before the softmax)
    // after the first partial's products are issued.
    auto advance_k = [&]() {
      if constexpr (F::kDSplit) {
        cp_wait<0>();
      } else {
        cp_wait<1>();
      }
      const int me = opaque(tid);
#pragma unroll
      for (int i = 0; i < 4; ++i) fwd_split_k<D>(sm, me, i);  // without a next sub-tile,
      if constexpr (!F::kDSplit) {                             // of zeros nothing reads
        load_k(nn, it & 1);
        cp_commit();
      }
      fence_async();
    };
    if constexpr (!F::kDSplit) advance_k();
    const uint32_t vrow = col0 * F::kVW * 4;  // V^T's rows of the warpgroup's columns
#pragma unroll
    for (int kc = 0; kc < N / F::kPVK; ++kc) {
      if (visit) {
        uint32_t ph[F::kPVK / 8][4], pl[F::kPVK / 8][4];
#pragma unroll
        for (int i = 0; i < F::kPVK / 8; ++i) {
          const int j = 4 * (F::kPVK / 8 * kc + i);
          split_tf32(s[j], ph[i][0], pl[i][0]);
          split_tf32(s[j + 2], ph[i][1], pl[i][1]);
          split_tf32(s[j + 1], ph[i][2], pl[i][2]);
          split_tf32(s[j + 3], ph[i][3], pl[i][3]);
        }
        float part[F::kCols / 2];
        fwd_issue_pv<D>(part, ph, pl, base + F::kVHi + vrow, base + F::kVLo + vrow, kc);
        if (F::kDSplit && kc == 0) advance_k();
        wgmma_wait_all();
        fence_regs<F::kCols / 2>(part);
#pragma unroll
        for (int i = 0; i < F::kPVK / 8; ++i) {
          fence_regs<4>(ph[i]);  // the A fragments stay live until here
          fence_regs<4>(pl[i]);
        }
#pragma unroll
        for (int j = 0; j < F::kCols / 2; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
      } else if (F::kDSplit && kc == 0) {
        advance_k();
      }
    }
    __syncthreads();  // the next K is whole; every P.V of this sub-tile is done
    cur = nxt;
    nxt = nn;
  }
  cp_wait<0>();

  // Row sums across the four threads that share a row, then normalise.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;  // a row with no weight writes 0
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  float* ob = o + (long)b * sq * q_stride + (long)h * D + col0;
#pragma unroll
  for (int i = 0; i < F::kCols / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (row0 < sq) {
      *reinterpret_cast<float2*>(ob + row0 * q_stride + c) =
          make_float2(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    }
    if (row1 < sq) {
      *reinterpret_cast<float2*>(ob + row1 * q_stride + c) =
          make_float2(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
  }
  if (t == 0 && (!F::kDSplit || wg == 0)) {
    float* lb = lse + ((long)b * heads + h) * sq;
    if (row0 < sq) lb[row0] = m[0] + logf(l[0]);
    if (row1 < sq) lb[row1] = m[1] + logf(l[1]);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, int bytes, bool& done) {
  if (!done) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  return 0;
}

bool shapes_ok(int batch, int sq, int skv, int heads, int kv_heads) {
  return batch >= 1 && sq >= 1 && skv >= 1 && kv_heads >= 1 && heads % kv_heads == 0 &&
         (sq + kB - 1) / kB <= kMaxTiles && (skv + kB - 1) / kB <= kMaxTiles;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
               int batch, int sq, int skv, int heads, int kv_heads, int causal, float scale,
               cudaStream_t stream) {
  using F = Fwd<D>;
  static bool done = false;
  if (const int err = prepare(flash_fwd_f32_kernel<D>, F::kSmemAlloc, done)) return err;
  const dim3 grid(heads, batch, (sq + F::kRows - 1) / F::kRows);
  flash_fwd_f32_kernel<D><<<grid, F::kThreads, F::kSmemAlloc, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(lse), sq, skv,
      heads, kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* seg, void* dq, int batch, int sq, int skv,
              int heads, int kv_heads, int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  constexpr int kBytes = DqSmem<D>::kBytes, kR = Bwd<D>::kR;
  if (const int err = prepare(flash_dq_f32_kernel<D>, kBytes, done)) return err;
  const dim3 grid(heads, batch, (sq + kR - 1) / kR);
  flash_dq_f32_kernel<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<float*>(dq),
      sq, skv, heads, kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// K2b-f32 with `splits` runs of `chunk` items (1 and any chunk: no split,
// dk and dv written directly), then, with runs, their sum from work.
template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* seg, void* dk, void* dv, void* work, int batch,
               int sq, int skv, int heads, int kv_heads, int causal, int splits, int chunk,
               float scale, cudaStream_t stream) {
  static bool done = false;
  constexpr int kBytes = DkvSmem<D>::kBytes, kR = Bwd<D>::kR;
  const long items = (long)(heads / kv_heads) * ((sq + kR - 1) / kR);
  if (splits == 1) {
    chunk = static_cast<int>(items);
  } else if (work == nullptr || splits < 1 || chunk < 1 || (long)chunk * (splits - 1) >= items ||
             (long)chunk * splits < items) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (const int err = prepare(flash_dkv_f32_kernel<D>, kBytes, done)) return err;
  const long n = (long)batch * skv * kv_heads * D;
  float* dko = static_cast<float*>(splits > 1 ? work : dk);
  float* dvo = splits > 1 ? static_cast<float*>(work) + splits * n : static_cast<float*>(dv);
  const dim3 grid(kv_heads * splits, batch, (skv + kR - 1) / kR);
  flash_dkv_f32_kernel<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), dko, dvo, n, sq, skv,
      heads, kv_heads, causal, splits, chunk, scale);
  if (splits == 1) return static_cast<int>(cudaGetLastError());
  if (const cudaError_t err = cudaGetLastError(); err != cudaSuccess) return static_cast<int>(err);
  const long groups = 2 * n / 4;
  flash_dkv_f32_sum_kernel<<<static_cast<unsigned>((groups + kThreads - 1) / kThreads), kThreads,
                             0, stream>>>(static_cast<const float*>(work), static_cast<float*>(dk),
                                          static_cast<float*>(dv), n, splits);
  return static_cast<int>(cudaGetLastError());
}

static_assert(Fwd<64>::kSmemAlloc <= 232448 && Fwd<128>::kSmemAlloc <= 232448 &&
                  Fwd<256>::kSmemAlloc <= 232448,
              "K1-f32 shared memory");
static_assert(DqSmem<64>::kBytes <= 232448 && DqSmem<128>::kBytes <= 232448 &&
                  DqSmem<256>::kBytes <= 232448,
              "K2a-f32 shared memory");
static_assert(DkvSmem<64>::kBytes <= 232448 && DkvSmem<128>::kBytes <= 232448 &&
                  DkvSmem<256>::kBytes <= 232448,
              "K2b-f32 shared memory");

int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* seg, void* dk, void* dv, void* work, int batch,
              int sq, int skv, int heads, int kv_heads, int head_dim, int causal, int splits,
              int chunk, float scale, void* stream) {
  if (!shapes_ok(batch, sq, skv, heads, kv_heads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, work, batch, sq, skv, heads,
                            kv_heads, causal, splits, chunk, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, work, batch, sq, skv, heads,
                             kv_heads, causal, splits, chunk, scale, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, seg, dk, dv, work, batch, sq, skv, heads,
                             kv_heads, causal, splits, chunk, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K1-f32. q (B, Sq, H, D), k/v (B, Skv, K, D) f32 contiguous and 16-byte
// aligned; seg (B, S) int32 or null (then Sq == Skv); o like q; lse (B, H,
// Sq) f32. head_dim 64, 128 or 256. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int ditl_flash_fwd_f32(const void* q, const void* k, const void* v, const void* seg,
                                  void* o, void* lse, int batch, int sq, int skv, int heads,
                                  int kv_heads, int head_dim, int causal, float scale,
                                  void* stream) {
  if (!shapes_ok(batch, sq, skv, heads, kv_heads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd<64>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal, scale, s);
    case 128:
      return launch_fwd<128>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal, scale,
                             s);
    case 256:
      return launch_fwd<256>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal, scale,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2a-f32: q, k, v, do as K1-f32's inputs (do like q), lse and delta (B, H,
// Sq) f32; dq like q.
extern "C" int ditl_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* seg, void* dq, int batch, int sq, int skv,
                                     int heads, int kv_heads, int head_dim, int causal,
                                     float scale, void* stream) {
  if (!shapes_ok(batch, sq, skv, heads, kv_heads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, seg, dq, batch, sq, skv, heads, kv_heads,
                           causal, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, seg, dq, batch, sq, skv, heads, kv_heads,
                            causal, scale, s);
    case 256:
      return launch_dq<256>(q, k, v, dout, lse, delta, seg, dq, batch, sq, skv, heads, kv_heads,
                            causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2b-f32: K2a-f32's inputs; dk, dv like k. One grid, no split.
extern "C" int ditl_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* seg, void* dk, void* dv, int batch, int sq,
                                      int skv, int heads, int kv_heads, int head_dim, int causal,
                                      float scale, void* stream) {
  return dkv_entry(q, k, v, dout, lse, delta, seg, dk, dv, nullptr, batch, sq, skv, heads,
                   kv_heads, head_dim, causal, 1, 0, scale, stream);
}

// K2b-f32 over `splits` runs of `chunk` items each (ops/flash_attention.py::
// f32_dkv_splits: chunk (splits - 1) < items <= chunk splits, items = (heads
// / kv_heads) x query tiles of f32_bwd_block(head_dim)); work (2, splits, B,
// Skv, K, D) f32, 16-byte aligned. Two launches on the stream: the runs, then
// their sum into dk and dv. Returns the first cudaGetLastError() that is not
// 0, else 0.
extern "C" int ditl_flash_bwd_dkv_split_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* seg, void* dk, void* dv, void* work,
                                            int batch, int sq, int skv, int heads, int kv_heads,
                                            int head_dim, int causal, int splits, int chunk,
                                            float scale, void* stream) {
  return dkv_entry(q, k, v, dout, lse, delta, seg, dk, dv, work, batch, sq, skv, heads, kv_heads,
                   head_dim, causal, splits, chunk, scale, stream);
}
