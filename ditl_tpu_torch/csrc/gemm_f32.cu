// Backward of the fused-gate|up SwiGLU MLP block (K5a-f32, K5b-f32) and of
// a dense projection (K6-f32) on float32 operands for Hopper (sm_90a): f32
// in, f32-accurate products, f32 sums, f32 out.
//
// Replaces, for float32 inputs (the reference's passes take any float dtype,
// dot with preferred_element_type=float32 and write in the operands' dtype,
// a no-op cast in f32):
// - K5a ditl_tpu/ops/mlp_bwd.py::_dgu_dwdown_kernel (:102, pallas_call
//   :222): entry point ditl_mlp_bwd_dgu_dwdown_f32, dinner = g . w_down^T,
//   SwiGLU from gate/up, dgate and dup into the halves of one (N, 2F) dgu,
//   inner into an (N, F) scratch, then d_w_down = inner^T . g;
// - K5b ::_dh_dwgu_kernel (:153, :252): ditl_mlp_bwd_dh_dwgu_f32, dh =
//   dgu . w_gu^T and d_w_gu = h^T . dgu;
// - K6 ditl_tpu/ops/projection.py::_bwd_kernel (:79, :121):
//   ditl_proj_bwd_f32, dx = g . w^T and dw = x^T . g.
// The bf16 kernels (mlp_bwd.cu, projection_bwd.cu on gemm_sm90.cuh) stay as
// they are: wgmma takes .tf32 operands only K-major, and a single TF32 pass
// keeps about three decimal digits, so it is no port of an f32 dot.
//
// Bound on the card (H100 SXM: 3.35 TB/s; f32-accurate products at 165
// TFLOP/s, a third of the 495 TFLOP/s dense TF32 peak, by 3xTF32), computed
// by chip_smoke.py from its run's shapes (each input read once, each output
// written once, 4 bytes an element; 2 flops a multiply-add). On qwen2-0.5b's
// training step (N = B.S = 8192 tokens, D = 896, F = 4864):
// - K5a-f32 4.N.D.F = 142.8 GFLOP against 702 MB: 0.866 ms, operations;
// - K5b-f32 8.N.D.F = 285.6 GFLOP against 447 MB: 1.731 ms, operations;
// - K6-f32 at wq/wo (D = F = 896) 26.3 GFLOP, 94.5 MB: 0.159 ms,
//   operations; at wk/wv (F = 128) 3.76 GFLOP, 63.8 MB: 0.0228 ms.
// So all three are bound by their products. What the design does about it:
// the products run on the tensor cores as 3xTF32 (below), so the ceiling is
// 165 TFLOP/s and not FFMA's 67.
//
// One core (wg_load / wg_split / wg_tile), three kernels on it:
// - grad_pair_f32_kernel<5> (K5b-f32) and grad_pair_f32_kernel<6> (K6-f32),
//   one kernel body tagged by its user (so profiles tell them apart): one
//   grid of an activation gradient's tiles and a weight gradient's tiles;
// - mlp_dgu_f32_kernel (K5a-f32): two grids, the dinner tiles with the
//   SwiGLU epilogue, then the d_w_down tiles.
//
// Products: 3xTF32. Each f32 operand x is split into a TF32 hi and lo = x -
// hi (exact); a k8 step accumulates lo.hi, then hi.lo, then hi.hi, and drops
// lo.lo (about 2^-22 relative). Each product of two f32 values is then good
// to about 2^-21, against f32's 2^-24. The tensor cores' own f32
// accumulation truncates: a chain of 3 products a k8 step over 8192 tokens
// drifts by up to some 1e-4 of the sum (on an H100 SXM, chip_smoke.py's
// path-10 shapes: 6-7e-5 of the largest d_w_down and dh against the plain
// SGEMM). So each k-tile's 12 products accumulate from zero into a partial of
// 32 k, which is added to the running f32 sum with a rounded FADD (then
// 1.5e-6 at most).
//
// Two operand layouts. Every product here is C (M x N) = A . B contracting
// over K, and each reads its operands in one of two layouts:
// - K-major (the activation gradients dinner, dh, dx): A is (M, K) and B is
//   (N, K), rows contiguous in k (A . B^T of row-major matrices);
// - MN-major (the weight gradients d_w_down, d_w_gu, dw, contracting over
//   the N tokens): A is (K, M) and B is (K, N), rows contiguous in m or n.
// wgmma reads tf32 operands only K-major, so the split pass below transposes
// the MN-major ones; both layouts are one body, a template on the layout.
//
// Design. Output tiles of 128 x 128, k-tiles of 32.
// - Split once. Every operand element of a k-tile is split once into a
//   TF32 hi and a lo = x - hi (the rounding of flash_f32.cu's split_tf32:
//   hi by two integer operations, lo unrounded), into K-major tiles of 128
//   rows by 32 floats under the 128-byte swizzle, which wgmma reads from
//   shared memory without the threads. Both operands of a K-major role are
//   split to the same offsets; an MN-major role's are transposed by the
//   split pass (each thread a 4 x 4 block in registers; the raw tile's
//   chunks XOR-swizzled so its reads and the split tile's writes both reach
//   eight bank groups). mma.sync, which takes its operands from the
//   threads, would load and split each A value 4 times and each B value
//   twice across a tile's warps: issue slots, not the tensor cores, bound
//   that form.
// - Products. Two warpgroups, 64 rows of the 128 x 128 output tile each:
//   a k-tile is four k8 steps of three wgmma m64n128k8 (lo.hi, hi.lo,
//   hi.hi) into a partial from zero, which a rounded FADD adds to the
//   running sum: the accuracy rule above, at 32-deep chunks.
// - Overlap. Three raw stages (cp.async, each thread copying the chunks it
//   splits, so no barrier sits between a copy and its split; rows past the
//   matrix zero-filled by the copy itself) and two split sets: while k-tile
//   c's wgmmas run, the threads split k-tile c + 1 into the other set and
//   put k-tile c + 4 in flight. One barrier a k-tile. Shared memory: 3 x
//   32 KB raw + 2 x 64 KB split + 1 KB to align = 225 KB, one block an SM;
//   256 threads, no producer warp.
// - Grid. One block per output tile, or per split of one (a plain, not a
//   persistent, grid; edges at both ends of M and N masked). The two-role
//   kernel runs the role with the longer contraction per tile first
//   (blocks start in index order).
// - Split-K over the tokens for a weight gradient with few tiles: the
//   wrapper chooses the splits (ops/mlp_bwd.py); each split writes its
//   partial sums into an f32 workspace, and splitk_sum_f32_kernel adds the
//   splits in order 0, 1, ..., S-1. No atomics anywhere, so two calls give
//   the same bits.
// - What bounds it: each k-tile's wait and FADDs, when the tensor cores
//   idle until the next k-tile's products are issued; in a short
//   contraction, each block's fill and epilogue.
//
// K5b-f32: dh = dgu.w_gu^T (K-major over 2F) and d_w_gu = h^T.dgu (MN-major
// over the tokens) in one grid, d_w_gu split by f32_weight_splits.
//
// K6-f32: dx = g.w^T (K-major over F) and dw = x^T.g (MN-major over the
// tokens) in one grid, K5b-f32's two roles. dw's split is
// ops/mlp_bwd.py::f32_proj_splits, which counts the dx blocks beside it:
// the least count whose splits are no deeper than the dx blocks' work a
// 132nd share, a dx block counted as its k-tiles plus 6 for its fill and
// epilogue. On qwen2-0.5b's step: wq/wo (D = F = 896) has 448 dx tiles of
// 28 k-tiles beside dw's 49, split 3 ways (2752 tokens, 86 k-tiles); wk/wv
// (F = 128) 448 dx tiles of 4 k-tiles beside dw's 7, split 8 ways (1024
// tokens, 32 k-tiles). A dw split count timed alone on an H100 SXM at 700 W
// (chip_smoke.py --f32-mm --sweep, ms): wq/wo 1: 0.4283, 2: 0.3774, 3:
// 0.3594, 4: 0.3789, 6: 0.3690; wk/wv 8: 0.0647, 12: 0.0684, 16: 0.0725
// (16 is what fills the card with dw's blocks alone, f32_weight_splits).
//
// K5a-f32 (mlp_dgu_f32_kernel, wg_tile with the SwiGLU epilogue).
// - Two grids, one after the other on the caller's stream, from its one
//   entry point: the dinner tiles (g . w_down^T, both operands K-major over
//   D), whose epilogue computes SwiGLU and writes dgu and inner, then the
//   d_w_down tiles (inner^T . g, both MN-major over the tokens), which
//   read that inner. Stream order is the dependency; the wrapper counts one
//   launch a call. Both run wg_tile as the two-role kernel does (the
//   epilogue is a template parameter that one leaves off).
// - The SwiGLU epilogue in the wgmma accumulator layout, in the plain
//   version's order (ops/mlp_bwd.py::dgu_dwdown_plain): sg = 1 / (1 +
//   expf(-gate)), silu = gate . sg, dgate = dinner . up . (sg . (1 + gate .
//   (1 - sg))), dup = dinner . silu, inner = silu . up, each operation
//   rounded on its own (__fmul_rn and friends, so no contraction into
//   FMAs), expf and not the fast intrinsic. A thread holds rows wg 64 +
//   warp 16 + g (and + 8) and column pairs 8i + 2t, + 1, so gate and up are
//   read, and dgu and inner written, as float2s. gate and up are read in
//   place from the forward's gu: gate's row stride and up's offset from
//   gate are arguments, nothing is copied.
// - d_w_down's splits: ops/mlp_bwd.py::f32_dwdown_splits. A grid under one
//   wave splits as f32_weight_splits does; a larger one into the count up
//   to 4 that wastes least of its last wave (path 10: F = 4864 by D = 896
//   is 266 tiles, 4 splits of 2048 tokens, 1064 blocks, 9 waves of a
//   quarter the depth, 2.25 unsplit waves' time where the unsplit grid
//   takes 3), summed in order by splitk_sum_f32_kernel.
//
// ptxas -v (sm_90a): 193 registers, no spills, in each of
// grad_pair_f32_kernel<5>, grad_pair_f32_kernel<6> and mlp_dgu_f32_kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.
// Every pointer is 16-byte aligned, every row stride and every M, N (and a
// K-major K) a multiple of 4 floats: the wrappers check it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // two warpgroups, 64 rows of the output tile each
constexpr int kBM = 128;       // output tile rows
constexpr int kBN = 128;       // output tile columns
constexpr int kBK = 32;        // contraction per k-tile

// One product C (M x N) = A . B over K, and where its result goes.
struct Role {
  const float* a;
  const float* b;
  float* c;        // the output, or with splits > 1 the (splits, M, N) workspace
  long lda, ldb, ldc;
  int m, n, k;
  int tiles_n;     // column tiles
  int splits;      // contraction splits
  int k_chunk;     // contraction per split, a multiple of kBK (>= k when splits == 1)
  int tiles;       // blocks of this role: row tiles x tiles_n x splits
  // K5a's SwiGLU epilogue (K-major role only; off when gate is null): C is
  // dinner (N x F); writes dgu (N, 2F) and inner (N, F), both contiguous.
  const float* gate;
  long ld_gate;
  long up_off;     // up = gate + up_off (floats)
  float* dgu;
  float* inner;
};

struct Params {
  Role km;         // both operands K-major: A (M, K), B (N, K)
  Role mn;         // both operands MN-major: A (K, M), B (K, N)
  int mn_first;    // blocks [0, mn.tiles) are the MN-major role's
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_wait; with valid == false
// the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
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

// SwiGLU's backward at one element, in the plain version's order.
__device__ __forceinline__ void swiglu_bwd(float dinner, float gate, float up, float& dgate,
                                           float& dup, float& inner) {
  const float sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gate)));
  const float silu = __fmul_rn(gate, sg);
  const float dsilu = __fmul_rn(sg, __fadd_rn(1.0f, __fmul_rn(gate, __fsub_rn(1.0f, sg))));
  dgate = __fmul_rn(__fmul_rn(dinner, up), dsilu);
  dup = __fmul_rn(dinner, silu);
  inner = __fmul_rn(silu, up);
}

// ---------------------------------------------------------------------------
// The core: 3xTF32 on wgmma from operands split once into shared memory.
// ---------------------------------------------------------------------------

// m64n128k8 on tf32 operands, A (64 x 8) and B (128 x 8) both K-major in
// shared memory (tf32 takes no transposed operand), f32 sums d[64] a thread
// in the m64n128 accumulator layout; scale_d = 0 overwrites d.
#define DITL_TF32_SS_N128  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(a), "l"(b), "r"(scale_d))

__device__ __forceinline__ void wgmma_tf32_n128(float* d, uint64_t a, uint64_t b, int scale_d) {
  DITL_TF32_SS_N128;
}

// The wgmma helpers the core needs, as csrc/hopper.cuh has them (this
// source includes no header of the repo): a shared-memory descriptor (start
// address, leading and stride byte offsets in 16-byte units, swizzle
// mode), fence, commit, wait, and a barrier to the compiler's moving
// register reads across the asynchronous products.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
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

template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// x = hi + lo, the rounding of csrc/flash_f32.cu's split_tf32: hi is x
// rounded to the nearest TF32 value (cvt.rna's result) by two integer
// operations, lo = x - hi exact and handed over unrounded (the tensor cores
// read its top 19 bits), four floats at a time.
__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  float h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e] = __uint_as_float((__float_as_uint(v[e]) + 0x1000u) & 0xffffe000u);
    l[e] = v[e] - h[e];
  }
  hi = make_float4(h[0], h[1], h[2], h[3]);
  lo = make_float4(l[0], l[1], l[2], l[3]);
}

// The core's shared memory, bytes from a 1024-aligned base: kRawStages raw
// k-tiles of both operands (A, then B, kOpBytes each), filled by cp.async;
// then two split sets (A hi, A lo, B hi, B lo), each operand K-major, 128
// rows of 32 floats (128 bytes) under the 128-byte swizzle.
constexpr int kRawStages = 3;
constexpr int kOpBytes = kBM * kBK * 4;
constexpr int kSetOff = kRawStages * 2 * kOpBytes;
constexpr int kSmem = kSetOff + 2 * 4 * kOpBytes + 1024;  // + room to align the base
static_assert(kBM == 128 && kBN == 128 && kBK == 32, "the split layouts' tile");
static_assert(kSmem <= 232448, "shared memory per block");

// Byte offset of 16-byte chunk c (0-7) of row r of a K-major tile.
__device__ __forceinline__ int kmaj_off(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Byte offset of 16-byte chunk i (0-31) of k-row k of a raw MN-major tile
// (32 rows of 128 floats): chunk i sits at i ^ (k / 4 % 8), so the eight
// lanes that read one row in wg_split reach eight bank groups.
__device__ __forceinline__ int mn_off(int k, int i) { return k * 512 + ((i ^ ((k >> 2) & 7)) << 4); }

// This thread's chunks of k-tile [k0, k0 + kBK) of both operands into raw
// stage `raw`; contraction indices >= k_end and rows or columns past the
// matrix arrive as zeros. K-major: four chunks an operand (row c / 8, k
// chunk c % 8). MN-major: a 4 x 4 block an operand, k-rows 4 kb .. 4 kb +
// 3 by columns 4 i .. 4 i + 3 (kb = tid % 8, i = tid / 8), which
// wg_split transposes.
template <bool MN>
__device__ __forceinline__ void wg_load(uint8_t* raw, const Role& r, int m0, int n0, int k0,
                                        int k_end) {
  const int tid = threadIdx.x;
  if constexpr (!MN) {
#pragma unroll
    for (int x = 0; x < kBM * kBK / 4 / kThreads; ++x) {
      const int c = tid + x * kThreads, row = c >> 3, kc = c & 7;
      const bool kin = k0 + 4 * kc < k_end;
      const bool va = kin && m0 + row < r.m, vb = kin && n0 + row < r.n;
      const int off = kmaj_off(row, kc);
      cp_async16(raw + off, va ? r.a + (long)(m0 + row) * r.lda + k0 + 4 * kc : r.a, va);
      cp_async16(raw + kOpBytes + off, vb ? r.b + (long)(n0 + row) * r.ldb + k0 + 4 * kc : r.b,
                 vb);
    }
  } else {
    const int kb = tid & 7, i = tid >> 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * kb + e;
      const bool kin = k0 + k < k_end;
      const bool va = kin && m0 + 4 * i < r.m, vb = kin && n0 + 4 * i < r.n;
      const int off = mn_off(k, i);
      cp_async16(raw + off, va ? r.a + (long)(k0 + k) * r.lda + m0 + 4 * i : r.a, va);
      cp_async16(raw + kOpBytes + off, vb ? r.b + (long)(k0 + k) * r.ldb + n0 + 4 * i : r.b, vb);
    }
  }
}

// Splits this thread's chunks of raw stage `raw` into split set `set` (A
// hi, A lo, B hi, B lo): K-major chunks to the same offsets; MN-major 4 x 4
// blocks transposed in registers, each of their four rows (m or n) written
// as one chunk of its K-major row.
template <bool MN>
__device__ __forceinline__ void wg_split(const uint8_t* raw, uint8_t* set) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int op = 0; op < 2; ++op) {
    const uint8_t* src = raw + op * kOpBytes;
    uint8_t* hi = set + 2 * op * kOpBytes;
    uint8_t* lo = hi + kOpBytes;
    if constexpr (!MN) {
#pragma unroll
      for (int x = 0; x < kBM * kBK / 4 / kThreads; ++x) {
        const int c = tid + x * kThreads, off = kmaj_off(c >> 3, c & 7);
        float4 h, l;
        split4(*reinterpret_cast<const float4*>(src + off), h, l);
        *reinterpret_cast<float4*>(hi + off) = h;
        *reinterpret_cast<float4*>(lo + off) = l;
      }
    } else {
      const int kb = tid & 7, i = tid >> 3;
      float4 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = *reinterpret_cast<const float4*>(src + mn_off(4 * kb + e, i));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = kmaj_off(4 * i + j, kb);
        float4 h, l;
        split4(make_float4(at(v[0], j), at(v[1], j), at(v[2], j), at(v[3], j)), h, l);
        *reinterpret_cast<float4*>(hi + off) = h;
        *reinterpret_cast<float4*>(lo + off) = l;
      }
    }
  }
}

// One output tile (one split of it) of role r on the core: k-tile c's
// twelve products a warpgroup (3xTF32, four k8 steps) from split set c % 2
// run while the threads split k-tile c + 1 into the other set and put
// k-tile c + 4 in flight; each k-tile's products sum from zero into part,
// which a rounded FADD adds to acc. One barrier a k-tile.
// kSwiglu (K5a-f32's dinner tiles, K-major, one split): the epilogue
// computes SwiGLU's backward from gate and up into dgu and inner, as
// swiglu_bwd; else it stores C or a split's partial sums.
template <bool MN, bool kSwiglu>
__device__ __forceinline__ void wg_tile(const Role& r, int idx, uint8_t* sm) {
  const uint32_t sb = smem_addr(sm);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int split = idx % r.splits, rest = idx / r.splits;
  const int m0 = rest / r.tiles_n * kBM, n0 = rest % r.tiles_n * kBN;
  const int kb = split * r.k_chunk;
  const int ke = min(r.k, kb + r.k_chunk);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  float acc[64], part[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = part[j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kRawStages; ++s) {
    if (s < nk) wg_load<MN>(sm + s * 2 * kOpBytes, r, m0, n0, kb + s * kBK, ke);
    cp_commit();
  }
  cp_wait<kRawStages - 1>();
  if (nk > 0) wg_split<MN>(sm, sm + kSetOff);
  if (kRawStages < nk) wg_load<MN>(sm, r, m0, n0, kb + kRawStages * kBK, ke);
  cp_commit();
  fence_async();
  __syncthreads();

  for (int c = 0; c < nk; ++c) {
    const uint32_t set = sb + kSetOff + (c & 1) * 4 * kOpBytes;
    const uint64_t dah = make_desc(set + wg * 64 * 128, 16, 1024, 1);
    const uint64_t dal = make_desc(set + kOpBytes + wg * 64 * 128, 16, 1024, 1);
    const uint64_t dbh = make_desc(set + 2 * kOpBytes, 16, 1024, 1);
    const uint64_t dbl = make_desc(set + 3 * kOpBytes, 16, 1024, 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // k8 step kk: 32 bytes into the rows
      wgmma_tf32_n128(part, dal + 2 * kk, dbh + 2 * kk, kk > 0);
      wgmma_tf32_n128(part, dah + 2 * kk, dbl + 2 * kk, 1);
      wgmma_tf32_n128(part, dah + 2 * kk, dbh + 2 * kk, 1);
    }
    wgmma_commit();
    // k-tile c + 1 has landed (this thread's chunks); its set was last read
    // by k-tile c - 1's products, which every thread waited for before the
    // last barrier.
    cp_wait<kRawStages - 1>();
    const int slot = (c + 1) % kRawStages;
    if (c + 1 < nk) wg_split<MN>(sm + slot * 2 * kOpBytes, sm + kSetOff + ((c + 1) & 1) * 4 * kOpBytes);
    if (c + 1 + kRawStages < nk) {
      wg_load<MN>(sm + slot * 2 * kOpBytes, r, m0, n0, kb + (c + 1 + kRawStages) * kBK, ke);
    }
    cp_commit();
    fence_async();
    wgmma_wait_all();
    fence_regs<64>(part);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
    __syncthreads();
  }
  cp_wait<0>();

  // A thread holds rows wg 64 + warp 16 + g (and + 8) and columns 8 i + 2 t,
  // + 1 of the tile (acc[4 i + 2 half + e]); M and N are multiples of 4, so
  // both columns of a pair are in or out.
  if constexpr (kSwiglu) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * half;
      if (row >= r.m) continue;
      const float* grow = r.gate + (long)row * r.ld_gate;
      float* drow = r.dgu + (long)row * 2 * r.n;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = n0 + 8 * i + 2 * t;
        if (col >= r.n) continue;
        const float2 gt = *reinterpret_cast<const float2*>(grow + col);
        const float2 up = *reinterpret_cast<const float2*>(grow + r.up_off + col);
        float2 dg, du, in;
        swiglu_bwd(acc[4 * i + 2 * half], gt.x, up.x, dg.x, du.x, in.x);
        swiglu_bwd(acc[4 * i + 2 * half + 1], gt.y, up.y, dg.y, du.y, in.y);
        *reinterpret_cast<float2*>(drow + col) = dg;
        *reinterpret_cast<float2*>(drow + r.n + col) = du;
        *reinterpret_cast<float2*>(r.inner + (long)row * r.n + col) = in;
      }
    }
    return;
  }
  float* out = r.c;
  long ldc = r.ldc;
  if (r.splits > 1) {
    out += (long)split * r.m * r.n;
    ldc = r.n;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + wg * 64 + warp * 16 + g + 8 * half;
    if (row >= r.m) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = n0 + 8 * i + 2 * t;
      if (col >= r.n) continue;
      *reinterpret_cast<float2*>(out + (long)row * ldc + col) =
          make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  }
}

// K5b-f32 (kTag 5) and K6-f32 (kTag 6): one block per output tile (or split
// of one) of both roles, the role with the longer contraction per tile first
// (p.mn_first). The tag only names the instance.
template <int kTag>
__global__ void __launch_bounds__(kThreads, 1)
grad_pair_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* sm = wg_smem + ((1024u - (smem_addr(wg_smem) & 1023u)) & 1023u);
  int idx = blockIdx.x;
  bool mn;
  if (p.mn_first) {
    mn = idx < p.mn.tiles;
    if (!mn) idx -= p.mn.tiles;
  } else {
    mn = idx >= p.km.tiles;
    if (mn) idx -= p.km.tiles;
  }
  if (mn) {
    wg_tile<true, false>(p.mn, idx, sm);
  } else {
    wg_tile<false, false>(p.km, idx, sm);
  }
}

// K5a-f32: one grid of the dinner tiles (K-major, the SwiGLU epilogue), or
// one of the d_w_down tiles (MN-major, or splits of them), one block each.
__global__ void __launch_bounds__(kThreads, 1)
mlp_dgu_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* sm = wg_smem + ((1024u - (smem_addr(wg_smem) & 1023u)) & 1023u);
  if (p.mn.tiles > 0) {
    wg_tile<true, false>(p.mn, blockIdx.x, sm);
  } else {
    wg_tile<false, true>(p.km, blockIdx.x, sm);
  }
}

// out (M x N, row stride ld_out) = sum over s = 0, 1, ..., splits - 1 of
// work[s] (M x N, contiguous), four columns a thread, the splits in order.
__global__ void __launch_bounds__(kThreads) splitk_sum_f32_kernel(const float* __restrict__ work,
                                                                  float* __restrict__ out,
                                                                  long ld_out, int m, int n,
                                                                  int splits) {
  const int groups = n / 4;
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long)m * groups) return;
  const int row = (int)(i / groups), col = (int)(i % groups) * 4;
  const long plane = (long)m * n;
  const float* src = work + (long)row * n + col;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(src + s * plane);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(out + (long)row * ld_out + col) = acc;
}

Role make_role(const void* a, const void* b, void* c, long lda, long ldb, long ldc, int m, int n,
               int k, int splits, int k_chunk) {
  Role r = {};
  r.a = static_cast<const float*>(a);
  r.b = static_cast<const float*>(b);
  r.c = static_cast<float*>(c);
  r.lda = lda;
  r.ldb = ldb;
  r.ldc = ldc;
  r.m = m;
  r.n = n;
  r.k = k;
  r.tiles_n = (n + kBN - 1) / kBN;
  r.splits = splits;
  r.k_chunk = splits > 1 ? k_chunk : k;
  r.tiles = (m + kBM - 1) / kBM * r.tiles_n * splits;
  return r;
}

bool dims_ok(int m, int n, int k, int splits, int k_chunk) {
  return m >= 1 && n >= 1 && k >= 1 && m % 4 == 0 && n % 4 == 0 && splits >= 1 &&
         (splits == 1 || (k_chunk % kBK == 0 && (long)k_chunk * (splits - 1) < k &&
                          (long)k_chunk * splits >= k));
}

template <typename Kernel>
int launch_wg(Kernel kernel, bool& configured, const Params& p, cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<p.km.tiles + p.mn.tiles, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The MN-major role's splits summed into its output, when it has splits.
int finish_splits(const Role& r, void* out, long ld_out, cudaStream_t stream) {
  if (r.splits == 1) return 0;
  const long groups = (long)r.m * (r.n / 4);
  const int blocks = (int)((groups + kThreads - 1) / kThreads);
  splitk_sum_f32_kernel<<<blocks, kThreads, 0, stream>>>(r.c, static_cast<float*>(out), ld_out,
                                                         r.m, r.n, r.splits);
  return static_cast<int>(cudaGetLastError());
}

// The role with the longer contraction per tile goes first.
int mn_first(const Params& p) { return p.mn.k_chunk >= p.km.k_chunk ? 1 : 0; }

}  // namespace

// K5a-f32. g (N, D) row stride ld_g; w_down (F, D) contiguous; gate (N, F)
// row stride ld_gu with up = gate + up_off (floats), the halves of the
// forward's gu; outputs dgu (N, 2F), d_w_down (F, D) and the inner scratch
// (N, F), contiguous; work (splits, F, D) f32 when splits > 1, else unused.
// Two grids on the stream: the dinner tiles with the SwiGLU epilogue, then
// the d_w_down tiles (and the splits' sum). Returns the first
// cudaGetLastError() that is not 0, else 0.
extern "C" int ditl_mlp_bwd_dgu_dwdown_f32(const void* g, const void* w_down, const void* gate,
                                           void* dgu, void* d_w_down, void* inner, void* work,
                                           long ld_g, long ld_gu, long up_off, int n, int d,
                                           int f, int splits, int k_chunk, void* stream) {
  if (!dims_ok(n, f, d, 1, 0) || !dims_ok(f, d, n, splits, k_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  Params dinner = {};
  dinner.km = make_role(g, w_down, nullptr, ld_g, d, 0, n, f, d, 1, 0);
  dinner.km.gate = static_cast<const float*>(gate);
  dinner.km.ld_gate = ld_gu;
  dinner.km.up_off = up_off;
  dinner.km.dgu = static_cast<float*>(dgu);
  dinner.km.inner = static_cast<float*>(inner);
  if (const int err = launch_wg(mlp_dgu_f32_kernel, configured, dinner, s)) return err;
  Params dwd = {};
  dwd.mn = make_role(inner, g, splits > 1 ? work : d_w_down, f, ld_g, d, f, d, n, splits,
                     k_chunk);
  if (const int err = launch_wg(mlp_dgu_f32_kernel, configured, dwd, s)) return err;
  return finish_splits(dwd.mn, d_w_down, d, s);
}

// K5b-f32. h (N, D) row stride ld_h; dgu (N, 2F) and w_gu (D, 2F)
// contiguous; outputs dh (N, D) and d_w_gu (D, 2F) contiguous; work
// (splits, D, 2F) f32 when splits > 1. One grid (dh tiles and d_w_gu tiles),
// then the splits' sum.
extern "C" int ditl_mlp_bwd_dh_dwgu_f32(const void* h, const void* dgu, const void* w_gu,
                                        void* dh, void* d_w_gu, void* work, long ld_h, int n,
                                        int d, int f, int splits, int k_chunk, void* stream) {
  if (!dims_ok(n, d, 2 * f, 1, 0) || !dims_ok(d, 2 * f, n, splits, k_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  Params p = {};
  p.km = make_role(dgu, w_gu, dh, 2L * f, 2L * f, d, n, d, 2 * f, 1, 0);
  p.mn = make_role(h, dgu, splits > 1 ? work : d_w_gu, ld_h, 2L * f, 2L * f, d, 2 * f, n,
                   splits, k_chunk);
  p.mn_first = mn_first(p);
  if (const int err = launch_wg(grad_pair_f32_kernel<5>, configured, p, s)) return err;
  return finish_splits(p.mn, d_w_gu, 2L * f, s);
}

// K6-f32. x (N, D) row stride ld_x; w (D, F) contiguous; g (N, F) row stride
// ld_g; outputs dx (N, D) and dw (D, F) contiguous; work (splits, D, F) f32
// when splits > 1. One grid (dx tiles and dw tiles), then the splits' sum.
extern "C" int ditl_proj_bwd_f32(const void* x, const void* w, const void* g, void* dx, void* dw,
                                 void* work, long ld_x, long ld_g, int n, int d, int f,
                                 int splits, int k_chunk, void* stream) {
  if (!dims_ok(n, d, f, 1, 0) || !dims_ok(d, f, n, splits, k_chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  Params p = {};
  p.km = make_role(g, w, dx, ld_g, f, d, n, d, f, 1, 0);
  p.mn = make_role(x, g, splits > 1 ? work : dw, ld_x, ld_g, f, d, f, n, splits, k_chunk);
  p.mn_first = mn_first(p);
  if (const int err = launch_wg(grad_pair_f32_kernel<6>, configured, p, s)) return err;
  return finish_splits(p.mn, dw, f, s);
}
