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
// K1-f32 (FFMA, as first ported): FFMA on the CUDA cores, 64 x 64 tiles
// in shared memory padded by 16 bytes a row, register-blocked 4 x 4 a
// thread (row_products, tile_products), so each shared-memory load feeds
// four FMAs; a cp.async double buffer of K/V tiles (one stage at D = 256,
// kOneStage: 221.7 KB). ptxas -v (sm_90a): 246 / 194 / 146 registers at D =
// 256 / 128 / 64, no spills.
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
// tile_schedule is this rule at F32_BLOCK (K1-f32) and f32_bwd_block(D)
// (K2a-f32, K2b-f32). A block marks the tiles it visits once, in shared
// memory (K2: a bit each), then walks them. On the training pipeline's
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

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kTLd = kB + 4;     // floats per row of a 64 x 64 tile (P, dS)
constexpr int kMaxTiles = 4096;  // tiles a block can mark: S <= 262,144
constexpr float kNegInf = -2.3819763e38f;  // ops/attention.py NEG_INF

template <int D>
struct Tile {
  static constexpr int kLd = D + 4;      // floats per padded row
  static constexpr int kSize = kB * kLd;  // floats per 64-row tile
  static constexpr int kJ = D / 64;       // float4 column groups a thread owns
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

// Rows [r0, r0 + 64) of a matrix whose rows lie row_stride floats apart
// (D floats each, from src) into a padded shared tile; rows >= n arrive as
// zeros. Each thread copies the same chunks in scale_rows below.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long row_stride,
                                          int r0, int n) {
  constexpr int kChunks = D / 4;
  static_assert(kB * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kB * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * Tile<D>::kLd + 4 * c,
               ok ? src + (long)(r0 + r) * row_stride + 4 * c : src, ok);
  }
}

// Multiplies the chunks this thread copied with load_rows by scale, once
// they have landed (cp_wait makes a thread's own copies visible to it; the
// barrier after this makes them visible to the block): q * scale in f32, as
// the reference scales q before its products.
template <int D>
__device__ __forceinline__ void scale_rows(float* tile, float scale) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int i = 0; i < kB * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    float4* p = reinterpret_cast<float4*>(tile + (idx / kChunks) * Tile<D>::kLd +
                                          4 * (idx % kChunks));
    float4 x = *p;
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *p = x;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d], d in order.
template <int D>
__device__ __forceinline__ void row_products(float (&s)[4][4], const float* a, const float* b,
                                             int ty, int tx) {
  constexpr int kLd = Tile<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][4 j + e] += sum_k t[ty + 16 i][k] * m[k][4 tx + 64 j + e], k < 64
// in order: t a 64 x 64 tile (kTLd), m a 64 x D tile (kLd).
template <int D>
__device__ __forceinline__ void tile_products(float (&acc)[4][4 * Tile<D>::kJ], const float* t,
                                              const float* m, int ty, int tx) {
  constexpr int kLd = Tile<D>::kLd, kJ = Tile<D>::kJ;
#pragma unroll 2
  for (int k = 0; k < kB; k += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const float4*>(t + (ty + 16 * i) * kTLd + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(m + (k + kk) * kLd + 4 * tx + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = at(w[i], kk);
          acc[i][4 * j + 0] = fmaf(wi, y.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(wi, y.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(wi, y.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(wi, y.w, acc[i][4 * j + 3]);
        }
      }
    }
  }
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

// Marks the streamed tiles t < n (64 positions from t * 64, real ones < len)
// that a block visits: when causal, those inside the causal limit (K1/K2a:
// key tiles starting at or before the block's last row; K2b: query tiles
// whose last row reaches the block's first key); with ids, those whose id
// range meets the block's [range[0], range[1]].
__device__ __forceinline__ void mark_tiles(unsigned char* vis, int n, int len, const int* ids,
                                           const int* range, bool kv_stream, bool causal,
                                           int limit) {
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int p0 = t * kB, p1 = min(len, p0 + kB);
    bool visit = !causal || (kv_stream ? p0 <= limit : p1 - 1 >= limit);
    if (visit && ids != nullptr) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int p = p0; p < p1; ++p) {
        lo = min(lo, ids[p]);
        hi = max(hi, ids[p]);
      }
      visit = lo <= range[1] && hi >= range[0];
    }
    vis[t] = visit;
  }
}

__device__ __forceinline__ int next_tile(const unsigned char* vis, int t, int n) {
  for (++t; t < n && !vis[t]; ++t) {
  }
  return t;
}

// D = 256: a 64-row tile is 65 KB, so K1-f32's streamed tiles are not
// double buffered: it keeps one K/V stage and loads its next tile once the
// current one is done.
template <int D>
constexpr bool kOneStage = D == 256;

// Shared memory of K1-f32, in floats, then the tile marks.
template <int D>
struct FwdSmem {  // Q, two K/V stages (D = 256: one), P, key ids of two stages, id range
  static constexpr int kQ = 0, kKV = Tile<D>::kSize;
  static constexpr int kP = kKV + (kOneStage<D> ? 2 : 4) * Tile<D>::kSize;
  static constexpr int kIds = kP + kB * kTLd, kRange = kIds + 2 * kB, kVis = kRange + 4;
  static constexpr int kBytes = kVis * 4 + kMaxTiles;
};

// ---------------------------------------------------------------------------
// K1-f32: grid (heads, batch, query tiles), o and lse.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ o, float* __restrict__ lse, int sq, int skv, int heads,
                     int kv_heads, int causal, float scale) {
  using T = Tile<D>;
  using L = FwdSmem<D>;
  constexpr int kJ = T::kJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQ;
  int* kid = reinterpret_cast<int*>(smem + L::kIds);
  int* range = reinterpret_cast<int*>(smem + L::kRange);
  unsigned char* vis = reinterpret_cast<unsigned char*>(smem + L::kVis);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;  // longest causal rows first
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* ids = seg != nullptr ? seg + (long)b * skv : nullptr;  // Sq == Skv
  const int q_last = min(sq, q0 + kB) - 1;
  const int n_kv = (skv + kB - 1) / kB;
  const long q_stride = (long)heads * D, kv_stride = (long)kv_heads * D;
  const float* qb = q + (long)b * sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const float* vb = v + (long)b * skv * kv_stride + (long)kh * D;

  if (ids != nullptr) id_range(ids, q0, q_last + 1, range);
  __syncthreads();
  mark_tiles(vis, n_kv, skv, ids, range, true, causal, q_last);
  int rid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rid[i] = ids != nullptr ? ids[min(q0 + ty + 16 * i, sq - 1)] : 0;
  __syncthreads();

  auto load_kv = [&](int t, int stage) {
    float* ks = smem + L::kKV + 2 * stage * T::kSize;
    load_rows<D>(ks, kb, kv_stride, t * kB, skv);
    load_rows<D>(ks + T::kSize, vb, kv_stride, t * kB, skv);
    if (ids != nullptr && tid < kB) {
      const int p = t * kB + tid;
      cp_async4(kid + stage * kB + tid, ids + min(p, skv - 1), p < skv);
    }
  };

  int cur = next_tile(vis, -1, n_kv);
  load_rows<D>(qs, qb, q_stride, q0, sq);
  if (cur < n_kv) load_kv(cur, 0);
  cp_commit();

  float m[4], l[4], acc[4][4 * kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kJ; ++c) acc[i][c] = 0.f;
  }
  bool first = true;
  for (int stage = 0; cur < n_kv; stage = kOneStage<D> ? 0 : stage ^ 1) {
    const int nxt = next_tile(vis, cur, n_kv);
    if (!kOneStage<D> && nxt < n_kv) {
      load_kv(nxt, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if (first) scale_rows<D>(qs, scale);
    first = false;
    __syncthreads();  // this stage's K, V and ids (and Q) are in shared memory
    const float* ks = smem + L::kKV + 2 * stage * T::kSize;
    const int* kids = kid + stage * kB;
    const int k0 = cur * kB;
    float s[4][4];
    row_products<D>(s, qs, ks, ty, tx);
    float* ps = smem + L::kP;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j];
        if (col >= skv) {
          x = -INFINITY;  // not a key at all: weight exactly 0
        } else if ((causal && col > row) || (ids != nullptr && kids[tx + 16 * j] != rid[i])) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * kTLd + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = alpha * l[i] + rs;
#pragma unroll
      for (int c = 0; c < 4 * kJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete
    tile_products<D>(acc, ps, ks + T::kSize, ty, tx);
    __syncthreads();  // this stage and P are free again
    if (kOneStage<D> && nxt < n_kv) {
      load_kv(nxt, 0);
      cp_commit();
    }
    cur = nxt;
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // a row with no weight writes 0
    float* orow = o + ((long)b * sq + row) * q_stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      *reinterpret_cast<float4*>(orow + 4 * tx + 64 * j) =
          make_float4(acc[i][4 * j] / li, acc[i][4 * j + 1] / li, acc[i][4 * j + 2] / li,
                      acc[i][4 * j + 3] / li);
    }
    if (tx == 0) lse[((long)b * heads + h) * sq + row] = m[i] + logf(li);
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
  static bool done = false;
  constexpr int kBytes = FwdSmem<D>::kBytes;
  if (const int err = prepare(flash_fwd_f32_kernel<D>, kBytes, done)) return err;
  const dim3 grid(heads, batch, (sq + kB - 1) / kB);
  flash_fwd_f32_kernel<D><<<grid, kThreads, kBytes, stream>>>(
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

static_assert(FwdSmem<256>::kBytes <= 232448, "K1-f32 shared memory at D = 256");
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
