// FlashAttention forward and backward on float32 operands for Hopper
// (sm_90a): K1-f32, K2a-f32 and K2b-f32, f32 in, f32 sums, f32 out.
//
// Replaces, for float32 inputs (the reference's kernels take any float dtype
// and sum in f32; in f32 their p.astype(v.dtype) is a no-op):
// - K1 ditl_tpu/ops/flash_attention.py::_fwd_kernel (:127, pallas_call :276):
//   entry point ditl_flash_fwd_f32, o and the per-row log-sum-exp;
// - K2a ::_dq_kernel (:300, :504): ditl_flash_bwd_dq_f32, dq = scale * sum
//   ds . k;
// - K2b ::_dkv_kernel (:362, :557): ditl_flash_bwd_dkv_f32, dv = sum p^T . do
//   and dk = sum ds^T . (scale q), summed over the GQA group's query heads
//   and the query tiles inside one block, in the reference's folded order
//   (group head, then query tile): race-free, and two calls give the same
//   bits.
// The bf16 kernels (flash_fwd.cu, flash_bwd.cu) stay as they are: wgmma has
// no f32 operand, and a single pass of TF32 keeps about three decimal
// digits, so the f32 products here are FFMA on the CUDA cores.
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
//   MB (0.020 ms) against about 6 GFLOP (0.036 ms): operations.
// So these kernels are bound by their products; at FFMA's 67 TFLOP/s the
// bound is 2.5x the 3xTF32 one. What the design does about it: it does only
// the work the masks leave (tile skipping), and keeps the products'
// operands in shared memory and registers, register-blocked 4 x 4 per
// thread, so each shared-memory load feeds four FMAs.
//
// Design, the same skeleton for the three kernels. 256 threads, a 16 x 16
// grid (tx = tid % 16, ty = tid / 16). Tiles of 64 query rows by 64 keys in
// shared memory, rows padded by 16 bytes (D + 4 floats), so eight threads
// reading 16 bytes of eight consecutive rows reach 32 distinct banks.
// - Products of two tiles' rows (S = Q K^T, dP = dO V^T): thread (ty, tx)
//   owns rows ty + 16 i and columns tx + 16 j (i, j < 4), reads four float4
//   of each operand per 4 dimensions and does 64 FMAs.
// - Products of a 64 x 64 tile with a 64 x D tile (P V, dS K, P^T dO,
//   dS^T Q): thread (ty, tx) owns rows ty + 16 i and columns 4 tx + 64 j
//   (j < D / 64), so its softmax rows are the rows of its accumulators and
//   the running max rescales them in registers.
// - Streamed tiles are double-buffered by cp.async (16 bytes a copy; rows
//   past the sequence are zero-filled by the copy itself): the next tile
//   loads while the current one is computed. Shared memory at D = 128: K1
//   187 KB (Q, two K/V stages, P), K2a 220 KB (Q, dO, two K/V stages, dS),
//   K2b 220 KB (the block's K and V, two Q/dO stages with their lse, delta
//   and ids, one tile for P^T then dS^T); one block per SM.
// - Tile skipping, the bf16 kernels' rule at 64 x 64 tiles: a (query tile,
//   key tile) pair is visited unless causal and the key tile starts past
//   the query tile's last row, or the two tiles' segment-id ranges [min,
//   max] are disjoint (then no pair in them is admitted, for any ids).
//   ops/flash_attention.py::tile_schedule is this rule (F32_BLOCK_Q,
//   F32_BLOCK_KV). A block marks the tiles it visits once, in shared
//   memory, then walks them. On the training pipeline's packed rows the
//   attended pairs are about a fifth of the causal ones.
// - Blocks with the longest loops start first: K1 and K2a walk the query
//   tiles from the last, K2b the key tiles from the first.
//
// Head dims 64, 128 and 256. At D = 256 a 64-row tile is 65 KB (rows of
// 260 floats), so the double buffers do not fit (K1-f32: 333 KB; K2a-f32
// and K2b-f32: 399 KB) and the streamed tiles go one at a time
// (kOneStage): K1-f32 keeps one K/V stage and loads the next tile once the
// current one is done (221.7 KB); K2a-f32 streams each key tile's V, then
// its K, through one buffer (dP = dO.V^T first, then S = Q.K^T and dQ +=
// dS.K over K; 221.7 KB with Q and dO); K2b-f32 streams each item's Q, dO
// and Q again through one buffer (S^T and P^T over Q, dP^T, dS^T and dV +=
// P^T.dO over dO, dK += dS^T.Q over Q scaled again; 222.7 KB with K and V).
// Every load waits for the block to finish with the tile before it, and
// K2b-f32 loads three tiles an item: right first, slow (PERF.md §6). The
// accumulators double (4 x 16 floats a gradient a thread). ptxas -v
// (sm_90a): 246 / 194 / 146 registers for K1-f32 at D = 256 / 128 / 64, no
// spills; K2a-f32 255 (24 bytes spilled) / 242 / 168; K2b-f32 255 (204
// bytes spilled) / 222 / 168.
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

// D = 256: a 64-row tile is 65 KB, so the streamed tiles are not double
// buffered. K1-f32 keeps one K/V stage (its next tile loads once the
// current one is done); K2a-f32 and K2b-f32 stream one tile at a time
// through a single buffer (see their kernels).
template <int D>
constexpr bool kOneStage = D == 256;

// Shared memory of each kernel, in floats, then the tile marks.
template <int D>
struct FwdSmem {  // Q, two K/V stages (D = 256: one), P, key ids of two stages, id range
  static constexpr int kQ = 0, kKV = Tile<D>::kSize;
  static constexpr int kP = kKV + (kOneStage<D> ? 2 : 4) * Tile<D>::kSize;
  static constexpr int kIds = kP + kB * kTLd, kRange = kIds + 2 * kB, kVis = kRange + 4;
  static constexpr int kBytes = kVis * 4 + kMaxTiles;
};

template <int D>
struct DqSmem {  // Q, dO, two K/V stages (D = 256: one tile, V then K), dS, key ids, id range
  static constexpr int kQ = 0, kDo = Tile<D>::kSize, kKV = 2 * Tile<D>::kSize;
  static constexpr int kT = kKV + (kOneStage<D> ? 1 : 4) * Tile<D>::kSize;
  static constexpr int kIds = kT + kB * kTLd, kRange = kIds + 2 * kB, kVis = kRange + 4;
  static constexpr int kBytes = kVis * 4 + kMaxTiles;
};

template <int D>
struct DkvSmem {  // K, V, two Q/dO stages (D = 256: one tile, Q, dO, Q), P^T / dS^T,
                  // (lse, delta, ids) x 2, id range
  static constexpr int kK = 0, kV = Tile<D>::kSize, kQdo = 2 * Tile<D>::kSize;
  static constexpr int kT = kQdo + (kOneStage<D> ? 1 : 4) * Tile<D>::kSize;
  static constexpr int kStats = kT + kB * kTLd, kRange = kStats + 2 * 3 * kB;
  static constexpr int kVis = kRange + 4;
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
// K2a-f32: grid (heads, batch, query tiles), dq.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, float* __restrict__ dq, int sq, int skv,
                    int heads, int kv_heads, int causal, float scale) {
  using T = Tile<D>;
  using L = DqSmem<D>;
  constexpr int kJ = T::kJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQ;
  float* dos = smem + L::kDo;
  float* ts = smem + L::kT;
  int* kid = reinterpret_cast<int*>(smem + L::kIds);
  int* range = reinterpret_cast<int*>(smem + L::kRange);
  unsigned char* vis = reinterpret_cast<unsigned char*>(smem + L::kVis);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* ids = seg != nullptr ? seg + (long)b * skv : nullptr;
  const int q_last = min(sq, q0 + kB) - 1;
  const int n_kv = (skv + kB - 1) / kB;
  const long q_stride = (long)heads * D, kv_stride = (long)kv_heads * D;
  const long qoff = (long)b * sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const float* vb = v + (long)b * skv * kv_stride + (long)kh * D;
  const long stat = ((long)b * heads + h) * sq;

  if (ids != nullptr) id_range(ids, q0, q_last + 1, range);
  __syncthreads();
  mark_tiles(vis, n_kv, skv, ids, range, true, causal, q_last);
  int rid[4];
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    rid[i] = ids != nullptr ? ids[min(row, sq - 1)] : 0;
    lse_r[i] = row < sq ? lse[stat + row] : INFINITY;  // rows past Sq: p = 0
    delta_r[i] = row < sq ? delta[stat + row] : 0.f;
  }
  __syncthreads();

  auto load_ids = [&](int t, int stage) {
    if (ids != nullptr && tid < kB) {
      const int p = t * kB + tid;
      cp_async4(kid + stage * kB + tid, ids + min(p, skv - 1), p < skv);
    }
  };
  auto load_kv = [&](int t, int stage) {
    float* ks = smem + L::kKV + 2 * stage * T::kSize;
    load_rows<D>(ks, kb, kv_stride, t * kB, skv);
    load_rows<D>(ks + T::kSize, vb, kv_stride, t * kB, skv);
    load_ids(t, stage);
  };
  // dS = P (dP - delta) of key tile k0 into the dS tile, P from the f32
  // scores s with the masks, lse and delta of this thread's rows.
  auto write_ds = [&](const float (&s)[4][4], const float (&dp)[4][4], int k0,
                      const int* kids) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j];
        if (col >= skv) {
          x = -INFINITY;
        } else if ((causal && col > row) || (ids != nullptr && kids[tx + 16 * j] != rid[i])) {
          x = kNegInf;
        }
        const float p = expf(x - lse_r[i]);
        ts[(ty + 16 * i) * kTLd + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
  };

  int cur = next_tile(vis, -1, n_kv);
  load_rows<D>(qs, q + qoff, q_stride, q0, sq);
  load_rows<D>(dos, dout + qoff, q_stride, q0, sq);
  float* buf = smem + L::kKV;  // D = 256: the one streamed tile
  if (cur < n_kv) {
    if constexpr (kOneStage<D>) {
      load_rows<D>(buf, vb, kv_stride, cur * kB, skv);
      load_ids(cur, 0);
    } else {
      load_kv(cur, 0);
    }
  }
  cp_commit();

  float acc[4][4 * kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * kJ; ++c) acc[i][c] = 0.f;
  }
  if constexpr (kOneStage<D>) {
    // Per key tile, V then K through one buffer: dP = dO.V^T once V has
    // landed, then K over it for S = Q.K^T and dQ += dS.K. Each load waits
    // for the block to finish with the tile before it.
    for (bool first = true; cur < n_kv; first = false) {
      const int nxt = next_tile(vis, cur, n_kv);
      cp_wait<0>();
      if (first) scale_rows<D>(qs, scale);
      __syncthreads();  // V, the ids (and Q, dO) are in shared memory
      float s[4][4], dp[4][4];
      row_products<D>(dp, dos, buf, ty, tx);
      __syncthreads();  // V read
      load_rows<D>(buf, kb, kv_stride, cur * kB, skv);
      cp_commit();
      cp_wait<0>();
      __syncthreads();  // K is in shared memory
      row_products<D>(s, qs, buf, ty, tx);
      write_ds(s, dp, cur * kB, kid);
      __syncthreads();  // dS complete
      tile_products<D>(acc, ts, buf, ty, tx);
      __syncthreads();  // K and dS read
      if (nxt < n_kv) {
        load_rows<D>(buf, vb, kv_stride, nxt * kB, skv);
        load_ids(nxt, 0);
        cp_commit();
      }
      cur = nxt;
    }
  }
  bool first = true;
  for (int stage = 0; !kOneStage<D> && cur < n_kv; stage ^= 1) {
    const int nxt = next_tile(vis, cur, n_kv);
    if (nxt < n_kv) {
      load_kv(nxt, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if (first) scale_rows<D>(qs, scale);
    first = false;
    __syncthreads();
    const float* ks = smem + L::kKV + 2 * stage * T::kSize;
    const int* kids = kid + stage * kB;
    const int k0 = cur * kB;
    float s[4][4], dp[4][4];
    row_products<D>(s, qs, ks, ty, tx);
    row_products<D>(dp, dos, ks + T::kSize, ty, tx);
    write_ds(s, dp, k0, kids);
    __syncthreads();  // dS complete
    tile_products<D>(acc, ts, ks, ty, tx);
    __syncthreads();
    cur = nxt;
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    float* out = dq + qoff + (long)row * q_stride;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      *reinterpret_cast<float4*>(out + 4 * tx + 64 * j) =
          make_float4(scale * acc[i][4 * j], scale * acc[i][4 * j + 1],
                      scale * acc[i][4 * j + 2], scale * acc[i][4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2b-f32: grid (KV heads, batch, key tiles), dk and dv; the block loops over
// the group's query heads, then the query tiles it visits.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, float* __restrict__ dk, float* __restrict__ dv,
                     int sq, int skv, int heads, int kv_heads, int causal, float scale) {
  using T = Tile<D>;
  using L = DkvSmem<D>;
  constexpr int kJ = T::kJ;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ts = smem + L::kT;
  int* range = reinterpret_cast<int*>(smem + L::kRange);
  unsigned char* vis = reinterpret_cast<unsigned char*>(smem + L::kVis);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kB;  // the first key blocks have the longest loops
  const int groups = heads / kv_heads;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* ids = seg != nullptr ? seg + (long)b * skv : nullptr;  // Sq == Skv
  const int k_last = min(skv, k0 + kB) - 1;
  const int n_q = (sq + kB - 1) / kB;
  const long q_stride = (long)heads * D, kv_stride = (long)kv_heads * D;
  const long kvoff = (long)b * skv * kv_stride + (long)kh * D;

  if (ids != nullptr) id_range(ids, k0, k_last + 1, range);
  __syncthreads();
  mark_tiles(vis, n_q, sq, ids, range, false, causal, k0);
  int kid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kid[i] = ids != nullptr ? ids[min(k0 + ty + 16 * i, skv - 1)] : 0;
  __syncthreads();

  // Items in the reference's folded order: group head g, then query tile.
  auto next_item = [&](int g, int t, int& ng, int& nt) {
    nt = next_tile(vis, t, n_q);
    ng = g;
    while (ng < groups && nt >= n_q) {
      ++ng;
      nt = next_tile(vis, -1, n_q);
    }
  };
  // Rows [t * 64, t * 64 + 64) of query head g of `src` (q or do) into dst.
  auto load_head_rows = [&](float* dst, const float* src, int g, int t) {
    const long qoff = (long)b * sq * q_stride + (long)(kh * groups + g) * D;
    load_rows<D>(dst, src + qoff, q_stride, t * kB, sq);
  };
  auto load_q = [&](int g, int t, int stage) {
    const int h = kh * groups + g;
    float* qs = smem + L::kQdo + 2 * stage * T::kSize;
    load_head_rows(qs, q, g, t);
    // D = 256: Q alone; dO follows in its place
    if constexpr (!kOneStage<D>) load_head_rows(qs + T::kSize, dout, g, t);
    float* st = smem + L::kStats + stage * 3 * kB;
    const long stat = ((long)b * heads + h) * sq;
    if (tid < 3 * kB) {
      const int which = tid / kB, r = tid % kB, p = t * kB + r;
      const bool ok = p < sq && (which < 2 || ids != nullptr);
      const void* src = which == 0 ? static_cast<const void*>(lse + stat + min(p, sq - 1))
                        : which == 1 ? static_cast<const void*>(delta + stat + min(p, sq - 1))
                                     : static_cast<const void*>(ids != nullptr ? ids + min(p, sq - 1)
                                                                              : nullptr);
      cp_async4(st + tid, ok ? src : lse + stat, ok);
    }
  };

  int g = 0, t = 0;
  next_item(0, -1, g, t);
  load_rows<D>(ks, k + kvoff, kv_stride, k0, skv);
  load_rows<D>(vs, v + kvoff, kv_stride, k0, skv);
  if (g < groups) load_q(g, t, 0);
  cp_commit();

  float dk_acc[4][4 * kJ], dv_acc[4][4 * kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * kJ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }
  // P^T of the item at query tile t from the f32 scores s^T, with the
  // masks and the tile's lse (st).
  auto p_of = [&](const float (&s)[4][4], float (&p)[4][4], int t, const float* st) {
    const int* rids = reinterpret_cast<const int*>(st + 2 * kB);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, row = t * kB + c;
        float x = s[i][j];
        if ((causal && key > row) || (ids != nullptr && rids[c] != kid[i])) x = kNegInf;
        p[i][j] = row < sq ? expf(x - st[c]) : 0.f;
      }
    }
  };
  // This thread's 4 x 4 block of a 64 x 64 tile into the shared tile.
  auto to_tile = [&](const float (&x)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ts[(ty + 16 * i) * kTLd + tx + 16 * j] = x[i][j];
    }
  };
  if constexpr (kOneStage<D>) {
    // Per item, Q, dO and Q again through one buffer: S^T = K.Q^T and P^T
    // once Q has landed, then dO over it for dP^T, dS^T and dV += P^T.dO,
    // then Q (scaled again) for dK += dS^T.Q. Each load waits for the block
    // to finish with the tile before it; lse, delta and ids stay for the
    // whole item.
    float* buf = smem + L::kQdo;
    const float* st = smem + L::kStats;
    while (g < groups) {
      int ng, nt;
      next_item(g, t, ng, nt);
      cp_wait<0>();
      scale_rows<D>(buf, scale);
      __syncthreads();  // Q (scaled), lse, delta and ids
      float s[4][4], dp[4][4], p[4][4], ds[4][4];
      row_products<D>(s, ks, buf, ty, tx);  // S^T: keys x queries
      p_of(s, p, t, st);
      __syncthreads();  // Q read
      load_head_rows(buf, dout, g, t);
      cp_commit();
      to_tile(p);
      cp_wait<0>();
      __syncthreads();  // dO and P^T
      row_products<D>(dp, vs, buf, ty, tx);  // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ds[i][j] = p[i][j] * (dp[i][j] - st[kB + tx + 16 * j]);
      }
      tile_products<D>(dv_acc, ts, buf, ty, tx);
      __syncthreads();  // dO and P^T read
      load_head_rows(buf, q, g, t);
      cp_commit();
      to_tile(ds);
      cp_wait<0>();
      scale_rows<D>(buf, scale);
      __syncthreads();  // Q (scaled) and dS^T
      tile_products<D>(dk_acc, ts, buf, ty, tx);
      __syncthreads();  // this item's tiles are free again
      if (ng < groups) {
        load_q(ng, nt, 0);
        cp_commit();
      }
      g = ng;
      t = nt;
    }
  }
  for (int stage = 0; !kOneStage<D> && g < groups; stage ^= 1) {
    int ng, nt;
    next_item(g, t, ng, nt);
    if (ng < groups) {
      load_q(ng, nt, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    float* qs = smem + L::kQdo + 2 * stage * T::kSize;
    const float* dos = qs + T::kSize;
    scale_rows<D>(qs, scale);
    __syncthreads();  // this stage's Q (scaled), dO, lse, delta and ids
    const float* st = smem + L::kStats + stage * 3 * kB;
    float s[4][4], dp[4][4], p[4][4];
    row_products<D>(s, ks, qs, ty, tx);   // S^T: keys x queries
    row_products<D>(dp, vs, dos, ty, tx);  // dP^T
    p_of(s, p, t, st);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[i][j] = p[i][j] * (dp[i][j] - st[kB + tx + 16 * j]);
    }
    to_tile(p);
    __syncthreads();  // P^T complete
    tile_products<D>(dv_acc, ts, dos, ty, tx);
    __syncthreads();
    to_tile(ds);
    __syncthreads();  // dS^T complete
    tile_products<D>(dk_acc, ts, qs, ty, tx);
    __syncthreads();  // this stage and the tile are free again
    g = ng;
    t = nt;
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= skv) continue;
    float* dkr = dk + kvoff + (long)key * kv_stride;
    float* dvr = dv + kvoff + (long)key * kv_stride;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      *reinterpret_cast<float4*>(dkr + 4 * tx + 64 * j) =
          make_float4(dk_acc[i][4 * j], dk_acc[i][4 * j + 1], dk_acc[i][4 * j + 2],
                      dk_acc[i][4 * j + 3]);
      *reinterpret_cast<float4*>(dvr + 4 * tx + 64 * j) =
          make_float4(dv_acc[i][4 * j], dv_acc[i][4 * j + 1], dv_acc[i][4 * j + 2],
                      dv_acc[i][4 * j + 3]);
    }
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
  constexpr int kBytes = DqSmem<D>::kBytes;
  if (const int err = prepare(flash_dq_f32_kernel<D>, kBytes, done)) return err;
  const dim3 grid(heads, batch, (sq + kB - 1) / kB);
  flash_dq_f32_kernel<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<float*>(dq),
      sq, skv, heads, kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* seg, void* dk, void* dv, int batch, int sq,
               int skv, int heads, int kv_heads, int causal, float scale,
               cudaStream_t stream) {
  static bool done = false;
  constexpr int kBytes = DkvSmem<D>::kBytes;
  if (const int err = prepare(flash_dkv_f32_kernel<D>, kBytes, done)) return err;
  const dim3 grid(kv_heads, batch, (skv + kB - 1) / kB);
  flash_dkv_f32_kernel<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<float*>(dk),
      static_cast<float*>(dv), sq, skv, heads, kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

static_assert(DqSmem<128>::kBytes <= 232448, "K2a-f32 shared memory at D = 128");
static_assert(DkvSmem<128>::kBytes <= 232448, "K2b-f32 shared memory at D = 128");
static_assert(FwdSmem<256>::kBytes <= 232448 && DqSmem<256>::kBytes <= 232448 &&
                  DkvSmem<256>::kBytes <= 232448,
              "the f32 kernels' shared memory at D = 256");

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

// K2b-f32: K2a-f32's inputs; dk, dv like k.
extern "C" int ditl_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* seg, void* dk, void* dv, int batch, int sq,
                                      int skv, int heads, int kv_heads, int head_dim, int causal,
                                      float scale, void* stream) {
  if (!shapes_ok(batch, sq, skv, heads, kv_heads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, batch, sq, skv, heads,
                            kv_heads, causal, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, batch, sq, skv, heads,
                             kv_heads, causal, scale, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, seg, dk, dv, batch, sq, skv, heads,
                             kv_heads, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
