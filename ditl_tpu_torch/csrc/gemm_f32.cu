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
// Products: 3xTF32 on mma.sync.m16n8k8.tf32. Each f32 operand x is split
// into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is exact);
// a k-step accumulates lo.hi, then hi.lo, then hi.hi, and drops lo.lo
// (about 2^-22 relative). Each product of two f32 values is then good to
// about 2^-21, against f32's 2^-24. The tensor cores' own f32 accumulation
// truncates: a chain of 3 MMAs a k-step over 8192 tokens (3,072 MMAs) drifts
// by up to some 1e-4 of the sum (on an H100 SXM, chip_smoke.py's path-10
// shapes: 6-7e-5 of the largest d_w_down and dh against the plain SGEMM). So
// each stage's 12 MMAs accumulate from zero into a partial of 32 k, which is
// added to the running f32 sum with a rounded FADD (then 1.5e-6 at most).
//
// One core, two operand layouts. Every product here is C (M x N) = A . B
// contracting over K, and each reads its operands in one of two layouts:
// - K-major (the activation gradients dinner, dh, dx): A is (M, K) and B is
//   (N, K), rows contiguous in k (A . B^T of row-major matrices);
// - MN-major (the weight gradients d_w_down, d_w_gu, dw, contracting over
//   the N tokens): A is (K, M) and B is (K, N), rows contiguous in m or n.
// mma.sync fragments are loaded from shared memory by 32-bit reads, so both
// layouts are one kernel body (a template on the layout) and no transpose
// stage is needed (wgmma would need one for tf32 MN-major operands).
//
// Design. Output tiles of 128 x 128, k-tiles of 32, 256 threads (8 warps as
// 2 x 4, each warp 64 x 32 of the tile: 4 x 4 m16n8 accumulators, 64 f32
// registers). A ring of 3 stages in shared memory, filled by cp.async 16
// bytes a thread, rows past the matrix zero-filled by the copy itself; tiles
// padded so a warp's fragment reads reach 32 distinct banks: K-major tiles
// 128 rows of 32 + 4 floats (bank 4g + t), MN-major tiles 32 k-rows of 128 +
// 8 floats (bank 8t + g). 3 x 36,864 = 110,592 bytes of dynamic shared
// memory, one block per SM; 64 accumulator and 64 partial registers a
// thread (ptxas for sm_90a: 207 registers, no spills, in each of the three
// kernels; the split sum 32). One block per output tile (a plain, not a
// persistent, grid); edges at both ends of M and N are masked.
// - K5b and K6 run their two roles in one grid: the role with the longer
//   contraction per tile first (blocks start in index order).
// - K5a runs two grids, one after the other on the caller's stream, from its
//   one entry point: the dinner tiles (whose epilogue computes SwiGLU and
//   writes dgu and inner), then the d_w_down tiles, which read that inner.
//   Stream order is the dependency; the wrapper counts one launch per call.
// - Split-K over the tokens for a weight gradient with few tiles (K6 at
//   wk/wv: dw is 896 x 128, seven tiles, each over 8192 tokens): the
//   wrapper chooses the splits (ops/mlp_bwd.py::f32_weight_splits); each
//   split writes its partial sums into an f32 workspace, and a second
//   kernel adds the splits in order 0, 1, ..., S-1. No atomics anywhere, so
//   two calls give the same bits.
// - SwiGLU epilogue of K5a in the plain version's order (ops/mlp_bwd.py::
//   dgu_dwdown_plain): sg = 1 / (1 + expf(-gate)), silu = gate . sg, dgate =
//   dinner . up . (sg . (1 + gate . (1 - sg))), dup = dinner . silu, inner =
//   silu . up, each operation rounded on its own (__fmul_rn and friends, so
//   no contraction into FMAs), expf and not the fast intrinsic. gate and up
//   are read in place from the forward's gu: gate's row stride and up's
//   offset from gate are arguments, nothing is copied.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.
// Every pointer is 16-byte aligned, every row stride and every M, N (and a
// K-major K) a multiple of 4 floats: the wrappers check it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;                // output tile rows
constexpr int kBN = 128;                // output tile columns
constexpr int kBK = 32;                 // contraction per stage
constexpr int kStages = 3;
constexpr int kLdK = kBK + 4;           // floats per row of a K-major tile
constexpr int kLdMN = kBM + 8;          // floats per k-row of an MN-major tile
constexpr int kTile = kBM * kLdK;       // floats per operand tile (the larger layout)
constexpr int kSmemBytes = kStages * 2 * kTile * 4;

static_assert(kBM == kBN, "one padded MN-major row width for both operands");
static_assert(kBK * kLdMN <= kTile, "an MN-major tile fits the operand slot");
static_assert(kSmemBytes <= 232448, "shared memory per block");

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

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 values (as mma operand bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-tile [k0, k0 + kBK) of both operands into a stage; contraction
// indices >= k_end and rows or columns past the matrix arrive as zeros. Each
// of the 1024 16-byte chunks of an operand tile is one thread's copy.
template <bool MN>
__device__ __forceinline__ void load_tile(float* sa, float* sb, const Role& r, int m0, int n0,
                                          int k0, int k_end) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if constexpr (!MN) {  // 128 rows of 8 chunks
      const int row = c >> 3, kc = (c & 7) * 4;
      const bool kin = k0 + kc < k_end;
      const bool va = kin && m0 + row < r.m, vb = kin && n0 + row < r.n;
      cp_async16(sa + row * kLdK + kc, va ? r.a + (long)(m0 + row) * r.lda + k0 + kc : r.a, va);
      cp_async16(sb + row * kLdK + kc, vb ? r.b + (long)(n0 + row) * r.ldb + k0 + kc : r.b, vb);
    } else {  // 32 k-rows of 32 chunks
      const int kr = c >> 5, col = (c & 31) * 4;
      const bool kin = k0 + kr < k_end;
      const bool va = kin && m0 + col < r.m, vb = kin && n0 + col < r.n;
      cp_async16(sa + kr * kLdMN + col, va ? r.a + (long)(k0 + kr) * r.lda + m0 + col : r.a, va);
      cp_async16(sb + kr * kLdMN + col, vb ? r.b + (long)(k0 + kr) * r.ldb + n0 + col : r.b, vb);
    }
  }
}

// The four k-steps of one stage on the warp's 64 x 32 of the tile, into
// acc. A
// fragment: rows g and g + 8 of an m16 tile, k t and t + 4; B fragment:
// column g of an n8 tile, k t and t + 4 (g = lane / 4, t = lane % 4).
template <bool MN>
__device__ __forceinline__ void compute_stage(const float* sa, const float* sb,
                                              float (&acc)[4][4][4], int wm, int wn, int g,
                                              int t) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r0 = wm * 64 + i * 16 + g;
      float v[4];
      if constexpr (!MN) {
        v[0] = sa[r0 * kLdK + kk + t];
        v[1] = sa[(r0 + 8) * kLdK + kk + t];
        v[2] = sa[r0 * kLdK + kk + t + 4];
        v[3] = sa[(r0 + 8) * kLdK + kk + t + 4];
      } else {
        v[0] = sa[(kk + t) * kLdMN + r0];
        v[1] = sa[(kk + t) * kLdMN + r0 + 8];
        v[2] = sa[(kk + t + 4) * kLdMN + r0];
        v[3] = sa[(kk + t + 4) * kLdMN + r0 + 8];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[i][e], al[i][e]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c0 = wn * 32 + j * 8 + g;
      float v0, v1;
      if constexpr (!MN) {
        v0 = sb[c0 * kLdK + kk + t];
        v1 = sb[c0 * kLdK + kk + t + 4];
      } else {
        v0 = sb[(kk + t) * kLdMN + c0];
        v1 = sb[(kk + t + 4) * kLdMN + c0];
      }
      split_tf32(v0, bh[j][0], bl[j][0]);
      split_tf32(v1, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(acc[i][j], al[i], bh[j]);
        mma_tf32(acc[i][j], ah[i], bl[j]);
        mma_tf32(acc[i][j], ah[i], bh[j]);
      }
    }
  }
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

// The accumulators out: C, a split's partial sums, or (K5a's dinner) SwiGLU
// into dgu and inner. A thread holds columns 2t, 2t + 1 of rows g, g + 8 of
// each m16n8 tile; M and N are multiples of 4, so both columns are in or out.
template <bool MN>
__device__ __forceinline__ void epilogue(const Role& r, const float (&acc)[4][4][4], int m0,
                                         int n0, int split, int wm, int wn, int g, int t) {
  float* c = r.c;
  long ldc = r.ldc;
  if (r.splits > 1) {
    c += (long)split * r.m * r.n;
    ldc = r.n;
  }
  const bool swiglu = !MN && r.gate != nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * half;
      if (row >= r.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        if (col >= r.n) continue;
        const float x0 = acc[i][j][2 * half], x1 = acc[i][j][2 * half + 1];
        if (swiglu) {
          const float* gp = r.gate + (long)row * r.ld_gate + col;
          const float2 gt = *reinterpret_cast<const float2*>(gp);
          const float2 up = *reinterpret_cast<const float2*>(gp + r.up_off);
          float2 dg, du, in;
          swiglu_bwd(x0, gt.x, up.x, dg.x, du.x, in.x);
          swiglu_bwd(x1, gt.y, up.y, dg.y, du.y, in.y);
          float* drow = r.dgu + (long)row * 2 * r.n;
          *reinterpret_cast<float2*>(drow + col) = dg;
          *reinterpret_cast<float2*>(drow + r.n + col) = du;
          *reinterpret_cast<float2*>(r.inner + (long)row * r.n + col) = in;
        } else {
          *reinterpret_cast<float2*>(c + (long)row * ldc + col) = make_float2(x0, x1);
        }
      }
    }
  }
}

// One output tile (one split of it) of role r: the cp.async ring over its
// contraction, then the epilogue.
template <bool MN>
__device__ __forceinline__ void run_tile(const Role& r, int idx, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int split = idx % r.splits, rest = idx / r.splits;
  const int m0 = rest / r.tiles_n * kBM, n0 = rest % r.tiles_n * kBN;
  const int kb = split * r.k_chunk;
  const int ke = min(r.k, kb + r.k_chunk);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile<MN>(smem + 2 * s * kTile, smem + (2 * s + 1) * kTile, r, m0, n0,
                              kb + s * kBK, ke);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
    // k-tile kt has landed, and every warp is done with the stage that the
    // next copy overwrites (read in iteration kt - 1).
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nx = kt + kStages - 1;
    if (nx < nk) {
      const int s = nx % kStages;
      load_tile<MN>(smem + 2 * s * kTile, smem + (2 * s + 1) * kTile, r, m0, n0,
                    kb + nx * kBK, ke);
    }
    cp_commit();
    const int s = kt % kStages;
    compute_stage<MN>(smem + 2 * s * kTile, smem + (2 * s + 1) * kTile, part, wm, wn, g, t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  epilogue<MN>(r, acc, m0, n0, split, wm, wn, g, t);
}

__device__ __forceinline__ void mm_body(const Params& p, float* smem) {
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
    run_tile<true>(p.mn, idx, smem);
  } else {
    run_tile<false>(p.km, idx, smem);
  }
}

// One body, three names, so a profile tells the kernels apart.
__global__ void __launch_bounds__(kThreads, 1)
mlp_dgu_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  mm_body(p, smem);
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_dh_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  mm_body(p, smem);
}

__global__ void __launch_bounds__(kThreads, 1)
proj_bwd_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  mm_body(p, smem);
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
int launch_mm(Kernel kernel, bool& configured, const Params& p, cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int blocks = p.km.tiles + p.mn.tiles;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(p);
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
  if (const int err = launch_mm(mlp_dgu_f32_kernel, configured, dinner, s)) return err;
  Params dwd = {};
  dwd.mn = make_role(inner, g, splits > 1 ? work : d_w_down, f, ld_g, d, f, d, n, splits,
                     k_chunk);
  dwd.mn_first = 1;
  if (const int err = launch_mm(mlp_dgu_f32_kernel, configured, dwd, s)) return err;
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
  if (const int err = launch_mm(mlp_dh_f32_kernel, configured, p, s)) return err;
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
  if (const int err = launch_mm(proj_bwd_f32_kernel, configured, p, s)) return err;
  return finish_splits(p.mn, dw, f, s);
}
