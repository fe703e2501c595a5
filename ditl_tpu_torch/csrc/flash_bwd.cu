// FlashAttention backward for Hopper (sm_90a): two kernels, bf16 in, f32
// accumulation.
//
// Replaces:
// - K2a ditl_tpu/ops/flash_attention.py::_dq_kernel (pallas_call in
//   _bwd_impl): dq = scale * sum_kv ds . k, one pass over the keys per block
//   of query rows.
// - K2b ditl_tpu/ops/flash_attention.py::_dkv_kernel: dv = sum p^T . do and
//   dk = scale * sum ds^T . q, summed over the GQA group's query heads and the
//   query tiles, race-free: each block owns its keys (the reference's
//   (B, K, n_kv, groups * n_q) grid with the group folded into the serial
//   dimension).
// Both recompute p = exp(s - lse) from the forward's log-sum-exp, as the
// reference does, with s = scale * (q . k) in the convention K1
// (flash_fwd.cu) writes lse in: the scale is applied after the product.
// delta = rowsum(do * o) is an input (computed by PyTorch, as the reference
// computes it outside its kernels).
//
// Bound on the card at the training shape (B=4, S=2048, H=32, K=8, D=128,
// causal): K2a must read q, k, v, do, lse, delta once and write dq, 237 MB
// -> 71 us at 3.35 TB/s, against three causal products (q.k^T, do.v^T,
// ds.k), 2.06e11 FLOP -> 0.208 ms at 989 TFLOP/s bf16. K2b moves 204 MB
// (61 us) against four causal products (q.k^T, do.v^T, p^T.do, ds^T.q),
// 2.75e11 FLOP -> 0.278 ms. So both are tensor-core bound at S=2048.
//
// What this design does about it:
// - Every product runs on the tensor cores (mma.sync m16n8k16, bf16
//   operands, f32 accumulators); p, dp and ds live only in the
//   accumulator fragments of registers and are never written to memory.
// - Causal: K2a's key loop ends at the diagonal of its query block; K2b's
//   query loop starts at its key block, so no tile above the diagonal is read
//   or computed (the TPU kernels' grids visit and predicate them off).
//   Blocks are ordered so the longest loops start first.
// - K2a: one block (4 warps, 16 rows each) per 64 query rows of one head;
//   q and do stay in registers as A fragments for the whole key loop, 32-key
//   K/V tiles stream through shared memory, dq accumulates in registers.
//   32-key tiles keep s and dp to 16 registers each next to the 64 of dq.
// - K2b: one block (4 warps, 16 keys each) per 64 keys of one KV head; the
//   K/V tile stays in shared memory for the whole block and feeds the
//   A fragments of s^T = k.q^T and dp^T = v.do^T; 32-row q/do tiles of every
//   query head of the group stream through shared memory; dk and dv
//   accumulate in registers (128 f32 per thread). K/V stay in shared memory
//   rather than registers to keep the thread under 255 registers.
// - Precision: q.k^T and do.v^T take bf16 operands exactly as the reference
//   feeds them (f32 of bf16 values), so those products are exact with f32
//   sums. p and ds are rounded to bf16 to feed the second products (p^T.do,
//   ds.k, ds^T.q), which the reference computes in f32; chip_smoke.py
//   states the tolerance this costs.
// - Ragged edges (any Sq, Skv) are masked in the kernels: rows past Sq and
//   keys past Skv are zero-filled, get p = 0, and are never stored.
// A later PR makes them fast: ldmatrix/TMA loads, double buffering, wgmma.
//
// Semantics kept from the reference: masked scores are the finite
// -2.3819763e38 before exp(s - lse) (never -inf), so a fully masked row
// reproduces the reference's uniform p; pad queries (segment 0) attend pad
// keys like any other segment.
//
// ptxas (sm_90a, nvcc 12.8, -O3), no spills in any instance: K2a 230 / 160 /
// 96 registers at D = 128 / 64 / 32 (17.5 KB of static shared memory at
// D = 128), K2b 238 / 128 / 96 (52.6 KB of dynamic shared memory at D =
// 128). At D = 128 that is two blocks per SM for either kernel.
// chip_smoke.py's build phase prints these lines on every run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDqRows = 64;   // K2a: query rows per block, 16 per warp
constexpr int kDqKeys = 32;   // K2a: keys per K/V tile
constexpr int kDkvKeys = 64;  // K2b: keys per block, 16 per warp
constexpr int kDkvRows = 32;  // K2b: query rows per q/do tile
constexpr float kNegInf = -2.3819763e38f;  // ops/attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// D = A(16x16, row-major) * B(16x8, col-major) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of a product whose k index runs down the rows of a row-major
// shared tile (row stride ld) and whose n index runs along them: rows kr,
// kr+1 (b0) and kr+8, kr+9 (b1) at column n.
__device__ __forceinline__ void b_frag_rows(const uint16_t* s, int ld, int kr,
                                            int n, uint32_t& b0, uint32_t& b1) {
  b0 = (uint32_t)s[kr * ld + n] | ((uint32_t)s[(kr + 1) * ld + n] << 16);
  b1 = (uint32_t)s[(kr + 8) * ld + n] | ((uint32_t)s[(kr + 9) * ld + n] << 16);
}

// Copy `rows` rows of D bf16 from global (row stride `stride` elements,
// rows past `limit` zero-filled) into a shared tile of row stride ld.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, int ld,
                                          const uint16_t* src, long stride,
                                          int row0, int rows, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) {
      x = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(&dst[r * ld + c]) = x;
  }
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B: b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C: c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// A C fragment pair (n-tiles 2j, 2j+1) re-packs in place into the A fragment
// of k-step j: n-tile 2j gives a0/a1, n-tile 2j+1 gives a2/a3.

// ---------------------------------------------------------------------------
// K2a: dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, uint16_t* __restrict__ dq, int sq,
                    int skv, int heads, int kv_heads, int causal, float scale) {
  constexpr int kLd = D + 8;             // padded shared row, in bf16
  constexpr int kKSteps = D / 16;        // k-steps of q.k^T and do.v^T
  constexpr int kDTiles = D / 8;         // n-tiles of ds.k
  constexpr int kNTiles = kDqKeys / 8;   // n-tiles of q.k^T
  constexpr int kPSteps = kDqKeys / 16;  // k-steps of ds.k

  __shared__ __align__(16) uint16_t k_s[kDqKeys * kLd];
  __shared__ __align__(16) uint16_t v_s[kDqKeys * kLd];
  __shared__ int seg_s[kDqKeys];

  // Last query block first: under causal masking it has the most keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const long q_stride = (long)heads * D;
  const long kv_stride = (long)kv_heads * D;
  const uint16_t* qb = q + (long)b * sq * q_stride + (long)h * D;
  const uint16_t* dob = dout + (long)b * sq * q_stride + (long)h * D;
  const uint16_t* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const uint16_t* vb = v + (long)b * skv * kv_stride + (long)kh * D;

  // q and do as A fragments, in registers for the whole key loop.
  uint32_t qf[kKSteps][4], df[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = row0 < sq ? ld32(qb + row0 * q_stride + c) : 0u;
    qf[ks][1] = row1 < sq ? ld32(qb + row1 * q_stride + c) : 0u;
    qf[ks][2] = row0 < sq ? ld32(qb + row0 * q_stride + c + 8) : 0u;
    qf[ks][3] = row1 < sq ? ld32(qb + row1 * q_stride + c + 8) : 0u;
    df[ks][0] = row0 < sq ? ld32(dob + row0 * q_stride + c) : 0u;
    df[ks][1] = row1 < sq ? ld32(dob + row1 * q_stride + c) : 0u;
    df[ks][2] = row0 < sq ? ld32(dob + row0 * q_stride + c + 8) : 0u;
    df[ks][3] = row1 < sq ? ld32(dob + row1 * q_stride + c + 8) : 0u;
  }
  const float* lb = lse + ((long)b * heads + h) * sq;
  const float* db = delta + ((long)b * heads + h) * sq;
  const float lse0 = row0 < sq ? lb[row0] : 0.f;
  const float lse1 = row1 < sq ? lb[row1] : 0.f;
  const float dl0 = row0 < sq ? db[row0] : 0.f;
  const float dl1 = row1 < sq ? db[row1] : 0.f;
  int seg0 = 0, seg1 = 0;
  if (seg != nullptr) {
    seg0 = row0 < sq ? seg[(long)b * sq + row0] : 0;
    seg1 = row1 < sq ? seg[(long)b * sq + row1] : 0;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kDqRows) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kDqKeys) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(k_s, kLd, kb, kv_stride, k0, kDqKeys, skv);
    load_tile<D>(v_s, kLd, vb, kv_stride, k0, kDqKeys, skv);
    if (seg != nullptr && tid < kDqKeys) {
      seg_s[tid] = k0 + tid < skv ? seg[(long)b * skv + k0 + tid] : 0;
    }
    __syncthreads();

    // s = q k^T and dp = do v^T: 16 rows x 32 keys per warp.
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint16_t* kp = &k_s[(nt * 8 + g) * kLd + ks * 16 + 2 * t];
        mma_16816(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
        const uint16_t* vp = &v_s[(nt * 8 + g) * kLd + ks * 16 + 2 * t];
        mma_16816(dp[nt], df[ks], ld32(vp), ld32(vp + 8));
      }
    }

    // p = exp(s - lse), ds = p (dp - delta), packed to bf16 A fragments.
    uint32_t dsf[kPSteps][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (col < skv && row < sq) {
          float x = s[nt][e] * scale;
          if ((causal && col > row) ||
              (seg != nullptr && seg_s[col - k0] != (e < 2 ? seg0 : seg1))) {
            x = kNegInf;
          }
          p = exp2f((x - (e < 2 ? lse0 : lse1)) * kLog2e);
        }
        ds[e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1));
      }
      const int half = (nt & 1) * 2;
      dsf[nt >> 1][half + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][half + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dq += ds k.
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        uint32_t b0, b1;
        b_frag_rows(k_s, kLd, kk * 16 + 2 * t, dt * 8 + g, b0, b1);
        mma_16816(acc[dt], dsf[kk], b0, b1);
      }
    }
  }

  uint16_t* out = dq + (long)b * sq * q_stride + (long)h * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (row0 < sq) {
      *reinterpret_cast<uint32_t*>(out + row0 * q_stride + c) =
          pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    }
    if (row1 < sq) {
      *reinterpret_cast<uint32_t*>(out + row1 * q_stride + c) =
          pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: dk, dv
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kDkvKeys + 2 * kDkvRows) * (D + 8) * 2 + 3 * kDkvRows * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, uint16_t* __restrict__ dk,
                     uint16_t* __restrict__ dv, int sq, int skv, int heads,
                     int kv_heads, int causal, float scale) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;         // k-steps of k.q^T and v.do^T
  constexpr int kDTiles = D / 8;          // n-tiles of p^T.do and ds^T.q
  constexpr int kNTiles = kDkvRows / 8;   // n-tiles of k.q^T (queries)
  constexpr int kPSteps = kDkvRows / 16;  // k-steps of p^T.do (queries)

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* k_s = smem;                      // kDkvKeys x kLd
  uint16_t* v_s = k_s + kDkvKeys * kLd;      // kDkvKeys x kLd
  uint16_t* q_s = v_s + kDkvKeys * kLd;      // kDkvRows x kLd
  uint16_t* do_s = q_s + kDkvRows * kLd;     // kDkvRows x kLd
  float* lse_s = reinterpret_cast<float*>(do_s + kDkvRows * kLd);
  float* dl_s = lse_s + kDkvRows;
  int* seg_s = reinterpret_cast<int*>(dl_s + kDkvRows);

  const int k0 = blockIdx.x * kDkvKeys;  // first key tile has the most queries
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = heads / kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;             // this warp's keys in the tile
  const int key0 = k0 + wrow + g;         // this thread's keys: key0, key0 + 8
  const int key1 = key0 + 8;

  const long q_stride = (long)heads * D;
  const long kv_stride = (long)kv_heads * D;
  load_tile<D>(k_s, kLd, k + (long)b * skv * kv_stride + (long)kh * D, kv_stride,
               k0, kDkvKeys, skv);
  load_tile<D>(v_s, kLd, v + (long)b * skv * kv_stride + (long)kh * D, kv_stride,
               k0, kDkvKeys, skv);
  int kseg0 = 0, kseg1 = 0;
  if (seg != nullptr) {
    kseg0 = key0 < skv ? seg[(long)b * skv + key0] : 0;
    kseg1 = key1 < skv ? seg[(long)b * skv + key1] : 0;
  }

  float dkacc[kDTiles][4], dvacc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    dkacc[i][0] = dkacc[i][1] = dkacc[i][2] = dkacc[i][3] = 0.f;
    dvacc[i][0] = dvacc[i][1] = dvacc[i][2] = dvacc[i][3] = 0.f;
  }

  // Causal: queries before the tile's first key see none of its keys.
  const int q_begin = causal ? (k0 / kDkvRows) * kDkvRows : 0;
  for (int hg = 0; hg < groups; ++hg) {
    const int h = kh * groups + hg;
    const uint16_t* qb = q + (long)b * sq * q_stride + (long)h * D;
    const uint16_t* dob = dout + (long)b * sq * q_stride + (long)h * D;
    const float* lb = lse + ((long)b * heads + h) * sq;
    const float* db = delta + ((long)b * heads + h) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += kDkvRows) {
      __syncthreads();  // the previous q/do tile is consumed
      load_tile<D>(q_s, kLd, qb, q_stride, q0, kDkvRows, sq);
      load_tile<D>(do_s, kLd, dob, q_stride, q0, kDkvRows, sq);
      if (tid < kDkvRows) {
        const bool in = q0 + tid < sq;
        lse_s[tid] = in ? lb[q0 + tid] : 0.f;
        dl_s[tid] = in ? db[q0 + tid] : 0.f;
        seg_s[tid] = (in && seg != nullptr) ? seg[(long)b * sq + q0 + tid] : 0;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T: 16 keys x 32 queries per warp.
      float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int c = ks * 16 + 2 * t;
        uint32_t ka[4], va[4];
        ka[0] = ld32(&k_s[(wrow + g) * kLd + c]);
        ka[1] = ld32(&k_s[(wrow + g + 8) * kLd + c]);
        ka[2] = ld32(&k_s[(wrow + g) * kLd + c + 8]);
        ka[3] = ld32(&k_s[(wrow + g + 8) * kLd + c + 8]);
        va[0] = ld32(&v_s[(wrow + g) * kLd + c]);
        va[1] = ld32(&v_s[(wrow + g + 8) * kLd + c]);
        va[2] = ld32(&v_s[(wrow + g) * kLd + c + 8]);
        va[3] = ld32(&v_s[(wrow + g + 8) * kLd + c + 8]);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const uint16_t* qp = &q_s[(nt * 8 + g) * kLd + c];
          mma_16816(s[nt], ka, ld32(qp), ld32(qp + 8));
          const uint16_t* dp_ = &do_s[(nt * 8 + g) * kLd + c];
          mma_16816(dp[nt], va, ld32(dp_), ld32(dp_ + 8));
        }
      }

      // p^T and ds^T, packed to bf16 A fragments (rows = keys, k = queries).
      uint32_t pf[kPSteps][4], dsf[kPSteps][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key0 : key1;
          const int qc = nt * 8 + 2 * t + (e & 1);  // query within the tile
          const int col = q0 + qc;
          float pe = 0.f;
          if (col < sq && key < skv) {
            float x = s[nt][e] * scale;
            if ((causal && key > col) ||
                (seg != nullptr && seg_s[qc] != (e < 2 ? kseg0 : kseg1))) {
              x = kNegInf;
            }
            pe = exp2f((x - lse_s[qc]) * kLog2e);
          }
          p[e] = pe;
          ds[e] = pe * (dp[nt][e] - dl_s[qc]);
        }
        const int half = (nt & 1) * 2;
        pf[nt >> 1][half + 0] = pack_bf16(p[0], p[1]);
        pf[nt >> 1][half + 1] = pack_bf16(p[2], p[3]);
        dsf[nt >> 1][half + 0] = pack_bf16(ds[0], ds[1]);
        dsf[nt >> 1][half + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dv += p^T do and dk += ds^T q.
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          uint32_t b0, b1;
          b_frag_rows(do_s, kLd, kk * 16 + 2 * t, dt * 8 + g, b0, b1);
          mma_16816(dvacc[dt], pf[kk], b0, b1);
          b_frag_rows(q_s, kLd, kk * 16 + 2 * t, dt * 8 + g, b0, b1);
          mma_16816(dkacc[dt], dsf[kk], b0, b1);
        }
      }
    }
  }

  uint16_t* dkb = dk + (long)b * skv * kv_stride + (long)kh * D;
  uint16_t* dvb = dv + (long)b * skv * kv_stride + (long)kh * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (key0 < skv) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * kv_stride + c) =
          pack_bf16(dkacc[dt][0] * scale, dkacc[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key0 * kv_stride + c) =
          pack_bf16(dvacc[dt][0], dvacc[dt][1]);
    }
    if (key1 < skv) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * kv_stride + c) =
          pack_bf16(dkacc[dt][2] * scale, dkacc[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key1 * kv_stride + c) =
          pack_bf16(dvacc[dt][2], dvacc[dt][3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;
  int batch, sq, skv, heads, kv_heads, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args& a, void* dq) {
  const dim3 grid((a.sq + kDqRows - 1) / kDqRows, a.heads, a.batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seg), static_cast<uint16_t*>(dq), a.sq, a.skv,
      a.heads, a.kv_heads, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr int bytes = dkv_smem_bytes<D>();
  // Above 48 KB a block's shared memory must be granted explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.skv + kDkvKeys - 1) / kDkvKeys, a.kv_heads, a.batch);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seg), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), a.sq, a.skv, a.heads, a.kv_heads, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/do (B, Sq, H, D), k/v (B, Skv, K, D) bf16 contiguous; lse/delta
// (B, H, Sq) f32; seg (B, S) int32 or null; dq like q. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ditl_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* seg, void* dq,
                                      int batch, int sq, int skv, int heads,
                                      int kv_heads, int head_dim, int causal,
                                      float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, batch, sq, skv, heads, kv_heads,
               causal, scale, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 32: return launch_dq<32>(a, dq);
    case 64: return launch_dq<64>(a, dq);
    case 128: return launch_dq<128>(a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same inputs; dk/dv like k. Returns cudaGetLastError() after the launch.
extern "C" int ditl_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* seg, void* dk,
                                       void* dv, int batch, int sq, int skv,
                                       int heads, int kv_heads, int head_dim,
                                       int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, batch, sq, skv, heads, kv_heads,
               causal, scale, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 32: return launch_dkv<32>(a, dk, dv);
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}
