// FlashAttention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces: ditl_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel driven by _fwd and the public flash_attention). It computes the same
// function: grouped-query attention with an online softmax, a causal mask and
// a segment-id mask, writing o and the per-row log-sum-exp.
//
// Bound on the card: at the serving prefill shape (B=4, S=512, H=32, K=8,
// D=128, causal) the kernel must move ~42 MB (q, k, v read once, o written
// once) -> 12.6 us at 3.35 TB/s, against ~8.6 GFLOP -> 8.7 us at 989 TFLOP/s
// bf16. So it sits near the ridge: bytes bound at short sequences, tensor-core
// bound as S grows (the work grows as S^2, the bytes as S).
//
// What this design does about it:
// - Every input byte is read from device memory about once per query tile:
//   each block owns 64 query rows of one head, keeps their Q fragments in
//   registers for the whole KV loop, and streams 64-key K/V tiles through
//   shared memory. The (S, S) score matrix never leaves registers.
// - Both products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
//   f32 accumulators); the softmax runs on the accumulator fragments in
//   registers, and P is re-packed to bf16 A fragments in place, as the
//   reference feeds p in v's dtype to its second product.
// - Causal: the KV loop ends at the diagonal, so no block above it is read
//   or computed (the TPU kernel's grid still visits and predicates them off).
// - GQA: query head h reads KV head h / (H / K); KV tiles are shared by the
//   group through L2.
// - Ragged edges (any Sq, Skv) are masked in the kernel: rows past Sq are
//   neither loaded nor stored, keys past Skv are zero-filled and get weight 0.
// - Shared-memory rows are padded by 8 bf16 so the fragment loads of both
//   products are free of bank conflicts.
// A later PR makes it fast: TMA loads, wgmma, a producer warp and double
// buffering of the K/V tiles.
//
// Semantics kept from the reference: the mask value is the finite
// -2.3819763e38 (never -inf, so a fully masked tile cannot give inf - inf);
// q.k is accumulated in f32 and scaled in f32; rows whose normaliser is 0
// write 0 and lse = m + log(1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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

// Fragment layouts of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B: b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C: c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const int* __restrict__ seg,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int sq,
                 int skv, int heads, int kv_heads, int causal, float scale) {
  constexpr int kLd = D + 8;           // padded shared-memory row, in bf16
  constexpr int kKSteps = D / 16;      // k-steps of Q.K^T
  constexpr int kDTiles = D / 8;       // n-tiles of P.V
  constexpr int kNTiles = kBlockN / 8; // n-tiles of Q.K^T
  constexpr int kPSteps = kBlockN / 16;
  constexpr int kChunksPerRow = D / 8; // 16-byte chunks per K/V row

  __shared__ __align__(16) uint16_t k_s[kBlockN * kLd];
  __shared__ __align__(16) uint16_t v_s[kBlockN * kLd];
  __shared__ int seg_s[kBlockN];

  const int q0 = blockIdx.x * kBlockM;
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

  const long q_stride = (long)heads * D;      // between sequence positions
  const long kv_stride = (long)kv_heads * D;
  const uint16_t* qb = q + (long)b * sq * q_stride + (long)h * D;
  const uint16_t* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const uint16_t* vb = v + (long)b * skv * kv_stride + (long)kh * D;

  // Q as A fragments, held in registers for the whole KV loop.
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = row0 < sq ? ld32(qb + row0 * q_stride + c) : 0u;
    qf[ks][1] = row1 < sq ? ld32(qb + row1 * q_stride + c) : 0u;
    qf[ks][2] = row0 < sq ? ld32(qb + row0 * q_stride + c + 8) : 0u;
    qf[ks][3] = row1 < sq ? ld32(qb + row1 * q_stride + c + 8) : 0u;
  }
  int seg0 = 0, seg1 = 0;
  if (seg != nullptr) {
    seg0 = row0 < sq ? seg[(long)b * sq + row0] : 0;
    seg1 = row1 < sq ? seg[(long)b * sq + row1] : 0;
  }

  float m[2] = {kNegInf, kNegInf};  // running row max
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  // Causal: keys past the tile's last query row contribute nothing.
  const int kv_end = causal ? min(skv, q0 + kBlockM) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockN * kChunksPerRow; i += kThreads) {
      const int r = i / kChunksPerRow;
      const int c = (i % kChunksPerRow) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = kx;
      if (k0 + r < skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (long)(k0 + r) * kv_stride + c);
        vx = *reinterpret_cast<const uint4*>(vb + (long)(k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * kLd + c]) = kx;
      *reinterpret_cast<uint4*>(&v_s[r * kLd + c]) = vx;
    }
    if (seg != nullptr && tid < kBlockN) {
      seg_s[tid] = k0 + tid < skv ? seg[(long)b * skv + k0 + tid] : 0;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint16_t* kp = &k_s[(nt * 8 + g) * kLd + ks * 16 + 2 * t];
        mma_16816(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // Scale, mask, and the tile's row max.
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= skv) {
          x = -INFINITY;  // not a key at all: weight exactly 0
        } else if ((causal && col > row) ||
                   (seg != nullptr && seg_s[col - k0] != (e < 2 ? seg0 : seg1))) {
          x = kNegInf;
        }
        s[nt][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[i], x);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
    }

    // P = exp(S - m) in f32 for the row sums, packed to bf16 A fragments.
    uint32_t pf[kPSteps][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const float p0 = exp2f((s[nt][0] - m[0]) * kLog2e);
      const float p1 = exp2f((s[nt][1] - m[0]) * kLog2e);
      const float p2 = exp2f((s[nt][2] - m[1]) * kLog2e);
      const float p3 = exp2f((s[nt][3] - m[1]) * kLog2e);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      const int half = (nt & 1) * 2;
      pf[nt >> 1][half + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][half + 1] = pack_bf16(p2, p3);
    }
    l[0] = alpha[0] * l[0] + rs[0];
    l[1] = alpha[1] * l[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V.
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int n = dt * 8 + g;
        const uint32_t b0 = (uint32_t)v_s[kr * kLd + n] |
                            ((uint32_t)v_s[(kr + 1) * kLd + n] << 16);
        const uint32_t b1 = (uint32_t)v_s[(kr + 8) * kLd + n] |
                            ((uint32_t)v_s[(kr + 9) * kLd + n] << 16);
        mma_16816(acc[dt], pf[kk], b0, b1);
      }
    }
  }

  // Row sums across the four threads that share a row, then normalise.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float l0 = l[0] == 0.f ? 1.f : l[0];
  const float l1 = l[1] == 0.f ? 1.f : l[1];
  uint16_t* ob = o + (long)b * sq * q_stride + (long)h * D;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (row0 < sq) {
      *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + c) =
          pack_bf16(acc[dt][0] / l0, acc[dt][1] / l0);
    }
    if (row1 < sq) {
      *reinterpret_cast<uint32_t*>(ob + row1 * q_stride + c) =
          pack_bf16(acc[dt][2] / l1, acc[dt][3] / l1);
    }
  }
  if (t == 0) {
    float* lb = lse + ((long)b * heads + h) * sq;
    if (row0 < sq) lb[row0] = m[0] + logf(l0);
    if (row1 < sq) lb[row1] = m[1] + logf(l1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* seg,
            void* o, void* lse, int batch, int sq, int skv, int heads,
            int kv_heads, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(seg),
      static_cast<uint16_t*>(o), static_cast<float*>(lse), sq, skv, heads,
      kv_heads, causal, scale);
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, K, D) bf16 contiguous; seg (B, S) int32 or
// null; o like q; lse (B, H, Sq) f32. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int ditl_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* seg, void* o, void* lse,
                                   int batch, int sq, int skv, int heads,
                                   int kv_heads, int head_dim, int causal,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      launch<32>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal, scale, s);
      break;
    case 64:
      launch<64>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal, scale, s);
      break;
    case 128:
      launch<128>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal, scale, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
