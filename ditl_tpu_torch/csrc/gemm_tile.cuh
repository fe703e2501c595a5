// Tile GEMM building blocks of the projection backward (projection_bwd.cu,
// K6), for Hopper (sm_90a). The MLP backward (K5a/K5b) moved to the wgmma
// core of gemm_sm90.cuh, which K6 can take up in its own redesign.
//
// One thread block (8 warps, 256 threads) computes one 128 x 128 output tile
// C with f32 accumulators in registers: each warp owns 64 rows x 32 columns,
// i.e. 4 x 4 mma.sync m16n8k16 tiles (bf16 operands, f32 sums). The
// contraction runs in k-tiles of 32 through two shared-memory stages; the
// next k-tile's global loads are issued into registers before the current
// tile's products, and stored into the other stage after them, so one
// __syncthreads per k-tile separates the stages. Fragments come out of
// shared memory through ldmatrix (x4; .trans where the operand's contraction
// axis is its strided one).
//
// Two operand layouts cover every product of K6:
// - gemm_nt: C[m][n] = sum_k A[m][k] * B[n][k], both operands row-major with
//   the contraction axis contiguous (the activation gradient: g . w^T). Rows
//   of A at or past `a_rows` read as zero; k_len is a multiple of 32.
// - gemm_tn: C[m][n] = sum_k A[k][m] * B[k][n], the contraction running down
//   the rows of both (the weight gradient: x^T . g over the tokens). Rows at
//   or past k_len (the ragged token edge) read as zero.
// M and N tile edges are multiples of 128 in every caller except the token
// axis of an activation gradient, which store_tile masks by rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ditl_gemm {

constexpr int kBM = 128;              // output tile rows
constexpr int kBN = 128;              // output tile columns
constexpr int kBK = 32;               // contraction per k-tile
constexpr int kThreads = 256;         // 8 warps: 2 along m x 4 along n
constexpr int kMT = 4;                // 16-row mma tiles per warp (64 rows)
constexpr int kNT = 4;                // 8-column mma tiles per warp (32 columns)
constexpr int kLdK = kBK + 8;         // NT stage row (k contiguous), in bf16
constexpr int kLdMN = kBM + 8;        // TN stage row (m or n contiguous), in bf16
constexpr int kStageNT = (kBM + kBN) * kLdK;
constexpr int kStageTN = 2 * kBK * kLdMN;
constexpr int kStage = kStageNT > kStageTN ? kStageNT : kStageTN;
constexpr int kSmemHalves = 2 * kStage;  // two stages: 40 KB, static

typedef float Acc[kMT][kNT][4];

__device__ __forceinline__ void zero(Acc acc) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
// Lane l receives row l/4, columns 2(l%4), 2(l%4)+1 of each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, transposed: lane l receives rows 2(l%4), 2(l%4)+1 of column l/4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 ld16(const uint16_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(uint16_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// Warp coordinates within the block tile.
struct Lane {
  int lane, g, t, wm, wn, li, lr;
  __device__ __forceinline__ Lane() {
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    lane = tid & 31;
    g = lane >> 2;
    t = lane & 3;
    wm = (warp >> 2) * (kMT * 16);
    wn = (warp & 3) * (kNT * 8);
    li = lane >> 3;
    lr = lane & 7;
  }
};

// ---------------------------------------------------------------------------
// NT: C[m][n] = sum_k A[m][k] B[n][k]
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_stage_nt(Acc acc, const uint16_t* as, const uint16_t* bs,
                                             const Lane& l) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      ldsm_x4(af[mt], &as[(l.wm + mt * 16 + l.lr + (l.li & 1) * 8) * kLdK + ks * 16 +
                          (l.li >> 1) * 8]);
    }
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, &bs[(l.wn + np * 16 + l.lr + (l.li >> 1) * 8) * kLdK + ks * 16 +
                     (l.li & 1) * 8]);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_16816(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

// a: rows m0.. of an (a_rows, k_len) operand with row stride lda; b: rows
// n0.. of an (n, k_len) operand with row stride ldb (all rows valid).
__device__ __forceinline__ void gemm_nt(Acc acc, uint16_t* smem, const uint16_t* a, long lda,
                                        int a_rows, const uint16_t* b, long ldb, int m0,
                                        int n0, int k_len) {
  const Lane l;
  const int tid = threadIdx.x;
  uint4 ra[2], rb[2];
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const int nk = k_len / kBK;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = tid + j * kThreads, row = c >> 2, col = (c & 3) * 8;
    ra[j] = m0 + row < a_rows ? ld16(a + (long)(m0 + row) * lda + col) : z;
    rb[j] = ld16(b + (long)(n0 + row) * ldb + col);
    st16(&smem[row * kLdK + col], ra[j]);
    st16(&smem[kBM * kLdK + row * kLdK + col], rb[j]);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int next = (kt + 1) * kBK;
    if (kt + 1 < nk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tid + j * kThreads, row = c >> 2, col = (c & 3) * 8;
        ra[j] = m0 + row < a_rows ? ld16(a + (long)(m0 + row) * lda + next + col) : z;
        rb[j] = ld16(b + (long)(n0 + row) * ldb + next + col);
      }
    }
    const uint16_t* cur = smem + (kt & 1) * kStage;
    mma_stage_nt(acc, cur, cur + kBM * kLdK, l);
    if (kt + 1 < nk) {
      uint16_t* nxt = smem + ((kt + 1) & 1) * kStage;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tid + j * kThreads, row = c >> 2, col = (c & 3) * 8;
        st16(&nxt[row * kLdK + col], ra[j]);
        st16(&nxt[kBM * kLdK + row * kLdK + col], rb[j]);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// TN: C[m][n] = sum_k A[k][m] B[k][n]
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_stage_tn(Acc acc, const uint16_t* as, const uint16_t* bs,
                                             const Lane& l) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      ldsm_x4_t(af[mt], &as[(ks * 16 + l.lr + (l.li >> 1) * 8) * kLdMN + l.wm + mt * 16 +
                            (l.li & 1) * 8]);
    }
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t r[4];
      ldsm_x4_t(r, &bs[(ks * 16 + l.lr + (l.li & 1) * 8) * kLdMN + l.wn + np * 16 +
                       (l.li >> 1) * 8]);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_16816(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

// a: columns m0.. of a (k_len, *) operand with row stride lda; b: columns
// n0.. of a (k_len, *) operand with row stride ldb. Rows at or past k_len
// read as zero.
__device__ __forceinline__ void gemm_tn(Acc acc, uint16_t* smem, const uint16_t* a, long lda,
                                        const uint16_t* b, long ldb, int m0, int n0,
                                        int k_len) {
  const Lane l;
  const int tid = threadIdx.x;
  uint4 ra[2], rb[2];
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const int nk = (k_len + kBK - 1) / kBK;
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * kThreads, row = c >> 4, col = (c & 15) * 8;
      const int k = k0 + row;
      if (k < k_len) {
        ra[j] = ld16(a + (long)k * lda + m0 + col);
        rb[j] = ld16(b + (long)k * ldb + n0 + col);
      } else {
        ra[j] = rb[j] = z;
      }
    }
  };
  auto store = [&](uint16_t* st) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * kThreads, row = c >> 4, col = (c & 15) * 8;
      st16(&st[row * kLdMN + col], ra[j]);
      st16(&st[kBK * kLdMN + row * kLdMN + col], rb[j]);
    }
  };
  load(0);
  store(smem);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kBK);
    const uint16_t* cur = smem + (kt & 1) * kStage;
    mma_stage_tn(acc, cur, cur + kBK * kLdMN, l);
    if (kt + 1 < nk) store(smem + ((kt + 1) & 1) * kStage);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Epilogue
// ---------------------------------------------------------------------------

// C tile (rows m0.., columns n0..) as bf16 into out (row stride ldo); rows at
// or past m_rows are not stored.
__device__ __forceinline__ void store_tile(Acc acc, uint16_t* out, long ldo, int m0,
                                           int n0, int m_rows) {
  const Lane l;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int r0 = m0 + l.wm + mt * 16 + l.g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int c = n0 + l.wn + nt * 8 + 2 * l.t;
      if (r0 < m_rows) {
        *reinterpret_cast<uint32_t*>(out + (long)r0 * ldo + c) =
            pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      }
      if (r1 < m_rows) {
        *reinterpret_cast<uint32_t*>(out + (long)r1 * ldo + c) =
            pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

// Block index -> (role A?, tile index within its role). The role with the
// longer contraction takes the low block indices, so its blocks start first.
struct Role {
  bool a;
  int tile;
  __device__ __forceinline__ Role(int tiles_a, int tiles_b, int a_first) {
    int t = blockIdx.x;
    if (a_first) {
      a = t < tiles_a;
      tile = a ? t : t - tiles_a;
    } else {
      a = t >= tiles_b;
      tile = a ? t - tiles_b : t;
    }
  }
};

}  // namespace ditl_gemm
