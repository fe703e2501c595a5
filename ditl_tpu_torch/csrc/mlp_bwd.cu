// Backward of the fused-gate|up SwiGLU MLP block for Hopper (sm_90a): two
// kernels, bf16 in, f32 accumulation, bf16 out.
//
// Replaces:
// - K5a ditl_tpu/ops/mlp_bwd.py::_dgu_dwdown_kernel (pallas_call :222):
//   dinner = g . w_down^T, SwiGLU recomputed from the forward's gate/up,
//   dgate = dinner * up * sg * (1 + gate (1 - sg)) and dup = dinner * silu
//   (rounded to bf16), and d_w_down = inner^T . g with inner =
//   bf16(silu(gate) * up).
// - K5b ::_dh_dwgu_kernel (pallas_call :252): dh = dgu . w_gu^T and
//   d_w_gu = h^T . dgu.
//
// Bound on the card at the training shape (llama3-8b: N = B*S = 8192 tokens,
// D = 4096, F = 14336): K5a reads g, w_down and gate/up once and writes dgu
// and d_w_down once, 1.24 GB -> 0.37 ms at 3.35 TB/s, against two products
// of 2*N*D*F each, 1.92e12 FLOP -> 1.945 ms at 989 TFLOP/s bf16. K5b moves
// 1.07 GB (0.32 ms) against 3.85e12 FLOP -> 3.891 ms. Both are tensor-core
// bound.
//
// What this design does about it:
// - The TPU kernels carry each weight gradient in a VMEM scratch along a
//   sequential token axis of their grid; K5b's scratch alone is (bd, 2F) f32,
//   14.7 MB. Blocks on the card run in no order and hold 227 KB of shared
//   memory. So each kernel is one __global__, launched once per call, whose
//   grid has two block roles, and each output tile belongs to exactly one
//   block (no atomics, no scratch):
//   * role A, the activation gradient: one block per (128 tokens, 128
//     columns) tile looping over the contraction (D for K5a's dinner, 2F for
//     K5b's dh);
//   * role B, the weight gradient: one block per 128 x 128 tile of d_w
//     looping over all N tokens (the token axis is the strided axis of both
//     operands, read through ldmatrix.trans).
//   The role with the longer loop takes the low block indices (K5a: role B,
//   8192 tokens against D = 4096; K5b: role A, 2F = 28672 against 8192).
// - Every product runs on the tensor cores (mma.sync m16n8k16, bf16
//   operands, f32 accumulators), through gemm_tile.cuh: 128 x 128 tiles, 8
//   warps, k-tiles of 32 in two shared stages fed by register prefetch.
// - K5a's role A epilogue recomputes SwiGLU from gate/up in f32 and writes
//   dgate and dup straight into the two halves of one (N, 2F) dgu buffer,
//   the buffer K5b reads: it takes the place of the reference's concatenate
//   (mlp_bwd.py:250).
// - K5a's role B recomputes inner = bf16(silu(gate) * up) as it stages each
//   gate/up k-tile into shared memory, once per 128-wide d-tile of d_w_down
//   (32 times at D = 4096). Writing inner to a scratch buffer instead would
//   need role A to finish first, and both roles run in one launch in no
//   order. Blocks with consecutive indices share an f-tile, so its gate/up
//   rows are re-read from L2 rather than from memory; the recompute uses the
//   fast exponent so that it costs a few instructions per element against
//   the tile's 128 products per element.
// - gate and up are the halves of the forward's gu (row stride 2F), read in
//   place; every operand takes a row stride. The ragged token edge (N a
//   multiple of 16, not of 128) is masked in the kernels: token rows past N
//   read as zero and are never stored. D and F are multiples of 128
//   (ops/mlp_bwd.py::supports).
// A later PR makes them fast: cp.async/TMA pipelines, wgmma, a persistent
// tile scheduler.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include "gemm_tile.cuh"

namespace {

using namespace ditl_gemm;

struct DguArgs {
  const uint16_t* g;       // (N, D), row stride ld_g
  const uint16_t* w_down;  // (F, D), contiguous
  const uint16_t* gate;    // (N, F), row stride ld_gu; up at gate + up_off
  uint16_t* dgu;           // (N, 2F), contiguous
  uint16_t* dwd;           // (F, D), contiguous
  long ld_g, ld_gu, up_off;
  int n, d, f, tiles_a, tiles_b, a_first;
};

__global__ void __launch_bounds__(kThreads, 2) mlp_dgu_dwdown_kernel(DguArgs p) {
  __shared__ __align__(16) uint16_t smem[kSmemHalves];
  const Role role(p.tiles_a, p.tiles_b, p.a_first);
  Acc acc;
  zero(acc);
  if (role.a) {
    // dinner tile: tokens m0.., intermediate columns n0..
    const int tiles_n = p.f / kBN;
    const int m0 = (role.tile / tiles_n) * kBM, n0 = (role.tile % tiles_n) * kBN;
    gemm_nt(acc, smem, p.g, p.ld_g, p.n, p.w_down, p.d, m0, n0, p.d);
    const Lane l;
    const long ld_dgu = 2L * p.f;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + l.wm + mt * 16 + l.g + half * 8;
        if (row >= p.n) continue;
        const uint16_t* gr = p.gate + (long)row * p.ld_gu;
        uint16_t* out = p.dgu + (long)row * ld_dgu;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int c = n0 + l.wn + nt * 8 + 2 * l.t;
          const uint32_t gp = *reinterpret_cast<const uint32_t*>(gr + c);
          const uint32_t up = *reinterpret_cast<const uint32_t*>(gr + p.up_off + c);
          float dg[2], du[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gate = e ? bf16_hi(gp) : bf16_lo(gp);
            const float u = e ? bf16_hi(up) : bf16_lo(up);
            const float dinner = acc[mt][nt][half * 2 + e];
            const float sg = sigmoidf_(gate);
            dg[e] = dinner * u * (sg * (1.f + gate * (1.f - sg)));
            du[e] = dinner * (gate * sg);
          }
          *reinterpret_cast<uint32_t*>(out + c) = pack_bf16(dg[0], dg[1]);
          *reinterpret_cast<uint32_t*>(out + p.f + c) = pack_bf16(du[0], du[1]);
        }
      }
    }
  } else {
    // d_w_down tile: intermediate rows m0.., hidden columns n0..
    const int tiles_n = p.d / kBN;
    const int m0 = (role.tile / tiles_n) * kBM, n0 = (role.tile % tiles_n) * kBN;
    gemm_tn<true>(acc, smem, p.gate, p.ld_gu, p.up_off, p.g, p.ld_g, m0, n0, p.n);
    store_tile(acc, p.dwd, p.d, m0, n0, p.f);
  }
}

struct DhArgs {
  const uint16_t* h;     // (N, D), row stride ld_h
  const uint16_t* dgu;   // (N, 2F), contiguous
  const uint16_t* w_gu;  // (D, 2F), contiguous
  uint16_t* dh;          // (N, D), contiguous
  uint16_t* dwgu;        // (D, 2F), contiguous
  long ld_h;
  int n, d, f2, tiles_a, tiles_b, a_first;
};

__global__ void __launch_bounds__(kThreads, 2) mlp_dh_dwgu_kernel(DhArgs p) {
  __shared__ __align__(16) uint16_t smem[kSmemHalves];
  const Role role(p.tiles_a, p.tiles_b, p.a_first);
  Acc acc;
  zero(acc);
  if (role.a) {
    // dh tile: tokens m0.., hidden columns n0.., contracting 2F
    const int tiles_n = p.d / kBN;
    const int m0 = (role.tile / tiles_n) * kBM, n0 = (role.tile % tiles_n) * kBN;
    gemm_nt(acc, smem, p.dgu, p.f2, p.n, p.w_gu, p.f2, m0, n0, p.f2);
    store_tile(acc, p.dh, p.d, m0, n0, p.n);
  } else {
    // d_w_gu tile: hidden rows m0.., gate|up columns n0.., over the tokens
    const int tiles_n = p.f2 / kBN;
    const int m0 = (role.tile / tiles_n) * kBM, n0 = (role.tile % tiles_n) * kBN;
    gemm_tn<false>(acc, smem, p.h, p.ld_h, 0, p.dgu, p.f2, m0, n0, p.n);
    store_tile(acc, p.dwgu, p.f2, m0, n0, p.d);
  }
}

}  // namespace

// K5a. g (N, D) row stride ld_g; w_down (F, D) contiguous; gate/up (N, F)
// with row stride ld_gu, up at gate + up_off elements; dgu (N, 2F) and
// d_w_down (F, D) contiguous outputs. D and F multiples of 128. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ditl_mlp_bwd_dgu_dwdown_bf16(const void* g, const void* w_down,
                                            const void* gate, void* dgu, void* d_w_down,
                                            long ld_g, long ld_gu, long up_off, int n,
                                            int d, int f, void* stream) {
  if (n <= 0 || d % kBN || f % kBN) return (int)cudaErrorInvalidValue;
  DguArgs a{static_cast<const uint16_t*>(g), static_cast<const uint16_t*>(w_down),
            static_cast<const uint16_t*>(gate), static_cast<uint16_t*>(dgu),
            static_cast<uint16_t*>(d_w_down), ld_g, ld_gu, up_off, n, d, f, 0, 0, 0};
  a.tiles_a = ((n + kBM - 1) / kBM) * (f / kBN);
  a.tiles_b = (f / kBM) * (d / kBN);
  a.a_first = d >= n;  // role A contracts D, role B the N tokens
  mlp_dgu_dwdown_kernel<<<a.tiles_a + a.tiles_b, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K5b. h (N, D) row stride ld_h; dgu (N, 2F) and w_gu (D, 2F) contiguous;
// dh (N, D) and d_w_gu (D, 2F) contiguous outputs. Returns cudaGetLastError().
extern "C" int ditl_mlp_bwd_dh_dwgu_bf16(const void* h, const void* dgu, const void* w_gu,
                                         void* dh, void* d_w_gu, long ld_h, int n, int d,
                                         int f, void* stream) {
  if (n <= 0 || d % kBN || f % kBN) return (int)cudaErrorInvalidValue;
  DhArgs a{static_cast<const uint16_t*>(h), static_cast<const uint16_t*>(dgu),
           static_cast<const uint16_t*>(w_gu), static_cast<uint16_t*>(dh),
           static_cast<uint16_t*>(d_w_gu), ld_h, n, d, 2 * f, 0, 0, 0};
  a.tiles_a = ((n + kBM - 1) / kBM) * (d / kBN);
  a.tiles_b = (d / kBM) * (2 * f / kBN);
  a.a_first = 2 * f >= n;  // role A contracts 2F, role B the N tokens
  mlp_dh_dwgu_kernel<<<a.tiles_a + a.tiles_b, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
