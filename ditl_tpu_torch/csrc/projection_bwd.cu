// Backward of a dense projection out = x . w for Hopper (sm_90a): one
// kernel, bf16 in, f32 accumulation, bf16 out.
//
// Replaces K6 ditl_tpu/ops/projection.py::_bwd_kernel (pallas_call :121):
// dx = g . w^T and dw = x^T . g, for the attention projections wq, wk, wv,
// wo (and w_qkv when fused) of the training backward.
//
// Bound on the card at the training shape (llama3-8b, N = B*S = 8192
// tokens): for wq and wo (x (N, 4096), w (4096, 4096), g (N, 4096)) reading
// x, w, g once and writing dx, dw once moves 0.27 GB -> 80 us at 3.35 TB/s,
// against two products of 2*N*D*F each, 5.50e11 FLOP -> 0.556 ms at 989
// TFLOP/s bf16; for wk and wv (w (4096, 1024)) 0.10 GB (30 us) against
// 1.37e11 FLOP -> 0.139 ms. Tensor-core bound at every projection.
//
// What this design does about it:
// - The TPU kernel accumulates dw in a (bd, F) VMEM scratch along the
//   sequential token axis of its grid, sharing each g tile between its two
//   products. Blocks on the card run in no order, so the kernel is one
//   __global__ launched once per call whose grid has two block roles, each
//   output tile owned by exactly one block (no atomics, no scratch):
//   * role A: dx, one block per (128 tokens, 128 input features) tile
//     looping over F;
//   * role B: dw, one block per 128 x 128 tile looping over all N tokens, the
//     strided axis of both x and g (read through ldmatrix.trans).
//   The role with the longer loop takes the low block indices (role B at
//   the training shape: 8192 tokens against F = 4096 or 1024).
// - Every product runs on the tensor cores (mma.sync m16n8k16, bf16
//   operands, f32 accumulators) through gemm_tile.cuh: 128 x 128 tiles, 8
//   warps, k-tiles of 32 in two shared stages fed by register prefetch.
// - x and g take row strides (g may be a slice of a fused projection's
//   gradient); the ragged token edge (N a multiple of 16) is masked in the
//   kernel. D and F are multiples of 128 (ops/projection.py::supports).
// A later PR makes it fast: cp.async/TMA pipelines, wgmma.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include "gemm_tile.cuh"

namespace {

using namespace ditl_gemm;

struct ProjArgs {
  const uint16_t* x;  // (N, D), row stride ld_x
  const uint16_t* w;  // (D, F), contiguous
  const uint16_t* g;  // (N, F), row stride ld_g
  uint16_t* dx;       // (N, D), contiguous
  uint16_t* dw;       // (D, F), contiguous
  long ld_x, ld_g;
  int n, d, f, tiles_a, tiles_b, a_first;
};

__global__ void __launch_bounds__(kThreads, 2) proj_bwd_kernel(ProjArgs p) {
  __shared__ __align__(16) uint16_t smem[kSmemHalves];
  const Role role(p.tiles_a, p.tiles_b, p.a_first);
  Acc acc;
  zero(acc);
  if (role.a) {
    // dx tile: tokens m0.., input features n0.., contracting F
    const int tiles_n = p.d / kBN;
    const int m0 = (role.tile / tiles_n) * kBM, n0 = (role.tile % tiles_n) * kBN;
    gemm_nt(acc, smem, p.g, p.ld_g, p.n, p.w, p.f, m0, n0, p.f);
    store_tile(acc, p.dx, p.d, m0, n0, p.n);
  } else {
    // dw tile: input features m0.., output features n0.., over the tokens
    const int tiles_n = p.f / kBN;
    const int m0 = (role.tile / tiles_n) * kBM, n0 = (role.tile % tiles_n) * kBN;
    gemm_tn(acc, smem, p.x, p.ld_x, p.g, p.ld_g, m0, n0, p.n);
    store_tile(acc, p.dw, p.f, m0, n0, p.d);
  }
}

}  // namespace

// K6. x (N, D) row stride ld_x; w (D, F) contiguous; g (N, F) row stride
// ld_g; dx (N, D) and dw (D, F) contiguous outputs. D and F multiples of
// 128. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ditl_proj_bwd_bf16(const void* x, const void* w, const void* g, void* dx,
                                  void* dw, long ld_x, long ld_g, int n, int d, int f,
                                  void* stream) {
  if (n <= 0 || d % kBN || f % kBN) return (int)cudaErrorInvalidValue;
  ProjArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
             static_cast<const uint16_t*>(g), static_cast<uint16_t*>(dx),
             static_cast<uint16_t*>(dw), ld_x, ld_g, n, d, f, 0, 0, 0};
  a.tiles_a = ((n + kBM - 1) / kBM) * (d / kBN);
  a.tiles_b = (d / kBM) * (f / kBN);
  a.a_first = f >= n;  // role A contracts F, role B the N tokens
  proj_bwd_kernel<<<a.tiles_a + a.tiles_b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}
