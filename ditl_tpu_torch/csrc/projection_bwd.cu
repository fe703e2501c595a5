// Backward of a dense projection out = x . w for Hopper (sm_90a): one
// persistent kernel on the GEMM core of gemm_sm90.cuh, bf16 or float16 in,
// f32 sums, outputs in the operands' type.
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
// 1.37e11 FLOP -> 0.139 ms. Tensor-core bound at every projection, which
// only wgmma drives at its rate.
//
// Design. The TPU kernel accumulates dw in a (bd, F) VMEM scratch along the
// sequential token axis of its grid. Here the kernel is gemm_sm90.cuh's
// proj_bwd_kernel, the one K5b runs (mlp_bwd.cu): one 384-thread block per
// SM, wgmma m64n256k16 from a 4-stage TMA ring, outputs stored by TMA, and
// 128 x 256 tiles of two roles from an atomic counter in a zeroed scratch:
// dx tiles (128 tokens x 256 input features, contracting F, g and w
// K-major) and dw tiles (128 input x 256 output features, contracting the N
// tokens, x and g MN-major). Each output tile is summed by one block in one
// order: no atomics in any sum, two calls give the same bits.
// - The role with the longer contraction is handed out first (dx_first =
//   F >= N; at the training shape dw, over 8192 tokens, against F = 4096 or
//   1024), so that its long tiles do not form a ragged tail at the end.
//   chip_smoke.py times both orders at both shapes.
// - float16 (K6-f16, ditl_proj_bwd_f16): the kernel's kF16 instance,
//   proj_bwd_kernel<6, true> (the core's .f16 products, float16 tensor maps
//   and roundings), as the reference's kernel takes any float dtype.
// - x and g take row strides (g may be a column slice of a fused
//   projection's gradient) through their tensor maps. D and F are multiples
//   of 128 (ops/projection.py::supports), N a multiple of 16: TMA fills rows
//   past N and columns past D or F (a 256-wide tile over F = 384) with
//   zeros, and the output maps clip the stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include "gemm_sm90.cuh"

// K6. x (N, D) row stride ld_x; w (D, F) contiguous; g (N, F) row stride
// ld_g; dx (N, D) and dw (D, F) contiguous outputs; sched one zeroed int;
// dx_first != 0 hands out every dx tile before any dw tile, 0 the reverse.
// D and F multiples of 128; all bf16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int ditl_proj_bwd_bf16(const void* x, const void* w, const void* g, void* dx,
                                  void* dw, void* sched, long ld_x, long ld_g, int n, int d,
                                  int f, int dx_first, void* stream) {
  return proj_bwd_launch<6, false>(x, w, g, dx, dw, sched, ld_x, ld_g, n, d, f, dx_first != 0,
                                   static_cast<cudaStream_t>(stream));
}

// K6-f16: as ditl_proj_bwd_bf16 with every tensor float16.
extern "C" int ditl_proj_bwd_f16(const void* x, const void* w, const void* g, void* dx,
                                 void* dw, void* sched, long ld_x, long ld_g, int n, int d,
                                 int f, int dx_first, void* stream) {
  return proj_bwd_launch<6, true>(x, w, g, dx, dw, sched, ld_x, ld_g, n, d, f, dx_first != 0,
                                  static_cast<cudaStream_t>(stream));
}
