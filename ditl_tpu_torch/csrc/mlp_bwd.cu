// Backward of the fused-gate|up SwiGLU MLP block for Hopper (sm_90a): two
// persistent kernels on the GEMM core of gemm_sm90.cuh, bf16 or float16 in,
// f32 sums, outputs in the operands' type.
//
// Replaces:
// - K5a ditl_tpu/ops/mlp_bwd.py::_dgu_dwdown_kernel (pallas_call :222):
//   dinner = g . w_down^T, SwiGLU from the forward's gate/up in f32,
//   dgate = dinner * up * sg * (1 + gate (1 - sg)) and dup = dinner * silu
//   (rounded to bf16), and d_w_down = inner^T . g with inner =
//   bf16(silu(gate) * up).
// - K5b ::_dh_dwgu_kernel (pallas_call :252): dh = dgu . w_gu^T and
//   d_w_gu = h^T . dgu.
//
// Bound on the card at the training shape (llama3-8b: N = B*S = 8192 tokens,
// D = 4096, F = 14336), computed by chip_smoke.py::_mlp_bounds: K5a reads g,
// w_down and gate/up once and writes dgu and d_w_down once, 1.24 GB -> 0.37
// ms at 3.35 TB/s, against two products of 2*N*D*F each, 1.92e12 FLOP ->
// 1.9455 ms at 989 TFLOP/s bf16. K5b moves 1.07 GB (0.32 ms) against
// 3.85e12 FLOP -> 3.8911 ms. Both are bound by the tensor cores, which only
// wgmma drives at their rate.
//
// Design. Each kernel is one launch of a persistent grid (one 384-thread
// block per SM, gemm_sm90.cuh: wgmma m64n256k16, a 4-stage TMA ring, two
// consumer warpgroups) whose 128 x 256 tiles come in two roles, handed out
// from an atomic counter in a scratch the wrapper zeroes:
// - K5a, role A (activation gradient): a dinner tile of 128 tokens x 256
//   intermediate columns, contracting D, both operands K-major (g, w_down).
//   After its k-tiles the producer brings the tile's gate and up (the
//   strided halves of the forward's gu, read in place; sent to L2 16
//   k-tiles ahead) by TMA into four more ring stages, 64 columns each. The
//   consumers compute SwiGLU from them in f32 once per element, write dgate
//   and dup over gate and up and inner beside them, and each warpgroup's
//   leader stores the three by TMA: dgate and dup into the two halves of
//   one (N, 2F) dgu buffer (the buffer K5b reads, in place of the
//   reference's concatenate, mlp_bwd.py:250), inner into an (N, F)
//   scratch. The leader then waits for its stores to land and adds one to
//   its 256-column strip's ready count (a proxy fence, then a GPU-scope
//   release: role B reads inner by TMA, the async proxy).
// - K5a, role B (weight gradient): a d_w_down tile of 128 intermediate rows
//   x 256 hidden columns, contracting all N tokens, both operands MN-major
//   (inner, g). Its producer first waits (acquire, then a proxy fence) until
//   the strip's count reaches 2 ceil(N / 128). The counter hands out every
//   role-A tile before any role-B tile, so a role-B tile waits only on
//   role-A tiles that running blocks hold and finish without waiting: no
//   deadlock, whatever number of blocks is resident. SwiGLU is thus
//   computed N*F times a call, not once per 128-wide d-tile (32 N*F at D =
//   4096, as the first design's weight-gradient loop did), and the operand
//   is inner, not gate and up: half the bytes.
// - K5b: dh tiles (128 tokens x 256 hidden columns, contracting 2F, dgu and
//   w_gu K-major) and d_w_gu tiles (128 hidden rows x 256 gate|up columns,
//   contracting N, h and dgu MN-major), no dependency between them; the dh
//   tiles, whose contraction is the longer at the training shape (2F =
//   28672 against N = 8192), are handed out first. Every output tile goes
//   out by TMA from the consumers' epilogue boxes. This is the projection
//   backward's kernel of gemm_sm90.cuh (proj_bwd_kernel, K6's too) with x =
//   h, g = dgu and w = w_gu; its tiles, their k-order and so its bits are
//   the ones K5b had as a kernel of its own.
// - Numerics are the first design's: the same f32 expressions (the fast
//   exponent and an exact reciprocal in the sigmoid), inner rounded to bf16
//   once, every sum in f32 by one block, no atomics in any sum, so two calls
//   give the same bits (and the first design's bits, on the card).
// - Edges: D and F are multiples of 128 (ops/mlp_bwd.py::supports), N a
//   multiple of 16. TMA fills token rows past N and columns past D or F
//   (a 256-wide tile overhanging F = 384) with zeros, and every store's map
//   clips rows past N and columns past D or F: dgate's map has F columns,
//   so nothing lands in dup's half of dgu.
//
// ptxas -v (sm_90a): 168 registers a thread (the 384-thread
// block's allocation, which setmaxnreg splits 40 / 232), no spills and no
// stack, for K5a, K5b and the core's four instances. ptxas allocated
// within 168 in the consumers' branch all the same: K5a's epilogue spilled
// until its swizzled addresses were kept from being hoisted out of the
// stage loop (swiglu_epilogue).
//
// On an H100 80GB HBM3 at 700 W, N=8192, D=4096, F=14336 (chip_smoke.py):
// K5a 3.1126 ms (62.5% of its bound), K5b 5.4930 ms (70.8%), together
// under autograd of the plain MLP forward (9.0124 ms); the first design
// took 11.8640 and 15.1822 ms.
//
// float16 (K5a-f16 ditl_mlp_bwd_dgu_dwdown_f16, K5b-f16
// ditl_mlp_bwd_dh_dwgu_f16): the same kernels' kF16 instances (the core's
// .f16 products, float16 tensor maps, pack2<true> roundings), as the
// reference's kernels take any float dtype: dgate, dup and inner are rounded
// to float16 where it casts them to g's dtype (ditl_tpu/ops/mlp_bwd.py
// :136-138). The epilogue reads gate and up through unpack_lo/unpack_hi: a
// float16 value is not the top half of an f32, so the bf16 instance's bit
// shifts would read garbage there; float16 takes __half2float of each half.
// The bf16 instances keep their code and bits (K5_DIGESTS).
//
// ditl_gemm_sm90_bf16 exposes the core alone (C = A . B, either operand
// K-major or MN-major) for the card tests of its four operand layouts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <algorithm>

#include "gemm_sm90.cuh"

namespace {

using namespace sm90;

// The low and high halves of a register of two bf16 (float16 with kF16)
// values, in f32. A bf16 is the top half of its f32; a float16 is not, and
// converts by __half2float.
template <bool kF16>
__device__ __forceinline__ float unpack_lo(uint32_t x) {
  if constexpr (kF16) return __half2float(__ushort_as_half(static_cast<uint16_t>(x & 0xffffu)));
  else return __uint_as_float(x << 16);
}

template <bool kF16>
__device__ __forceinline__ float unpack_hi(uint32_t x) {
  if constexpr (kF16) return __half2float(__ushort_as_half(static_cast<uint16_t>(x >> 16)));
  else return __uint_as_float(x & 0xffff0000u);
}

// sigmoid in f32. Fast exponent and an exact reciprocal: inputs that are
// bf16 (float16) values, outputs rounded to bf16 (float16) by every caller.
__device__ __forceinline__ float sigmoidf_(float x) { return __frcp_rn(1.f + __expf(-x)); }

// ---------------------------------------------------------------------------
// K5a: dgu and d_w_down
// ---------------------------------------------------------------------------

// Tensor maps of K5a: the operands, gate and up (the halves of gu, F columns
// each at row stride ld_gu), and the outputs dgate and dup (the halves of
// dgu, F columns each at row stride 2F), inner and d_w_down.
struct DguMaps {
  CUtensorMap g, w_down, inner, gate, up, dgate, dup, d_w_down;
};

struct DguArgs {
  int* sched;  // [0] tile counter, [1 + s] strip s's ready count
  int n, d, f, tiles;
};

// Tile t of K5a: dinner tiles (role 0) first, then d_w_down tiles (role 1).
__device__ __forceinline__ Tile dgu_tile(const DguArgs& p, int t) {
  const int tiles_tok = cdiv(p.n, kBM), strips = cdiv(p.f, kBN);
  int tm, tn;
  if (t < tiles_tok * strips) {
    raster(t, tiles_tok, strips, tm, tn);
    return Tile{0, tm * kBM, tn * kBN, p.d / kBK};
  }
  raster(t - tiles_tok * strips, p.f / kBM, cdiv(p.d, kBN), tm, tn);
  return Tile{1, tm * kBM, tn * kBN, cdiv(p.n, kBK)};
}

// k-tiles of a dinner tile still to issue when its gate and up go to L2.
constexpr int kPrefetchAhead = 16;

__device__ __forceinline__ void prefetch_gate_up(const DguMaps& m, const Tile& t) {
#pragma unroll
  for (int cb = 0; cb < kBN / 64; ++cb) {
#pragma unroll
    for (int wg = 0; wg < 2; ++wg) {
      tma_prefetch_2d(&m.gate, t.n0 + 64 * cb, t.m0 + 64 * wg);
      tma_prefetch_2d(&m.up, t.n0 + 64 * cb, t.m0 + 64 * wg);
    }
  }
}

// Producer, after a dinner tile's k-tiles: its gate and up into kBN / 64
// more stages, stage cb holding columns 64 cb.. of both for each
// warpgroup's 64 rows (gate at box 3 wg, up at box 3 wg + 1; box 3 wg + 2
// takes inner). The maps have F columns: a tile overhanging F reads zeros,
// not the other half of gu.
__device__ __forceinline__ void produce_gate_up(Ring& r, const DguMaps& m, const Tile& t,
                                                int index) {
  for (int cb = 0; cb < kBN / 64; ++cb) {
    ring_wait(r.empty(), r.phase ^ 1);
    sts32(r.slot(), static_cast<uint32_t>(index));
    __threadfence_block();
    const uint32_t bar = r.full();
    mbar_expect_tx(bar, 4 * kBox);
#pragma unroll
    for (int wg = 0; wg < 2; ++wg) {
      const uint32_t dst = r.a_box(0) + 3 * wg * kBox;
      tma_load_2d(dst, &m.gate, bar, t.n0 + 64 * cb, t.m0 + 64 * wg);
      tma_load_2d(dst + kBox, &m.up, bar, t.n0 + 64 * cb, t.m0 + 64 * wg);
    }
    r.advance();
  }
}

// Consumer warpgroup wg, after the products of dinner tile t: per stage cb,
// from its dinner sums and the stage's gate/up in f32, dgate and dup written
// in place over gate and up, inner into the box after them, and the three
// stored by TMA (the maps clip rows past N and columns past F). The tile's
// coordinates are decoded again where needed: registers are scarce here.
template <bool kF16>
__device__ __forceinline__ void swiglu_epilogue(Ring& r, const float* acc, const DguMaps& m,
                                                const DguArgs& p, int t, int wg) {
  constexpr int kBatch = 4;
  const BoxPos pos0;
#pragma unroll
  for (int cb = 0; cb < kBN / 64; ++cb) {
    ring_wait(r.full(), r.phase);
    const uint32_t sgate = r.a_box(0) + 3 * wg * kBox;  // up and inner follow
    // A copy the compiler cannot see through: otherwise it hoists the eight
    // swizzled offsets pos.at(j, h) out of this loop, and beside the 128
    // accumulators they spill.
    BoxPos pos = pos0;
    asm volatile("" : "+r"(pos.base));
#pragma unroll
    for (int q = 0; q < 16; q += kBatch) {  // kBatch column pairs of row h at a time
      const int h = q / 8;
      uint32_t gv[kBatch], uv[kBatch];  // all loads of a batch in flight before its stores
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        gv[b] = lds32(sgate + pos.at((q + b) % 8, h));
        uv[b] = lds32(sgate + kBox + pos.at((q + b) % 8, h));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = (q + b) % 8;
        const uint32_t at = sgate + pos.at(j, h);
        float dgate[2], dup[2], inr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gate = e ? unpack_hi<kF16>(gv[b]) : unpack_lo<kF16>(gv[b]);
          const float up = e ? unpack_hi<kF16>(uv[b]) : unpack_lo<kF16>(uv[b]);
          const float dinner = acc[4 * (8 * cb + j) + 2 * h + e];
          const float sg = sigmoidf_(gate);
          const float silu = gate * sg;
          dgate[e] = dinner * up * (sg * (1.f + gate * (1.f - sg)));
          dup[e] = dinner * silu;
          inr[e] = silu * up;
        }
        sts32(at, pack2<kF16>(dgate[0], dgate[1]));
        sts32(at + kBox, pack2<kF16>(dup[0], dup[1]));
        sts32(at + 2 * kBox, pack2<kF16>(inr[0], inr[1]));
      }
    }
    wg_publish(wg);
    if ((threadIdx.x & 127) == 0) {
      const Tile tile = dgu_tile(p, t);
      const int col = tile.n0 + 64 * cb, row = tile.m0 + 64 * wg;
      tma_store_2d(&m.dgate, sgate, col, row);
      tma_store_2d(&m.dup, sgate + kBox, col, row);
      tma_store_2d(&m.inner, sgate + 2 * kBox, col, row);
      bulk_commit();
      bulk_wait_read();
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty());
    r.advance();
  }
}

template <bool kF16>
__global__ void __launch_bounds__(kThreads, 1)
mlp_dgu_dwdown_kernel(const __grid_constant__ DguMaps m, const DguArgs p) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring = ring_init(smem_raw);
  // Warp-uniform for the compiler (a broadcast), so the role branch below
  // can move registers with setmaxnreg.
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  if (warp >= kConsumers / 32) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      const int ready = 2 * cdiv(p.n, kBM);  // role-A warpgroups per strip
      for (;;) {
        const int t = atomicAdd(p.sched, 1);
        if (t >= p.tiles) break;
        const Tile tile = dgu_tile(p, t);
        if (tile.role == 0) {
          // gate and up into L2 some k-tiles before the epilogue reads them,
          // so that 132 blocks do not fetch them from memory at once
          produce<false, false>(ring, &m.g, &m.w_down, tile, t, [&](int kt) {
            if (kt == max(tile.nk - kPrefetchAhead, 0)) prefetch_gate_up(m, tile);
          });
          produce_gate_up(ring, m, tile, t);
        } else {
          wait_count(p.sched + 1 + tile.m0 / kBN, ready);
          produce<true, true>(ring, &m.inner, &m.g, tile, t);
        }
      }
      produce_end(ring);
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int wg = warp >> 2;
    float acc[128];
    for (;;) {
      const int t = next_tile(ring);
      if (t < 0) break;
      const Tile tile = dgu_tile(p, t);
      if (tile.role == 0) {
        consume<false, false, kF16>(ring, wg, tile.nk, acc);
        swiglu_epilogue<kF16>(ring, acc, m, p, t, wg);
        if ((threadIdx.x & 127) == 0) signal_count(p.sched + 1 + dgu_tile(p, t).n0 / kBN);
      } else {
        consume<true, true, kF16>(ring, wg, tile.nk, acc);
        store_acc<kF16>(acc, ring, &m.d_w_down, tile, wg);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The core alone: C = A . B
// ---------------------------------------------------------------------------

struct GemmMaps {
  CUtensorMap a, b, c;
};

struct GemmArgs {
  int* sched;  // [0] tile counter
  int m, n, k, tiles;
};

template <bool kMNA, bool kMNB>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ GemmMaps m, const GemmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring = ring_init(smem_raw);
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  auto tile_of = [&](int t) {
    int tm, tn;
    raster(t, cdiv(p.m, kBM), cdiv(p.n, kBN), tm, tn);
    return Tile{0, tm * kBM, tn * kBN, cdiv(p.k, kBK)};
  };
  if (warp >= kConsumers / 32) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      for (;;) {
        const int t = atomicAdd(p.sched, 1);
        if (t >= p.tiles) break;
        produce<kMNA, kMNB>(ring, &m.a, &m.b, tile_of(t), t);
      }
      produce_end(ring);
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int wg = warp >> 2;
    float acc[128];
    for (;;) {
      const int t = next_tile(ring);
      if (t < 0) break;
      const Tile tile = tile_of(t);
      consume<kMNA, kMNB>(ring, wg, tile.nk, acc);
      store_acc(acc, ring, &m.c, tile, wg);
    }
  }
}

template <bool kMNA, bool kMNB>
int launch_gemm(const GemmMaps& m, const GemmArgs& a, cudaStream_t stream) {
  static bool prepared = false;
  if (const int err = launch_prepare(gemm_sm90_kernel<kMNA, kMNB>, prepared)) return err;
  gemm_sm90_kernel<kMNA, kMNB><<<std::min(a.tiles, num_sms()), kThreads, kSmemAlloc, stream>>>(
      m, a);
  return static_cast<int>(cudaGetLastError());
}


// K5a's launch on bf16 (float16 with kF16) operands; the arguments of the
// entry points below.
template <bool kF16>
int dgu_launch(const void* g, const void* w_down, const void* gate, void* dgu, void* d_w_down,
               void* inner, void* sched, long ld_g, long ld_gu, long up_off, int n, int d,
               int f, cudaStream_t stream) {
  if (n <= 0 || d % kBM || f % kBM) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const uint16_t* up = static_cast<const uint16_t*>(gate) + up_off;
  uint16_t* dup = static_cast<uint16_t*>(dgu) + f;
  DguMaps m;
  if (!make_map_2d(encode, &m.g, g, n, d, ld_g, kF16) ||
      !make_map_2d(encode, &m.w_down, w_down, f, d, d, kF16) ||
      !make_map_2d(encode, &m.inner, inner, n, f, f, kF16) ||
      !make_map_2d(encode, &m.gate, gate, n, f, ld_gu, kF16) ||
      !make_map_2d(encode, &m.up, up, n, f, ld_gu, kF16) ||
      !make_map_2d(encode, &m.dgate, dgu, n, f, 2L * f, kF16) ||
      !make_map_2d(encode, &m.dup, dup, n, f, 2L * f, kF16) ||
      !make_map_2d(encode, &m.d_w_down, d_w_down, f, d, d, kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DguArgs a{static_cast<int*>(sched), n, d, f,
                  cdiv(n, kBM) * cdiv(f, kBN) + (f / kBM) * cdiv(d, kBN)};
  static bool prepared = false;
  if (const int err = launch_prepare(mlp_dgu_dwdown_kernel<kF16>, prepared)) return err;
  mlp_dgu_dwdown_kernel<kF16><<<std::min(a.tiles, num_sms()), kThreads, kSmemAlloc, stream>>>(
      m, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5a. g (N, D) row stride ld_g; w_down (F, D) contiguous; gate/up (N, F)
// with row stride ld_gu, up at gate + up_off elements; dgu (N, 2F) and
// d_w_down (F, D) contiguous outputs; inner an (N, F) scratch; sched
// 1 + ceil(F / 256) zeroed ints; all bf16. D and F multiples of 128, every
// row 16-byte aligned. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ditl_mlp_bwd_dgu_dwdown_bf16(const void* g, const void* w_down,
                                            const void* gate, void* dgu, void* d_w_down,
                                            void* inner, void* sched, long ld_g, long ld_gu,
                                            long up_off, int n, int d, int f, void* stream) {
  return dgu_launch<false>(g, w_down, gate, dgu, d_w_down, inner, sched, ld_g, ld_gu, up_off,
                           n, d, f, static_cast<cudaStream_t>(stream));
}

// K5a-f16: as ditl_mlp_bwd_dgu_dwdown_bf16 with every tensor float16.
extern "C" int ditl_mlp_bwd_dgu_dwdown_f16(const void* g, const void* w_down,
                                           const void* gate, void* dgu, void* d_w_down,
                                           void* inner, void* sched, long ld_g, long ld_gu,
                                           long up_off, int n, int d, int f, void* stream) {
  return dgu_launch<true>(g, w_down, gate, dgu, d_w_down, inner, sched, ld_g, ld_gu, up_off,
                          n, d, f, static_cast<cudaStream_t>(stream));
}

// K5b. h (N, D) row stride ld_h; dgu (N, 2F) and w_gu (D, 2F) contiguous;
// dh (N, D) and d_w_gu (D, 2F) contiguous outputs; sched one zeroed int.
// The projection backward's kernel (gemm_sm90.cuh) with x = h, g = dgu, w =
// w_gu, the dh tiles first. Returns cudaGetLastError().
extern "C" int ditl_mlp_bwd_dh_dwgu_bf16(const void* h, const void* dgu, const void* w_gu,
                                         void* dh, void* d_w_gu, void* sched, long ld_h, int n,
                                         int d, int f, void* stream) {
  return proj_bwd_launch<5, false>(h, w_gu, dgu, dh, d_w_gu, sched, ld_h, 2L * f, n, d, 2 * f,
                                   true, static_cast<cudaStream_t>(stream));
}

// K5b-f16: as ditl_mlp_bwd_dh_dwgu_bf16 with every tensor float16.
extern "C" int ditl_mlp_bwd_dh_dwgu_f16(const void* h, const void* dgu, const void* w_gu,
                                        void* dh, void* d_w_gu, void* sched, long ld_h, int n,
                                        int d, int f, void* stream) {
  return proj_bwd_launch<5, true>(h, w_gu, dgu, dh, d_w_gu, sched, ld_h, 2L * f, n, d, 2 * f,
                                  true, static_cast<cudaStream_t>(stream));
}

// The GEMM core alone: C (M, N) = A . B with f32 sums, C contiguous bf16.
// A is a (M, K) row-major (a_mn = 0, K-major) or (K, M) (a_mn = 1); B is b
// (N, K) (b_mn = 0) or (K, N) (b_mn = 1); lda/ldb their row strides; sched
// one zeroed int. Returns cudaGetLastError().
extern "C" int ditl_gemm_sm90_bf16(const void* a, const void* b, void* c, void* sched,
                                   long lda, long ldb, int m, int n, int k, int a_mn, int b_mn,
                                   void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  GemmMaps maps;
  if (!make_map_2d(encode, &maps.a, a, a_mn ? k : m, a_mn ? m : k, lda) ||
      !make_map_2d(encode, &maps.b, b, b_mn ? k : n, b_mn ? n : k, ldb) ||
      !make_map_2d(encode, &maps.c, c, m, n, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GemmArgs args{static_cast<int*>(sched), m, n, k, cdiv(m, kBM) * cdiv(n, kBN)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_mn) {
    return b_mn ? launch_gemm<true, true>(maps, args, s) : launch_gemm<true, false>(maps, args, s);
  }
  return b_mn ? launch_gemm<false, true>(maps, args, s) : launch_gemm<false, false>(maps, args, s);
}
