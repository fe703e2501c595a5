// FlashAttention backward for Hopper (sm_90a): two kernels, bf16 or float16
// in, f32 sums, on K1's skeleton (flash_fwd.cu) and its helpers (hopper.cuh).
//
// Replaces:
// - K2a ditl_tpu/ops/flash_attention.py::_dq_kernel (pallas_call in
//   _bwd_impl): dq = scale * sum_kv ds . k, one pass over the keys per block
//   of query rows.
// - K2b ditl_tpu/ops/flash_attention.py::_dkv_kernel: dv = sum p^T . do and
//   dk = scale * sum ds^T . q, summed over the GQA group's query heads and the
//   query tiles. The reference folds the group into its sequential grid
//   dimension; here a loop inside the block takes that place, and each block
//   owns its keys, so there are no atomics and two calls give the same bits.
// Both recompute p = exp(s - lse) from the forward's log-sum-exp in K1's
// convention (natural log, the scale applied after the q.k product), with
// s = scale * (q . k), dp = do . v^T and ds = p * (dp - delta); delta =
// rowsum(do * o) is an input (computed by PyTorch, as the reference computes
// it outside its kernels).
//
// Entry points: ditl_flash_bwd_dq_bf16 / ditl_flash_bwd_dkv_bf16 and, on
// float16 operands, ditl_flash_bwd_dq_f16 / ditl_flash_bwd_dkv_f16 (K2a-f16,
// K2b-f16: the reference's kernels take any float dtype). Each kernel is one
// template whose kF16 parameter picks the operand type of the wgmma products
// (.f16 in place of .bf16: the same fragment layouts, descriptors and
// swizzle), of the tensor maps (CU_TENSOR_MAP_DATA_TYPE_FLOAT16) and of the
// roundings of p, ds and the outputs (__floats2half2_rn in place of the bf16
// pack), as K1's (flash_fwd.cu). Tiles, rings, tile skipping, bound and
// design are the same for both; the bf16 instances keep their code and bits
// (chip_smoke.py K2_DIGESTS).
//
// Bound on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16), computed by
// chip_smoke.py from its run's inputs (q, k, v, do, lse, delta and ids read
// once, the gradients written once; 2 D flops per attended pair and head for
// each product: three for K2a, four for K2b), at B=4, S=2048, 32/8 heads,
// D=128, causal:
// - one document per row: K2a 0.2086 ms, K2b 0.2781 ms, both operations;
// - the training pipeline's packed rows (5-7 documents a row): K2a 0.0707 ms,
//   K2b 0.0607 ms, both bytes (the attended pairs are a fifth of the causal
//   ones).
// So long rows need the tensor cores near their rate, and packed rows need
// the work the mask removes not to be done at all.
//
// Design. Every product is wgmma m64nNk16 with K1's descriptors, on tiles
// that TMA stores with the 128-byte swizzle (64 bf16 a row) at D >= 64 and
// the 64-byte one at D = 32, through a ring of 4 stages under full/empty
// mbarriers; two consumer warpgroups of 64 rows (K2a) or keys (K2b) a block.
// - K2a (dq), K1's skeleton: a block owns 128 query rows of one head, plus a
//   producer warpgroup (384 threads) whose first warp loads Q and dO once
//   and streams K/V tiles of K1's width (64 keys at D >= 64, 128 at D = 32).
//   setmaxnreg gives the producer 40 registers a thread and the consumers
//   232. Per 64 keys: S = Q.K^T and dP = dO.V^T (SS, both K-major; the
//   exponent of S runs while dP is in flight), P = 2^(S scale log2 e - lse
//   log2 e), dS = P (dP - delta) rounded to bf16 A fragments in registers
//   (the m64 accumulator layout is the A layout), and dQ += dS.K (RS, K read
//   MN-major as K1 reads V); a 128-key tile at D = 32 is two such steps, so
//   S and dP stay at 32 registers each. dQ is scaled and stored once. Shared
//   memory at D = 128: Q 32 KB + dO 32 KB + 4 x 32 KB of K/V.
// - K2b (dk, dv): a block owns 128 keys of one KV head, whose K and V tiles
//   stay in shared memory for the whole block. The ring streams (Q tile, dO
//   tile, ids, lse, delta) for 64 query rows at a time, over every query head
//   of the group and the query tiles the block reaches (FlashAttention-3's
//   transposed form, everything in registers): S^T = K.Q^T and dP^T = V.dO^T
//   (SS), P^T from the per-column lse, dV += P^T.dO and dK += dS^T.Q (RS, dO
//   and Q read MN-major); dK is scaled at the end and both are stored. A
//   consumer holds dK and dV (128 registers at D = 128) beside S^T and dP^T
//   (64): about 230 in all. Under setmaxnreg ptxas allocated no more than
//   188 a thread in the consumers' branch, whatever count they asked for,
//   spilled 1 KB and serialised the wgmmas (C7512), and the kernel took
//   1.7 ms at the training shape on an H100, 3x this design's time. So K2b
//   is a 256-thread block with no producer warpgroup, which its launch
//   bounds give 255 registers: warp 0 also produces. Between its tiles it
//   fills every stage the block has freed (a non-blocking test of
//   the empty barrier; it waits only for the tile it is about to consume),
//   copying lse, delta and ids into the stage's slot by cp.async, whose
//   completion the full barrier counts beside the TMA bytes, so the warp
//   never waits on a load. Shared memory at D = 128: K/V 64 KB + 4 x 32.8
//   KB. Blocks with the longest loops start first: under causal masking,
//   the first key blocks.
// - D = 256. K2a takes K1's 32-key tiles, S and dP by wgmma m64n32k16 (16
//   registers each), dQ += dS.K as two m64n128k16 products a k-step
//   (hopper.cuh wgmma_rs<256>): dQ's 128 registers, S, dP and dS's 40 fit the
//   consumers' 232; a 2-stage ring (Q 64 KB + dO 64 KB + 2 x 32 KB). K2b
//   cannot keep 128 keys' dK and dV (256 registers a thread), so a block
//   owns 64 keys and its two warpgroups split D: warpgroup w accumulates dK
//   and dV columns 128 w .. 128 w + 127 (64 + 64 registers, as at D = 128)
//   and computes S^T and dP^T over the full D itself, the pair of them twice
//   per block. The other split, one warpgroup dV and the other dK with P^T
//   and dS^T passed through shared memory, would do each S^T product once
//   but needs a shared-memory handoff and a barrier per tile between the
//   warpgroups; the column split keeps K2b's code path (the same products,
//   each warpgroup on its own columns of dO and Q) and is right first.
//   Shared memory: K 32 KB + V 32 KB + 2 x (Q 32 KB + dO 32 KB).
// - Tile skipping, K1's rule: a tile is loaded only if it is not wholly on
//   the masked side of the causal diagonal and its segment-id range
//   [min, max] overlaps the block's; each warpgroup skips the loaded tiles
//   its own 64 rows (K2a) or keys (K2b) do not reach. A skipped pair has
//   s = NEG_INF, so p = exp(NEG_INF - lse) = 0 and ds = 0: it adds nothing,
//   since with ids Sq == Skv and every row admits its own key (a finite
//   lse). ditl_tpu_torch/ops/flash_attention.py::tile_schedule is this rule
//   at (BWD_DQ_BLOCK_Q, fwd_block_kv(D)) for K2a and (BWD_DKV_BLOCK_Q,
//   BWD_DKV_BLOCK_KV) for K2b. Element masks apply only on tiles across the
//   diagonal, a document edge or (K2a) the ragged key edge.
// - Ragged edges: TMA zero-fills rows past Sq and Skv. In K2a rows past Sq
//   take lse = +inf (p = 0) and keys past Skv are masked to -inf (p = 0); in
//   K2b rows past Sq have zero Q and dO (so ds = 0 and p meets zero dO rows)
//   and keys past Skv only fill rows that are never stored.
//
// Precision, as the reference feeds the products: q.k^T and do.v^T take bf16
// (float16) operands with f32 sums; p and ds are rounded to bf16 (float16)
// for the second products (p^T.do, ds.k, ds^T.q) with f32 sums, where the
// reference keeps them in f32; the outputs are rounded to bf16 (float16).
// float16 has more mantissa than bf16 but not its range: a float16 training
// step's do lies among float16's subnormals, where ds (proportional to do)
// would keep a few bits. So the wrapper (ops/flash_attention.py) hands
// K2a-f16/K2b-f16 do rescaled by an exact power of two (largest magnitude in
// (2^-5, 2^-4]) and multiplies their outputs back in f32. Masked scores are the finite -2.3819763e38, set after the scale (as
// K1 does), so p = 2^(NEG_INF - lse log2 e) = 0.
//
// ptxas -v (CUDA 12.9, sm_90a), no spills and no stack at D = 128, 64 and
// 32: K2a 168 registers (the 384-thread block's allocation, which
// setmaxnreg splits 40 / 232); K2b 250 / 192 / 158. At D = 256:
// K2a 168 with 464 bytes spilled (stores; 320 of loads), since ptxas
// compiles the consumers' branch within the block's 168 whatever
// setmaxnreg later grants; K2b 248, no spills. chip_smoke.py's build phase
// prints the lines on every run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <math.h>

#include "hopper.cuh"  // smem/mbarrier/TMA/wgmma helpers, make_map

namespace {

constexpr int kConsumers = 256;                  // two warpgroups: K2b's block
constexpr int kThreads = kConsumers + 128;       // K2a's: + a producer warpgroup
constexpr int kProducerWarp = kConsumers / 32;   // K2a's one producer warp that works
constexpr int kEmptyArrivals = kConsumers / 32;  // one per consumer warp
constexpr float kNegInf = -2.3819763e38f;        // ops/attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// K2a's registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 384 x
// 168, the 384-thread block's allocation at launch.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// mbar_wait that traps instead of spinning for ever: every wait here lasts
// microseconds, so 2^22 failed polls mean a broken ring, and the launch then
// fails with an error instead of holding the card.
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 22)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Panel geometry shared by both kernels: a swizzled row of 64 bf16 (128
// bytes) at D >= 64, 32 bf16 (64 bytes) at D = 32.
template <int D>
struct Panels {
  static constexpr int kPanel = D >= 64 ? 64 : 32;
  static constexpr int kBytes = 2 * kPanel;  // = the swizzle width
  static constexpr int kCount = D / kPanel;
  static constexpr uint64_t kLayout = kBytes == 128 ? 1 : 2;  // B128 / B64
};

// K-major descriptor of k-step ks of a tile of `rows` rows stored in panels
// (A of Q.K^T, or B read K-major).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int ks) {
  using P = Panels<D>;
  const uint32_t off = (ks * 16 % P::kPanel) * 2;
  const int p = ks * 16 / P::kPanel;
  return make_desc(tile + p * rows * P::kBytes + off, 16, 8 * P::kBytes, P::kLayout);
}

// MN-major descriptor of rows 16 kk .. 16 kk + 15 of a tile of `rows` rows
// (B of P.V-like products: k runs down the rows, n along d).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using P = Panels<D>;
  return make_desc(tile + kk * 16 * P::kBytes, rows * P::kBytes, 8 * P::kBytes, P::kLayout);
}

// Segment-id range [lo, hi] of positions [t N, min((t + 1) N, len)) of one
// row (empty: lo > hi); a lane per tile, four 16-byte loads in flight.
template <int N>
__device__ __forceinline__ void tile_range(const int* ids, int t, int len, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  const int* tile = ids + static_cast<long>(t) * N;
  if ((t + 1) * N <= len && (reinterpret_cast<uintptr_t>(tile) & 15) == 0) {
#pragma unroll 4
    for (int i = 0; i < N; i += 4) {
      const int4 x = *reinterpret_cast<const int4*>(tile + i);
      lo = min(lo, min(min(x.x, x.y), min(x.z, x.w)));
      hi = max(hi, max(max(x.x, x.y), max(x.z, x.w)));
    }
  } else {
    const int n = min(N, len - t * N);
    for (int i = 0; i < n; ++i) {
      lo = min(lo, tile[i]);
      hi = max(hi, tile[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2a: dq
// ---------------------------------------------------------------------------

// Shared memory of K2a; every tile starts on a 1024-byte boundary.
template <int D>
struct DqCfg {
  static constexpr int kBlockM = 128;                   // query rows per block
  static constexpr int kBlockN = D == 32 ? 128 : D == 256 ? 32 : 64;  // keys per K/V tile (K1's)
  static constexpr int kSubN = D == 256 ? 32 : 64;      // keys per product (S, dP)
  static constexpr int kStages = D == 256 ? 2 : 4;      // K/V ring depth
  static constexpr int kQBytes = kBlockM * D * 2;       // Q or dO
  static constexpr int kTileBytes = kBlockN * D * 2;    // one K or one V tile
  static constexpr int kDoOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kSlotInts = 4 + kBlockN;  // k0, min id, max id, -, ids
  static constexpr int kSlotOff = kVOff + kStages * kTileBytes;
  static constexpr int kBarOff = kSlotOff + kStages * kSlotInts * 4;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8;
  static constexpr int kSmemAlloc = kSmem + 1024;  // room to align the base
};

// Grid (heads, batch, q tiles); warps 0-7 are two consumer warpgroups of 64
// query rows each, warps 8-11 the producer warpgroup (warp 8 works).
// Accumulator layout of an m64nN product, per warp w of a warpgroup, g =
// lane / 4, t = lane % 4: d[4i + 0, 1] at row 16w + g, columns 8i + 2t, +1;
// d[4i + 2, 3] at row 16w + g + 8.
template <int D, bool kF16>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    uint16_t* __restrict__ dq, int sq, int skv, int heads, int kv_heads,
                    int causal, float scale) {
  using C = DqCfg<D>;
  using P = Panels<D>;
  constexpr int M = C::kBlockM;
  constexpr int N = C::kBlockN;
  constexpr int KH = C::kSubN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* slots = reinterpret_cast<int*>(smem_raw + (base - raw) + C::kSlotOff);
  const uint32_t full_bar = base + C::kBarOff;        // full[s] at + 8 s
  const uint32_t empty_bar = full_bar + 8 * C::kStages;  // empty[s] at + 8 s
  const uint32_t q_bar = empty_bar + 8 * C::kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * M;  // longest causal rows first
  const int kh = h / (heads / kv_heads);
  // Warp-uniform for the compiler (a broadcast), so the role branch below
  // can move registers with setmaxnreg.
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int* ids = seg != nullptr ? seg + static_cast<long>(b) * skv : nullptr;  // Sq == Skv

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kEmptyArrivals);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    // ---- Producer: Q and dO once, then the key tiles the block reaches. ----
    reg_dealloc<kProducerRegs>();
    if (warp == kProducerWarp) {
      const int q_last = min(sq, q0 + M) - 1;
      const int kv_end = causal ? min(skv, q_last + 1) : skv;  // causal: keys <= q_last
      const int n_kv = (kv_end + N - 1) / N;
      int q_lo = 0, q_hi = 0;
      if (ids != nullptr) id_range(ids, q0, q_last + 1, lane, q_lo, q_hi);
      if (lane == 0) {
        mbar_expect_tx(q_bar, 2 * C::kQBytes);
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) {
          tma_load(base + p * M * P::kBytes, &tm_q, q_bar, p * P::kPanel, h, q0, b);
          tma_load(base + C::kDoOff + p * M * P::kBytes, &tm_do, q_bar, p * P::kPanel, h, q0,
                   b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t0 = 0; t0 < n_kv; t0 += 32) {
        // Lane l tests tile t0 + l: visited unless its id range misses the
        // block's (disjoint ranges share no id, so no pair of it is admitted).
        const int t = t0 + lane;
        int k_lo = 0, k_hi = 0;
        bool visit = t < n_kv;
        if (visit && ids != nullptr) {
          tile_range<N>(ids, t, skv, k_lo, k_hi);
          visit = k_lo <= q_hi && k_hi >= q_lo;
        }
        for (uint32_t todo = __ballot_sync(0xffffffffu, visit); todo != 0; todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          const int k0 = (t0 + src) * N;
          const int lo = __shfl_sync(0xffffffffu, k_lo, src);
          const int hi = __shfl_sync(0xffffffffu, k_hi, src);
          // A tile of one id needs no copy of its ids: the consumers take lo.
          const bool copy_ids = ids != nullptr && lo != hi;
          int tile_ids[N / 32];
          if (copy_ids) {
#pragma unroll
            for (int j = 0; j < N / 32; ++j) {
              const int i = k0 + j * 32 + lane;
              tile_ids[j] = i < skv ? ids[i] : 0;
            }
          }
          ring_wait(empty_bar + 8 * stage, phase ^ 1);
          int* slot = slots + stage * C::kSlotInts;
          if (lane == 0) {
            slot[0] = k0;
            slot[1] = lo;
            slot[2] = hi;
          }
          if (copy_ids) {
#pragma unroll
            for (int j = 0; j < N / 32; ++j) slot[4 + j * 32 + lane] = tile_ids[j];
          }
          __threadfence_block();
          __syncwarp();
          if (lane == 0) {
            const uint32_t bar = full_bar + 8 * stage;
            mbar_expect_tx(bar, 2 * C::kTileBytes);
#pragma unroll
            for (int p = 0; p < P::kCount; ++p) {
              const uint32_t off = stage * C::kTileBytes + p * N * P::kBytes;
              tma_load(base + C::kKOff + off, &tm_k, bar, p * P::kPanel, kh, k0, b);
              tma_load(base + C::kVOff + off, &tm_v, bar, p * P::kPanel, kh, k0, b);
            }
          }
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // End of the ring: a slot with k0 = -1.
      ring_wait(empty_bar + 8 * stage, phase ^ 1);
      if (lane == 0) {
        slots[stage * C::kSlotInts] = -1;
        __threadfence_block();
        mbar_arrive(full_bar + 8 * stage);
      }
    }
  } else {
    // ---- Consumers: S, dP, P, dS and dQ += dS.K per tile. ----
    reg_alloc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int wq0 = q0 + 64 * wg;              // the warpgroup's first row
    const int w_last = min(sq, wq0 + 64) - 1;  // its last real row (< wq0: none)
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = wq0 + 16 * (warp & 3) + g;  // this thread's rows: row0, row0 + 8
    const int row1 = row0 + 8;
    int w_lo = 0, w_hi = 0, seg0 = 0, seg1 = 0;
    if (ids != nullptr) {
      id_range(ids, wq0, w_last + 1, lane, w_lo, w_hi);
      seg0 = row0 < sq ? ids[row0] : 0;
      seg1 = row1 < sq ? ids[row1] : 0;
    }
    // lse in base 2 (+inf past Sq, so p = 0 there) and delta of the rows.
    const float* lb = lse + (static_cast<long>(b) * heads + h) * sq;
    const float* db = delta + (static_cast<long>(b) * heads + h) * sq;
    const float lse0 = row0 < sq ? lb[row0] * kLog2e : INFINITY;
    const float lse1 = row1 < sq ? lb[row1] * kLog2e : INFINITY;
    const float dl0 = row0 < sq ? db[row0] : 0.f;
    const float dl1 = row1 < sq ? db[row1] : 0.f;
    const float scale_log2 = scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const uint32_t q_s = base + wg * 64 * P::kBytes;
    const uint32_t do_s = base + C::kDoOff + wg * 64 * P::kBytes;
    ring_wait(q_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      ring_wait(full_bar + 8 * stage, phase);
      const int* slot = slots + stage * C::kSlotInts;
      const int k0 = slot[0];
      if (k0 < 0) break;
      const int k_lo = slot[1], k_hi = slot[2];
      // The warpgroup's own test: the block's tile may miss its 64 rows.
      const bool visit = w_last >= wq0 && (!causal || k0 <= w_last) &&
                         (ids == nullptr || (k_lo <= w_hi && k_hi >= w_lo));
      if (visit) {
        const uint32_t k_s = base + C::kKOff + stage * C::kTileBytes;
        const uint32_t v_s = base + C::kVOff + stage * C::kTileBytes;
        const bool mixed = ids != nullptr && !(k_lo == k_hi && w_lo == w_hi && k_lo == w_lo);
#pragma unroll
        for (int half = 0; half < N / KH; ++half) {
          const int kb = k0 + half * KH;  // the sub-tile's first key
          if (kb >= skv || (causal && kb > w_last)) continue;
          const uint32_t ks_s = k_s + half * KH * P::kBytes;  // its K and V rows
          const uint32_t vs_s = v_s + half * KH * P::kBytes;
          float s[KH / 2], dp[KH / 2];
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            wgmma_ss<KH, kF16>(s, desc_k<D>(q_s, M, ks), desc_k<D>(ks_s, N, ks), ks > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            wgmma_ss<KH, kF16>(dp, desc_k<D>(do_s, M, ks), desc_k<D>(vs_s, N, ks), ks > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // S is in; dP still runs
          fence_regs<KH / 2>(s);

          // P = 2^(S scale log2 e - lse log2 e), in place; mask only where a
          // mask can bite: keys across the causal diagonal, a document
          // boundary or the ragged key edge.
          const bool edge = kb + KH > skv;
          const bool cross = causal && kb + KH - 1 > wq0;
          if (edge || cross || mixed) {
#pragma unroll
            for (int i = 0; i < KH / 8; ++i) {
              const int c = kb + 8 * i + 2 * t;  // this thread's columns c, c + 1
              int2 key = make_int2(k_lo, k_lo);
              if (k_lo != k_hi) key = *reinterpret_cast<const int2*>(slot + 4 + c - k0);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = c + (e & 1);
                float x = s[4 * i + e] * scale_log2;
                if (col >= skv) {
                  x = -INFINITY;  // not a key at all: weight exactly 0
                } else if ((causal && col > (e < 2 ? row0 : row1)) ||
                           (ids != nullptr &&
                            ((e & 1) ? key.y : key.x) != (e < 2 ? seg0 : seg1))) {
                  x = kNegInf;
                }
                s[4 * i + e] = exp2f(x - (e < 2 ? lse0 : lse1));
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < KH / 2; j += 4) {
              s[j] = exp2f(s[j] * scale_log2 - lse0);
              s[j + 1] = exp2f(s[j + 1] * scale_log2 - lse0);
              s[j + 2] = exp2f(s[j + 2] * scale_log2 - lse1);
              s[j + 3] = exp2f(s[j + 3] * scale_log2 - lse1);
            }
          }
          wgmma_wait<0>();
          fence_regs<KH / 2>(dp);

          // dS = P (dP - delta) as bf16 (float16) A fragments: K-step kk covers keys
          // 16 kk .. 16 kk + 15 of the sub-tile, s[8 kk ..], dsf[4 kk ..] (the
          // accumulator's two n8 column groups are the A fragment's halves).
          uint32_t dsf[KH / 4];
#pragma unroll
          for (int j = 0; j < KH / 2; j += 4) {
            dsf[(j >> 1) + 0] =
                pack2<kF16>(s[j] * (dp[j] - dl0), s[j + 1] * (dp[j + 1] - dl0));
            dsf[(j >> 1) + 1] =
                pack2<kF16>(s[j + 2] * (dp[j + 2] - dl1), s[j + 3] * (dp[j + 3] - dl1));
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KH / 16; ++kk) {
            wgmma_rs<D, kF16>(acc, dsf + 4 * kk, desc_mn<D>(k_s, N, half * KH / 16 + kk));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<D / 2>(acc);
          fence_regs<KH / 4>(dsf);  // the A fragments stay live until here
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long q_stride = static_cast<long>(heads) * D;
    uint16_t* out = dq + static_cast<long>(b) * sq * q_stride + static_cast<long>(h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (row0 < sq) {
        *reinterpret_cast<uint32_t*>(out + row0 * q_stride + c) =
            pack2<kF16>(acc[4 * i] * scale, acc[4 * i + 1] * scale);
      }
      if (row1 < sq) {
        *reinterpret_cast<uint32_t*>(out + row1 * q_stride + c) =
            pack2<kF16>(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2b: dk, dv
// ---------------------------------------------------------------------------

// Shared memory of K2b; every tile starts on a 1024-byte boundary.
template <int D>
struct DkvCfg {
  // At D = 256 a block owns 64 keys and its two warpgroups split the
  // columns of dK and dV (kSplitD): each owns kDW = 128 of them.
  static constexpr bool kSplitD = D == 256;
  static constexpr int kDW = kSplitD ? D / 2 : D;      // dK/dV columns a warpgroup owns
  static constexpr int kBlockN = kSplitD ? 64 : 128;  // keys per block
  static constexpr int kBlockM = 64;                  // query rows per Q/dO tile
  static constexpr int kStages = D == 256 ? 2 : 4;    // Q/dO ring depth
  static constexpr int kKBytes = kBlockN * D * 2;     // K or V of the block
  static constexpr int kTileBytes = kBlockM * D * 2;  // one Q or one dO tile
  static constexpr int kVOff = kKBytes;
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kDoOff = kQOff + kStages * kTileBytes;
  // Slot: q0, min id, max id, -, ids[64], lse[64], delta[64].
  static constexpr int kSlotInts = 4 + 3 * kBlockM;
  static constexpr int kLseAt = 4 + kBlockM;
  static constexpr int kDeltaAt = 4 + 2 * kBlockM;
  static constexpr int kSlotOff = kDoOff + kStages * kTileBytes;
  static constexpr int kBarOff = kSlotOff + kStages * kSlotInts * 4;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8;
  static constexpr int kSmemAlloc = kSmem + 1024;  // room to align the base
};

// One phase test, no wait.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// 4 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The barrier's phase counts one arrival of this thread once its earlier
// cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// K2b's producer, run by warp 0 between its tiles: the (query head, query
// tile) items the block visits, in order, into the ring. Lane l holds the
// id range of tile t0 + l of the current batch of 32 tiles.
template <int D>
struct DkvProducer {
  using C = DkvCfg<D>;
  static constexpr int M = C::kBlockM;
  int t0, hg, n_q, stage, produced;
  uint32_t tiles, todo, phase;
  int lo, hi;  // this lane's tile's id range
  bool ended;

  // The batch of 32 query tiles from t0: the ballot of those the block
  // reaches (causal: t0 starts at the block's first key; ids: range overlap).
  __device__ __forceinline__ void scan(const int* ids, int sq, int k_lo, int k_hi, int lane) {
    const int t = t0 + lane;
    bool visit = t < n_q;
    if (visit && ids != nullptr) {
      tile_range<M>(ids, t, sq, lo, hi);
      visit = lo <= k_hi && hi >= k_lo;
    }
    tiles = todo = __ballot_sync(0xffffffffu, visit);
    hg = 0;
  }

  // Moves to the next item; false once every item has been produced.
  __device__ __forceinline__ bool next(const int* ids, int sq, int k_lo, int k_hi, int groups,
                                       int lane) {
    while (todo == 0) {
      if (++hg < groups) {
        todo = tiles;
      } else {
        t0 += 32;
        if (t0 >= n_q) return false;
        scan(ids, sq, k_lo, k_hi, lane);
      }
    }
    return true;
  }
};

// Grid (KV heads, batch, key blocks); two warpgroups of 64 keys each, warp 0
// also the producer. In the transposed products a thread's accumulator rows
// are keys and its columns query rows of the tile.
template <int D, bool kF16>
__global__ void __launch_bounds__(kConsumers, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int sq, int skv,
                     int heads, int kv_heads, int causal, float scale) {
  using C = DkvCfg<D>;
  using P = Panels<D>;
  constexpr int M = C::kBlockM;
  constexpr int KN = C::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* slots = reinterpret_cast<int*>(smem_raw + (base - raw) + C::kSlotOff);
  const uint32_t slots_s = base + C::kSlotOff;
  const uint32_t full_bar = base + C::kBarOff;        // full[s] at + 8 s
  const uint32_t empty_bar = full_bar + 8 * C::kStages;  // empty[s] at + 8 s
  const uint32_t kv_bar = empty_bar + 8 * C::kStages;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * KN;  // the first key blocks have the longest causal loops
  const int groups = heads / kv_heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ids = seg != nullptr ? seg + static_cast<long>(b) * skv : nullptr;  // Sq == Skv

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 33);  // warp 0's 32 copies + the TMA bytes' arrival
      mbar_init(empty_bar + 8 * s, kEmptyArrivals);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_bar, 2 * C::kKBytes);
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      tma_load(base + p * KN * P::kBytes, &tm_k, kv_bar, p * P::kPanel, kh, k0, b);
      tma_load(base + C::kVOff + p * KN * P::kBytes, &tm_v, kv_bar, p * P::kPanel, kh, k0, b);
    }
  }
  __syncthreads();

  const int wg = warp >> 2;
  // The warpgroup's first key (kSplitD: both take the block's 64 keys) and
  // its first dK/dV column.
  const int wk0 = k0 + (C::kSplitD ? 0 : 64 * wg);
  const int dc0 = C::kSplitD ? C::kDW * wg : 0;
  const int w_last = min(skv, wk0 + 64) - 1;  // its last real key (< wk0: none)
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = wk0 + 16 * (warp & 3) + g;  // this thread's keys: key0, key0 + 8
  const int key1 = key0 + 8;
  int w_lo = 0, w_hi = 0, kseg0 = 0, kseg1 = 0;
  if (ids != nullptr) {
    id_range(ids, wk0, w_last + 1, lane, w_lo, w_hi);
    kseg0 = key0 < skv ? ids[key0] : 0;
    kseg1 = key1 < skv ? ids[key1] : 0;
  }

  // Warp 0's producer state: the block's key id range and the item stream.
  DkvProducer<D> pr;
  int b_lo = 0, b_hi = 0;
  if (warp == 0) {
    if (ids != nullptr) id_range(ids, k0, min(skv, k0 + KN), lane, b_lo, b_hi);
    pr.n_q = (sq + M - 1) / M;
    // Causal: a query tile whose last row is before k0 sees none of the
    // block's keys, and k0 is a multiple of M.
    pr.t0 = causal ? k0 / M : 0;
    pr.stage = pr.produced = 0;
    pr.phase = 0;
    pr.ended = false;
    pr.lo = pr.hi = 0;
    if (pr.t0 < pr.n_q) {
      pr.scan(ids, sq, b_lo, b_hi, lane);
    } else {
      pr.tiles = pr.todo = 0;
      pr.hg = groups;
    }
  }

  const float scale_log2 = scale * kLog2e;
  constexpr int DW = C::kDW;
  float dka[DW / 2], dva[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;

  const uint32_t k_s = base + (wk0 - k0) * P::kBytes;
  const uint32_t v_s = base + C::kVOff + (wk0 - k0) * P::kBytes;
  // kSplitD: this warpgroup's dO and Q columns start dc0 / 64 panels on.
  const uint32_t col_off = dc0 / P::kPanel * M * P::kBytes;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0;; ++it) {
    if (warp == 0) {
      // Keep up to C::kStages items in flight: fill every freed stage, and wait
      // for one only when item `it` itself is still missing.
      while (!pr.ended && pr.produced < it + C::kStages) {
        const uint32_t empty = empty_bar + 8 * pr.stage;
        if (pr.produced == it) {
          ring_wait(empty, pr.phase ^ 1);
        } else if (!__shfl_sync(0xffffffffu, mbar_test(empty, pr.phase ^ 1), 0)) {
          break;
        }
        int* slot = slots + pr.stage * C::kSlotInts;
        const uint32_t full = full_bar + 8 * pr.stage;
        if (!pr.next(ids, sq, b_lo, b_hi, groups, lane)) {
          // End of the ring: a slot with q0 = -1.
          if (lane == 0) slot[0] = -1;
          mbar_arrive(full);
          if (lane == 0) mbar_arrive(full);
          pr.ended = true;
        } else {
          const int src = __ffs(pr.todo) - 1;
          pr.todo &= pr.todo - 1;
          const int q0 = (pr.t0 + src) * M;
          const int lo = __shfl_sync(0xffffffffu, pr.lo, src);
          const int hi = __shfl_sync(0xffffffffu, pr.hi, src);
          const int h = kh * groups + pr.hg;
          const long row = (static_cast<long>(b) * heads + h) * sq;
          const uint32_t slot_s = slots_s + pr.stage * C::kSlotInts * 4;
#pragma unroll
          for (int j = 0; j < M / 32; ++j) {
            const int i = q0 + j * 32 + lane;
            const int in = i < sq ? 4 : 0;  // rows past Sq: zeros (their Q and dO are 0)
            const int ic = i < sq ? i : sq - 1;
            cp_async4(slot_s + 4 * (C::kLseAt + j * 32 + lane), lse + row + ic, in);
            cp_async4(slot_s + 4 * (C::kDeltaAt + j * 32 + lane), delta + row + ic, in);
            // A tile of one id needs no copy of its ids: the consumers take lo.
            if (ids != nullptr && lo != hi) cp_async4(slot_s + 4 * (4 + j * 32 + lane), ids + ic, in);
          }
          cp_async_arrive(full);
          if (lane == 0) {
            slot[0] = q0;
            slot[1] = lo;
            slot[2] = hi;
            mbar_expect_tx(full, 2 * C::kTileBytes);
#pragma unroll
            for (int p = 0; p < P::kCount; ++p) {
              const uint32_t off = pr.stage * C::kTileBytes + p * M * P::kBytes;
              tma_load(base + C::kQOff + off, &tm_q, full, p * P::kPanel, h, q0, b);
              tma_load(base + C::kDoOff + off, &tm_do, full, p * P::kPanel, h, q0, b);
            }
          }
        }
        ++pr.produced;
        if (++pr.stage == C::kStages) {
          pr.stage = 0;
          pr.phase ^= 1;
        }
      }
    }

    // ---- S^T, dP^T, P^T, dS^T; dV += P^T.dO, dK += dS^T.Q. ----
    if (it == 0) ring_wait(kv_bar, 0);
    ring_wait(full_bar + 8 * stage, phase);
    const int* slot = slots + stage * C::kSlotInts;
    const int q0 = slot[0];
    if (q0 < 0) break;
    const int q_lo = slot[1], q_hi = slot[2];
    const int q_last = min(sq, q0 + M) - 1;
    // The warpgroup's own test: the block's tile may miss its 64 keys.
    const bool visit = w_last >= wk0 && (!causal || q_last >= wk0) &&
                       (ids == nullptr || (q_lo <= w_hi && q_hi >= w_lo));
    if (visit) {
      const uint32_t q_s = base + C::kQOff + stage * C::kTileBytes;
      const uint32_t do_s = base + C::kDoOff + stage * C::kTileBytes;
      const float* lses = reinterpret_cast<const float*>(slot) + C::kLseAt;
      const float* dls = reinterpret_cast<const float*>(slot) + C::kDeltaAt;
      const bool mixed = ids != nullptr && !(q_lo == q_hi && w_lo == w_hi && q_lo == w_lo);
      float s[M / 2], dp[M / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss<M, kF16>(s, desc_k<D>(k_s, KN, ks), desc_k<D>(q_s, M, ks), ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss<M, kF16>(dp, desc_k<D>(v_s, KN, ks), desc_k<D>(do_s, M, ks), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T still runs
      fence_regs<M / 2>(s);

      // P^T = 2^(S^T scale log2 e - lse log2 e) with lse per column, in
      // place; masks only across the diagonal or a document edge (rows
      // past Sq have zero Q and dO, keys past Skv are never stored).
      const bool cross = causal && w_last > q0;
      if (cross || mixed) {
#pragma unroll
        for (int i = 0; i < M / 8; ++i) {
          const int c = 8 * i + 2 * t;  // this thread's columns c, c + 1 of the tile
          const float2 l = *reinterpret_cast<const float2*>(lses + c);
          int2 qid = make_int2(q_lo, q_lo);
          if (q_lo != q_hi) qid = *reinterpret_cast<const int2*>(slot + 4 + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = q0 + c + (e & 1);
            float x = s[4 * i + e] * scale_log2;
            if ((causal && (e < 2 ? key0 : key1) > col) ||
                (ids != nullptr && ((e & 1) ? qid.y : qid.x) != (e < 2 ? kseg0 : kseg1))) {
              x = kNegInf;
            }
            s[4 * i + e] = exp2f(x - ((e & 1) ? l.y : l.x) * kLog2e);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < M / 8; ++i) {
          const float2 l = *reinterpret_cast<const float2*>(lses + 8 * i + 2 * t);
          const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
          s[4 * i] = exp2f(s[4 * i] * scale_log2 - l0);
          s[4 * i + 1] = exp2f(s[4 * i + 1] * scale_log2 - l1);
          s[4 * i + 2] = exp2f(s[4 * i + 2] * scale_log2 - l0);
          s[4 * i + 3] = exp2f(s[4 * i + 3] * scale_log2 - l1);
        }
      }
      wgmma_wait<0>();
      fence_regs<M / 2>(dp);

      // P^T and dS^T = P^T (dP^T - delta) as bf16 (float16) A fragments: K-step kk
      // covers rows 16 kk .. 16 kk + 15 of the tile.
      uint32_t pf[M / 4], dsf[M / 4];
#pragma unroll
      for (int i = 0; i < M / 8; ++i) {
        const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * i + 2 * t);
        pf[2 * i] = pack2<kF16>(s[4 * i], s[4 * i + 1]);
        pf[2 * i + 1] = pack2<kF16>(s[4 * i + 2], s[4 * i + 3]);
        dsf[2 * i] = pack2<kF16>(s[4 * i] * (dp[4 * i] - dl.x),
                                 s[4 * i + 1] * (dp[4 * i + 1] - dl.y));
        dsf[2 * i + 1] = pack2<kF16>(s[4 * i + 2] * (dp[4 * i + 2] - dl.x),
                                     s[4 * i + 3] * (dp[4 * i + 3] - dl.y));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < M / 16; ++kk) {
        wgmma_rs<DW, kF16>(dva, pf + 4 * kk, desc_mn<D>(do_s + col_off, M, kk));
        wgmma_rs<DW, kF16>(dka, dsf + 4 * kk, desc_mn<D>(q_s + col_off, M, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DW / 2>(dva);
      fence_regs<DW / 2>(dka);
      fence_regs<M / 4>(pf);  // the A fragments stay live until here
      fence_regs<M / 4>(dsf);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  const long kv_stride = static_cast<long>(kv_heads) * D;
  const long off = static_cast<long>(b) * skv * kv_stride + static_cast<long>(kh) * D;
  uint16_t* dkb = dk + off;
  uint16_t* dvb = dv + off;
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) {
    const int c = dc0 + 8 * i + 2 * t;
    if (key0 < skv) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * kv_stride + c) =
          pack2<kF16>(dka[4 * i] * scale, dka[4 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key0 * kv_stride + c) =
          pack2<kF16>(dva[4 * i], dva[4 * i + 1]);
    }
    if (key1 < skv) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * kv_stride + c) =
          pack2<kF16>(dka[4 * i + 2] * scale, dka[4 * i + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key1 * kv_stride + c) =
          pack2<kF16>(dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;
  int batch, sq, skv, heads, kv_heads, causal;
  float scale;
  cudaStream_t stream;
};

// The four tensor maps: q and do with boxes of q_rows rows, k and v of
// kv_rows; float16 elements with kF16, else bf16.
template <int D, bool kF16>
int make_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap* maps) {
  using P = Panels<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool ok =
      make_map(encode, &maps[0], a.q, D, a.heads, a.sq, a.batch, P::kPanel, q_rows, kF16) &&
      make_map(encode, &maps[1], a.k, D, a.kv_heads, a.skv, a.batch, P::kPanel, kv_rows,
               kF16) &&
      make_map(encode, &maps[2], a.v, D, a.kv_heads, a.skv, a.batch, P::kPanel, kv_rows,
               kF16) &&
      make_map(encode, &maps[3], a.dout, D, a.heads, a.sq, a.batch, P::kPanel, q_rows, kF16);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// setmaxnreg moves registers within the block's allocation at launch: a
// build that allocated fewer than 168 a thread would never leave reg_alloc,
// so it is refused.
template <typename Kernel>
int check_regs(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kThreads < 128 * kProducerRegs + kConsumers * kConsumerRegs) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return 0;
}

template <int D, bool kF16>
int launch_dq(const Args& a, void* dq) {
  using C = DqCfg<D>;
  CUtensorMap m[4];
  if (const int err = make_maps<D, kF16>(a, C::kBlockM, C::kBlockN, m)) return err;
  static bool smem_set = false;
  if (!smem_set) {
    if (const int bad = check_regs(flash_bwd_dq_kernel<D, kF16>)) return bad;
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, kF16>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(a.heads, a.batch, (a.sq + C::kBlockM - 1) / C::kBlockM);
  flash_bwd_dq_kernel<D, kF16><<<grid, kThreads, C::kSmemAlloc, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.seg),
      static_cast<uint16_t*>(dq), a.sq, a.skv, a.heads, a.kv_heads, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kF16>
int launch_dkv(const Args& a, void* dk, void* dv) {
  using C = DkvCfg<D>;
  CUtensorMap m[4];
  if (const int err = make_maps<D, kF16>(a, C::kBlockM, C::kBlockN, m)) return err;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, kF16>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(a.kv_heads, a.batch, (a.skv + C::kBlockN - 1) / C::kBlockN);
  flash_bwd_dkv_kernel<D, kF16><<<grid, kConsumers, C::kSmemAlloc, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.seg),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), a.sq, a.skv, a.heads,
      a.kv_heads, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The entry points' bodies: the instance for head_dim and the operand type.
template <bool kF16>
int dispatch_dq(const Args& a, int head_dim, void* dq) {
  switch (head_dim) {
    case 32: return launch_dq<32, kF16>(a, dq);
    case 64: return launch_dq<64, kF16>(a, dq);
    case 128: return launch_dq<128, kF16>(a, dq);
    case 256: return launch_dq<256, kF16>(a, dq);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kF16>
int dispatch_dkv(const Args& a, int head_dim, void* dk, void* dv) {
  switch (head_dim) {
    case 32: return launch_dkv<32, kF16>(a, dk, dv);
    case 64: return launch_dkv<64, kF16>(a, dk, dv);
    case 128: return launch_dkv<128, kF16>(a, dk, dv);
    case 256: return launch_dkv<256, kF16>(a, dk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/do (B, Sq, H, D), k/v (B, Skv, K, D) bf16 contiguous and 16-byte
// aligned; lse/delta (B, H, Sq) f32; seg (B, S) int32 or null; dq like q.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ditl_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* seg, void* dq,
                                      int batch, int sq, int skv, int heads,
                                      int kv_heads, int head_dim, int causal,
                                      float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, batch, sq, skv, heads, kv_heads,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch_dq<false>(a, head_dim, dq);
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
  return dispatch_dkv<false>(a, head_dim, dk, dv);
}

// K2a-f16: as ditl_flash_bwd_dq_bf16 with q, k, v, do and dq float16.
extern "C" int ditl_flash_bwd_dq_f16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, const void* seg, void* dq,
                                     int batch, int sq, int skv, int heads,
                                     int kv_heads, int head_dim, int causal,
                                     float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, batch, sq, skv, heads, kv_heads,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch_dq<true>(a, head_dim, dq);
}

// K2b-f16: as ditl_flash_bwd_dkv_bf16 with q, k, v, do, dk and dv float16.
extern "C" int ditl_flash_bwd_dkv_f16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* seg, void* dk,
                                      void* dv, int batch, int sq, int skv,
                                      int heads, int kv_heads, int head_dim,
                                      int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, batch, sq, skv, heads, kv_heads,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch_dkv<true>(a, head_dim, dk, dv);
}
