// FlashAttention forward (K1) for Hopper (sm_90a): bf16 or float16 in, f32
// sums.
//
// Replaces: ditl_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel driven by _fwd and the public flash_attention). It computes the same
// function: grouped-query attention with an online softmax, a causal mask and
// a segment-id mask, writing o and the per-row log-sum-exp. Entry points:
// ditl_flash_fwd_bf16 and ditl_flash_fwd_f16 (K1-f16: the reference's
// kernel takes any float dtype), one template whose kF16 parameter picks the
// operand type of the wgmma products (.f16 in place of .bf16: the same
// fragment layouts, descriptors and swizzle), of the tensor maps
// (CU_TENSOR_MAP_DATA_TYPE_FLOAT16) and of P's and o's rounding
// (__floats2half2_rn in place of the bf16 pack). Tiles, ring, tile
// skipping, bound and design are the same for both; the bf16 instances keep
// their code and bits (chip_smoke.py K1_DIGESTS).
//
// Bound on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16), each computed
// by chip_smoke.py from its run's inputs (q, k, v and ids read once, o and
// lse written once; 4 D flops per attended pair and head):
// - serving prefill, B=4, S=512, 32/8 heads, D=128, right-padded ids:
//   0.0126 ms, bytes;
// - training, B=4, S=2048, one document per row, causal: 0.139 ms,
//   operations (1.37e11 flops);
// - training, the pipeline's packed rows (5-7 documents a row): 0.0504 ms,
//   bytes (the attended pairs are a fifth of the causal ones).
// Long rows need the tensor cores near their rate; packed rows need the work
// that the mask removes not to be done at all.
//
// Design, and what each point does about that bound:
// - wgmma. A block owns 128 query rows of one head: two consumer
//   warpgroups of 64. S = Q.K^T is wgmma m64nNk16 with Q and K in shared
//   memory; P stays in registers as the A operand of O += P.V (the m64
//   accumulator layout is the A fragment layout), V read as an MN-major B.
// - Key tiles of N = 64 at D = 64 and 128, 128 at D = 32 and 32 at D = 256.
//   A consumer thread holds N/2 scores, D/2 output sums and N/4 bf16 P
//   registers: 112 at D = 128, 80 at D = 64, 112 at D = 32, 152 at D =
//   256. ptxas gives a 288-thread block 168 registers a thread: N = 128 at
//   D = 64 (128 of them, plus addresses and the mask's indices) spilled, and
//   N = 128 at D = 128 (160) cannot fit. N = 64 also keeps the skipping
//   fine-grained at the D the presets train with. At D = 256 the output
//   sums alone are 128 registers, so the key tile shrinks to 32 (S by
//   wgmma m64n32k16), and O += P.V is two m64n128k16 products a k-step
//   (hopper.cuh wgmma_rs<256>); 32-key tiles also keep 4 stages within
//   shared memory (64 KB of Q, 128 KB of K/V ring).
// - An asynchronous ring of 4 K/V stages in dynamic shared memory, filled by
//   TMA (cp.async.bulk.tensor on 4-D tensor maps (d, head, position, batch)
//   encoded on the host) from a producer warp under full/empty mbarriers: the
//   consumers work on the tile that has arrived while the next three load.
//   Rows are stored with the 128-byte swizzle (64 bf16) at D >= 64, the
//   64-byte one (32 bf16) at D = 32; the descriptors use the same mode. Shared
//   memory per block: 166,024 bytes at D = 128, 84,104 at 64, 76,936 at 32,
//   198,232 at 256 (one block per SM: the registers allow one).
// - Tile skipping. The producer loads a key tile only if it is not wholly
//   above the causal diagonal and its segment-id range [min, max] overlaps
//   the block's: disjoint ranges share no id, so this is exact for any ids,
//   sorted or not, and a skipped tile would have added p = 0 under a finite
//   running max. Each tile goes to the consumers with its start and range
//   (and its ids if it holds more than one); each warpgroup applies the same
//   test to its own 64 rows and skips the loaded tiles they do not reach.
//   ditl_tpu_torch/ops/flash_attention.py::tile_schedule is this rule.
// - Masking only where a mask can bite: element by element only on tiles
//   across the diagonal, a document boundary or the ragged key edge;
//   interior tiles go from the product straight to the exponent.
// - Longest causal rows first: blockIdx.z walks the query tiles from the
//   last; heads in blockIdx.x keep the heads of one KV group side by side,
//   sharing K/V tiles through L2.
// - Ragged edges: TMA zero-fills rows past Sq and Skv; keys past Skv get
//   weight exactly 0 (-inf), rows past Sq are not stored.
//
// Semantics kept from the reference: the mask value is the finite
// -2.3819763e38 (the softmax runs in base 2 on scores times scale * log2 e,
// and masked scores take the finite value itself, so a tile fully masked for
// a row gives p = 1 that the next real key's rescale zeroes, never inf - inf);
// q.k is summed in f32 and scaled in f32; p is rounded to bf16 (float16) for
// P.V with f32 sums; rows whose normaliser is 0 write 0; lse = m + log(l) per
// row.
//
// ptxas -v (CUDA 12.9, sm_90a): 139 registers at D = 128, 106 at D = 64,
// 153 at D = 32; no spills, no stack. At D = 256: 168
// registers, 384 bytes spilled (stores; 240 of loads), a 128-byte stack:
// ptxas allocates a 288-thread block no more than 168 a thread, and O's 128
// sums, S's 16 and P's 8 exceed it. Right first; fewer spills (a 64-row
// consumer per block, or the output's halves in turn) are later work.
//
// Tried on the card and dropped (PERF.md, Findings): a persistent grid (one
// block per SM, two Q buffers, the ring running on across work items), the
// two warpgroups taking turns at the tensor cores through named barriers,
// and P.V deferred to issue with the next tile's Q.K^T. Each was slower at
// one document per row; the deferred P.V also spilled at D = 32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes;
// the tensor maps are encoded on the host through cudaGetDriverEntryPoint, so
// the library links against nothing but the CUDA runtime. The device and
// host helpers (mbarriers, TMA, wgmma, make_map) live in hopper.cuh, shared
// with the backward kernels (flash_bwd.cu).

#include <math.h>

#include "hopper.cuh"  // smem/mbarrier/TMA/wgmma helpers, make_map

namespace {

constexpr int kBlockM = 128;                     // query rows per block
constexpr int kConsumers = 256;                  // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;        // + the producer warp
constexpr int kEmptyArrivals = kConsumers / 32;  // one per consumer warp
constexpr float kNegInf = -2.3819763e38f;        // ops/attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Per head dim: the key-tile width, the swizzled row ("panel") the TMA box and
// the wgmma descriptors share, and the shared-memory map. Every tile starts
// on a 1024-byte boundary, the period of the 128-byte swizzle.
template <int D>
struct Cfg {
  static constexpr int kBlockN = D == 32 ? 128 : D == 256 ? 32 : 64;  // keys per K/V tile
  static constexpr int kStages = 4;                     // K/V ring depth
  static constexpr int kPanel = D >= 64 ? 64 : 32;      // bf16 per swizzled row
  static constexpr int kPanelBytes = 2 * kPanel;        // = the swizzle width
  static constexpr int kPanels = D / kPanel;
  static constexpr uint64_t kLayout = kPanelBytes == 128 ? 1 : 2;  // B128 / B64
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kSlotInts = 4 + kBlockN;  // k0, min id, max id, -, ids
  static constexpr int kSlotOff = kVOff + kStages * kTileBytes;
  static constexpr int kBarOff = kSlotOff + kStages * kSlotInts * 4;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8;
  static constexpr int kSmemAlloc = kSmem + 1024;  // room to align the base
};

// Grid (heads, batch, q tiles); block: warps 0-7 are two consumer warpgroups
// of 64 query rows each, warp 8 the producer. Accumulator layout of an
// m64nN product, per warp w of a warpgroup, g = lane / 4, t = lane % 4:
// d[4i + 0, 1] at row 16w + g, columns 8i + 2t, +1; d[4i + 2, 3] at row
// 16w + g + 8.
template <int D, bool kF16>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int sq, int skv,
                 int heads, int kv_heads, int causal, float scale) {
  using C = Cfg<D>;
  constexpr int N = C::kBlockN;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* slots = reinterpret_cast<int*>(smem_raw + (base - raw) + C::kSlotOff);
  const uint32_t full_bar = base + C::kBarOff;  // full[s] at + 8 s
  const uint32_t empty_bar = full_bar + 8 * S;  // empty[s] at + 8 s
  const uint32_t q_bar = empty_bar + 8 * S;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // longest causal rows first
  const int kh = h / (heads / kv_heads);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* ids = seg != nullptr ? seg + static_cast<long>(b) * skv : nullptr;  // Sq == Skv

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kEmptyArrivals);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- Producer: pick the key tiles, fill the ring by TMA. ----
    const int q_last = min(sq, q0 + kBlockM) - 1;
    const int kv_end = causal ? min(skv, q_last + 1) : skv;  // causal: keys <= q_last
    const int n_kv = (kv_end + N - 1) / N;
    int q_lo = 0, q_hi = 0;
    if (ids != nullptr) id_range(ids, q0, q_last + 1, lane, q_lo, q_hi);
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::kQBytes);
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load(base + p * kBlockM * C::kPanelBytes, &tm_q, q_bar, p * C::kPanel, h, q0, b);
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
        k_lo = INT_MAX;
        k_hi = INT_MIN;
        const int* tile = ids + t * N;
        if ((t + 1) * N <= skv && (reinterpret_cast<uintptr_t>(tile) & 15) == 0) {
#pragma unroll
          for (int i = 0; i < N; i += 4) {  // all loads in flight at once
            const int4 x = *reinterpret_cast<const int4*>(tile + i);
            k_lo = min(k_lo, min(min(x.x, x.y), min(x.z, x.w)));
            k_hi = max(k_hi, max(max(x.x, x.y), max(x.z, x.w)));
          }
        } else {
          const int n = min(N, skv - t * N);
#pragma unroll 8
          for (int i = 0; i < n; ++i) {
            k_lo = min(k_lo, tile[i]);
            k_hi = max(k_hi, tile[i]);
          }
        }
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
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
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
          for (int p = 0; p < C::kPanels; ++p) {
            const uint32_t off = stage * C::kTileBytes + p * N * C::kPanelBytes;
            tma_load(base + C::kKOff + off, &tm_k, bar, p * C::kPanel, kh, k0, b);
            tma_load(base + C::kVOff + off, &tm_v, bar, p * C::kPanel, kh, k0, b);
          }
        }
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // End of the ring: a slot with k0 = -1.
    mbar_wait(empty_bar + 8 * stage, phase ^ 1);
    if (lane == 0) {
      slots[stage * C::kSlotInts] = -1;
      __threadfence_block();
      mbar_arrive(full_bar + 8 * stage);
    }
  } else {
    // ---- Consumers: S = Q.K^T, online softmax, O += P.V per tile. ----
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
    // Softmax in base 2 on scores scaled by scale * log2(e) (the finite mask
    // value stands as it is): m is the running row max, l this thread's
    // share of the row sum.
    const float scale_log2 = scale * kLog2e;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const uint32_t q_s = base + wg * 64 * C::kPanelBytes;
    mbar_wait(q_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full_bar + 8 * stage, phase);
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
        float s[N / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks * 16 % C::kPanel) * 2;  // within the panel
          const int p = ks * 16 / C::kPanel;
          const uint64_t da = make_desc(q_s + p * kBlockM * C::kPanelBytes + off, 16,
                                        8 * C::kPanelBytes, C::kLayout);
          const uint64_t db = make_desc(k_s + p * N * C::kPanelBytes + off, 16,
                                        8 * C::kPanelBytes, C::kLayout);
          wgmma_ss<N, kF16>(s, da, db, ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<N / 2>(s);

        // Scale; mask only where a mask can bite: a tile across the causal
        // diagonal, a document boundary or the ragged key edge.
        const bool edge = k0 + N > skv;
        const bool cross = causal && k0 + N - 1 > wq0;
        const bool mixed = ids != nullptr && !(k_lo == k_hi && w_lo == w_hi && k_lo == w_lo);
        if (edge || cross || mixed) {
#pragma unroll
          for (int i = 0; i < N / 8; ++i) {
            const int c = k0 + 8 * i + 2 * t;  // this thread's columns c, c + 1
            int2 key = make_int2(k_lo, k_lo);
            if (k_lo != k_hi) key = *reinterpret_cast<const int2*>(slot + 4 + 8 * i + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = c + (e & 1);
              float x = s[4 * i + e] * scale_log2;
              if (col >= skv) {
                x = -INFINITY;  // not a key at all: weight exactly 0
              } else if ((causal && col > (e < 2 ? row0 : row1)) ||
                         (ids != nullptr && ((e & 1) ? key.y : key.x) != (e < 2 ? seg0 : seg1))) {
                x = kNegInf;
              }
              s[4 * i + e] = x;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < N / 2; ++j) s[j] *= scale_log2;
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = -INFINITY;
#pragma unroll
          for (int j = 0; j < N / 2; j += 4) x = fmaxf(x, fmaxf(s[j + 2 * r], s[j + 2 * r + 1]));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float m_new = fmaxf(m[r], x);
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
        }

        // P = 2^(S - m): f32 for the row sums, bf16 (float16) A fragments for
        // P.V.
        // K-step kk covers keys 16 kk .. 16 kk + 15, s[8 kk .. 8 kk + 7]; its
        // fragment pf[4 kk ..] is (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8,
        // 2t + 8), as the accumulator lays out two n8 column groups.
        uint32_t pf[N / 4];
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < N / 2; j += 4) {
          const float p0 = exp2f(s[j] - m[0]);
          const float p1 = exp2f(s[j + 1] - m[0]);
          const float p2 = exp2f(s[j + 2] - m[1]);
          const float p3 = exp2f(s[j + 3] - m[1]);
          rs[0] += p0 + p1;
          rs[1] += p2 + p3;
          pf[(j >> 1) + 0] = pack2<kF16>(p0, p1);
          pf[(j >> 1) + 1] = pack2<kF16>(p2, p3);
        }
        l[0] = alpha[0] * l[0] + rs[0];
        l[1] = alpha[1] * l[1] + rs[1];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const uint64_t dv = make_desc(v_s + kk * 16 * C::kPanelBytes, N * C::kPanelBytes,
                                        8 * C::kPanelBytes, C::kLayout);
          wgmma_rs<D, kF16>(acc, pf + 4 * kk, dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(acc);
        fence_regs<N / 4>(pf);  // the A fragments stay live until here
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Row sums across the four threads that share a row, then normalise.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (l[r] == 0.f) l[r] = 1.f;  // a row with no weight writes 0
    }
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
    const long q_stride = static_cast<long>(heads) * D;
    uint16_t* ob = o + static_cast<long>(b) * sq * q_stride + static_cast<long>(h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (row0 < sq) {
        *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + c) =
            pack2<kF16>(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      }
      if (row1 < sq) {
        *reinterpret_cast<uint32_t*>(ob + row1 * q_stride + c) =
            pack2<kF16>(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
    }
    if (t == 0) {
      float* lb = lse + (static_cast<long>(b) * heads + h) * sq;
      if (row0 < sq) lb[row0] = m[0] * kLn2 + logf(l[0]);
      if (row1 < sq) lb[row1] = m[1] * kLn2 + logf(l[1]);
    }
  }
}

template <int D, bool kF16>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
           int batch, int sq, int skv, int heads, int kv_heads, int causal, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, D, heads, sq, batch, C::kPanel, kBlockM, kF16) ||
      !make_map(encode, &tm_k, k, D, kv_heads, skv, batch, C::kPanel, C::kBlockN, kF16) ||
      !make_map(encode, &tm_v, v, D, kv_heads, skv, batch, C::kPanel, C::kBlockN, kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, kF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(heads, batch, (sq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<D, kF16><<<grid, kThreads, C::kSmemAlloc, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(seg), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), sq, skv, heads, kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The entry points' body: the instance for head_dim and the operand type.
template <bool kF16>
int dispatch(const void* q, const void* k, const void* v, const void* seg, void* o,
             void* lse, int batch, int sq, int skv, int heads, int kv_heads, int head_dim,
             int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32, kF16>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal,
                              scale, s);
    case 64:
      return launch<64, kF16>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal,
                              scale, s);
    case 128:
      return launch<128, kF16>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal,
                               scale, s);
    case 256:
      return launch<256, kF16>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, causal,
                               scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, K, D) bf16 contiguous and 16-byte aligned;
// seg (B, S) int32 or null; o like q; lse (B, H, Sq) f32. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ditl_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* seg, void* o, void* lse,
                                   int batch, int sq, int skv, int heads,
                                   int kv_heads, int head_dim, int causal,
                                   float scale, void* stream) {
  return dispatch<false>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, head_dim,
                         causal, scale, stream);
}

// K1-f16: as ditl_flash_fwd_bf16 with q, k, v and o float16.
extern "C" int ditl_flash_fwd_f16(const void* q, const void* k, const void* v,
                                  const void* seg, void* o, void* lse,
                                  int batch, int sq, int skv, int heads,
                                  int kv_heads, int head_dim, int causal,
                                  float scale, void* stream) {
  return dispatch<true>(q, k, v, seg, o, lse, batch, sq, skv, heads, kv_heads, head_dim,
                        causal, scale, stream);
}
