// Persistent, warp-specialised GEMM core for Hopper (sm_90a), on the
// helpers of hopper.cuh (mbarriers, wgmma descriptors, the driver-entry-point
// tensor-map encoder). The MLP backward's kernels (mlp_bwd.cu: K5a, K5b) and
// the projection backward (projection_bwd.cu: K6) are built on it; K5b and K6
// are one kernel, proj_bwd_kernel below, the backward of a product x . w.
//
// A block is 384 threads: two consumer warpgroups (warps 0-7) and a producer
// warpgroup (warps 8-11) of which one thread works. setmaxnreg gives the
// consumers 232 registers a thread and the producer 40. The block computes
// 128 x 256 output tiles, each consumer warpgroup 64 rows of it with one
// wgmma m64n256k16 per 16-deep k-step (128 f32 accumulators a thread).
//
// Operands come from 2-D tensor maps (row stride given, boxes of 64 x 64
// bf16 with the 128-byte swizzle) through a ring of 4 stages under full/empty
// mbarriers; a stage is one k-tile of 64: A (128 x 64, two 8 KB boxes) and B
// (256 x 64, four boxes), 48 KB, 192 KB for the ring. Either operand is
// K-major (the contraction axis contiguous: activation gradients, g . w^T)
// or MN-major (the contraction running down the rows: weight gradients,
// x^T . g over the tokens); wgmma reads both forms from shared memory
// (imm-trans-a / imm-trans-b = 1 for MN-major). Box j of a stage holds rows
// 64j.. of a K-major operand or columns 64j.. of an MN-major one, so the
// warpgroup wg reads A's box wg in both forms. Rows and columns past a
// tensor's edge arrive as zeros (TMA's fill), which covers the ragged token
// edge on every axis it appears and a 256-wide tile overhanging D or F.
//
// Outputs leave by TMA too: a consumer warpgroup writes its 64 rows of a
// tile as bf16 into two epilogue boxes (32 KB beside the ring, the same
// swizzle, so the warp's writes reach 32 banks) 128 columns at a time, and
// its leader stores them; the output's map clips what lies past its edge.
// Stored from registers instead (a 4-byte pair a thread, half-used
// sectors), the core and K5a ran markedly slower on the card.
// chip_smoke.py times the core alone at the K5 kernels' products.
//
// Persistent grid: one block per SM; the producer takes tiles from an atomic
// counter in a zeroed scratch (so a kernel can hand out every tile of one
// role before any of another, whatever number of blocks is resident) and
// writes each tile's index into the ring slot of its k-tiles; the consumers
// read it there, run the products and the tile's epilogue, while the
// producer already fills the ring with the next tile. Tiles of one role go
// in grouped order (raster): kGroup column tiles at a time, the column index
// fastest, so the blocks in flight share operand rows and columns in L2.
//
// The element type is a template parameter (kF16) of the products, the
// epilogue and the kernels: bf16 (false) or float16 (true), the same wgmma
// shape with .f16 operands in place of .bf16, the same 2-byte boxes and
// swizzle, the tensor maps' element type and the epilogue's rounding
// (hopper.cuh's pack2). The bf16 instances keep their code and bits
// (chip_smoke.py K5_DIGESTS).
//
// Each source that includes this is one translation unit of its own; the
// helpers sit in an anonymous namespace.

#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace {
namespace sm90 {

constexpr int kBM = 128;                    // output tile rows
constexpr int kBN = 256;                    // output tile columns
constexpr int kBK = 64;                     // contraction per k-tile
constexpr int kStages = 4;                  // ring depth
constexpr int kGroup = 8;                   // column tiles per raster group
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kBox = 64 * 64 * 2;           // one TMA box: 64 x 64 bf16, 8 KB
constexpr int kABytes = 2 * kBox;
constexpr int kStageBytes = kABytes + 4 * kBox;  // A 16 KB + B 32 KB
constexpr int kEpiOff = kStages * kStageBytes;   // two boxes per consumer warpgroup
constexpr int kBarOff = kEpiOff + 4 * kBox;      // full[s], then empty[s]
constexpr int kSlotOff = kBarOff + 2 * kStages * 8;
constexpr int kSmem = kSlotOff + kStages * 4;
constexpr int kSmemAlloc = kSmem + 1024;         // room to align the base
constexpr int kEmptyArrivals = kConsumers / 32;  // one per consumer warp
// Registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168,
// the block's allocation at launch.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// One 64 x 64 box of a 2-D tensor map at (column c0, row c1).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// m64n256k16, bf16 (or, kF16, float16) in, f32 sums d[128]; A and B from
// shared memory, each K-major (0) or MN-major (1); scale_d = 0 overwrites d.
// The asm is a macro of the operand type's name T.
#define DITL_WGMMA_N256(T)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." T "." T " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "  \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "  \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "  \
      "%120, %121, %122, %123, %124, %125, %126, %127}, "  \
      "%128, %129, p, 1, 1, %131, %132;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),  \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),  \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),  \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),  \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),  \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),  \
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),  \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),  \
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),  \
        "+f"(d[126]), "+f"(d[127])  \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB))

template <int kTA, int kTB, bool kF16>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kF16) DITL_WGMMA_N256("f16");
  else DITL_WGMMA_N256("bf16");
}

// Descriptor of k-step ks (16 deep) of one operand's boxes in a stage:
// K-major, rows of 128 swizzled bytes, the k-step 32 bytes along them;
// MN-major, 64 columns a box (boxes 8 KB apart), the k-step 16 rows down.
template <bool kMN>
__device__ __forceinline__ uint64_t desc(uint32_t box, int ks) {
  return kMN ? make_desc(box + ks * 2048, kBox, 1024, 1) : make_desc(box + ks * 32, 16, 1024, 1);
}

// A tile of some role: its output's first row and column, and its k-tiles.
struct Tile {
  int role, m0, n0, nk;
};

// Tile i of a tiles_m x tiles_n grid in grouped order: kGroup columns at a
// time, the column index fastest within the group.
__device__ __forceinline__ void raster(int i, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = kGroup * tiles_m;
  const int group = i / per_group;
  const int first = group * kGroup;
  const int width = min(kGroup, tiles_n - first);
  const int j = i - group * per_group;
  tn = first + j % width;
  tm = j / width;
}

// The ring as one thread's side sees it: its next stage and that stage's
// phase parity. Everything lives at fixed offsets from the aligned base (a
// shared-memory address), so a thread keeps three registers for it.
struct Ring {
  uint32_t base;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  __device__ __forceinline__ uint32_t full_of(int s) const { return base + kBarOff + 8 * s; }
  __device__ __forceinline__ uint32_t empty_of(int s) const {
    return base + kBarOff + 8 * (kStages + s);
  }
  __device__ __forceinline__ uint32_t full() const { return full_of(stage); }
  __device__ __forceinline__ uint32_t empty() const { return empty_of(stage); }
  __device__ __forceinline__ uint32_t slot() const { return base + kSlotOff + 4 * stage; }
  __device__ __forceinline__ uint32_t a_box(int wg) const {
    return base + stage * kStageBytes + wg * kBox;
  }
  __device__ __forceinline__ uint32_t b_box() const {
    return base + stage * kStageBytes + kABytes;
  }
};

// Aligns the dynamic shared memory, initialises the barriers (thread 0) and
// syncs the block.
__device__ __forceinline__ Ring ring_init(uint8_t* smem_raw) {
  const Ring r{(smem_addr(smem_raw) + 1023u) & ~1023u, 0, 0};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full_of(s), 1);
      mbar_init(r.empty_of(s), kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Producer: the tile's nk k-tiles into the ring, each stage tagged with the
// tile's index; hook(kt) runs after k-tile kt is issued. A K-major box is
// (k, row), an MN-major one (column, k).
template <bool kMNA, bool kMNB, typename Hook>
__device__ __forceinline__ void produce(Ring& r, const CUtensorMap* ma, const CUtensorMap* mb,
                                        const Tile& t, int index, Hook&& hook) {
  for (int kt = 0; kt < t.nk; ++kt) {
    ring_wait(r.empty(), r.phase ^ 1);
    sts32(r.slot(), static_cast<uint32_t>(index));
    __threadfence_block();
    const uint32_t bar = r.full();
    const int k0 = kt * kBK;
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t dst = r.a_box(j);
      if (kMNA) tma_load_2d(dst, ma, bar, t.m0 + 64 * j, k0);
      else tma_load_2d(dst, ma, bar, k0, t.m0 + 64 * j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t dst = r.b_box() + j * kBox;
      if (kMNB) tma_load_2d(dst, mb, bar, t.n0 + 64 * j, k0);
      else tma_load_2d(dst, mb, bar, k0, t.n0 + 64 * j);
    }
    r.advance();
    hook(kt);
  }
}

template <bool kMNA, bool kMNB>
__device__ __forceinline__ void produce(Ring& r, const CUtensorMap* ma, const CUtensorMap* mb,
                                        const Tile& t, int index) {
  produce<kMNA, kMNB>(r, ma, mb, t, index, [](int) {});
}

// One 64 x 64 box of a 2-D tensor map at (column c0, row c1) into L2.
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
               : "memory");
}

// Producer: the end of the ring, a slot of -1.
__device__ __forceinline__ void produce_end(Ring& r) {
  ring_wait(r.empty(), r.phase ^ 1);
  sts32(r.slot(), static_cast<uint32_t>(-1));
  __threadfence_block();
  mbar_arrive(r.full());
}

// Consumer: the index of the next tile (-1 at the end). Leaves the stage
// where it is: consume() starts there.
__device__ __forceinline__ int next_tile(const Ring& r) {
  ring_wait(r.full(), r.phase);
  return static_cast<int>(lds32(r.slot()));
}

// Consumer warpgroup wg: acc = A . B over nk k-tiles, bf16 (float16 with
// kF16) operands. One group of four wgmmas per k-tile stays in flight; a
// stage is released (one arrival per warp) once the products that read it
// are done.
template <bool kMNA, bool kMNB, bool kF16 = false>
__device__ __forceinline__ void consume(Ring& r, int wg, int nk, float* acc) {
  const bool lane0 = (threadIdx.x & 31) == 0;
  int prev = 0;
  for (int kt = 0; kt < nk; ++kt) {
    ring_wait(r.full(), r.phase);
    const uint32_t a = r.a_box(wg), b = r.b_box();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wgmma_n256<kMNA, kMNB, kF16>(acc, desc<kMNA>(a, ks), desc<kMNB>(b, ks), kt > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lane0) mbar_arrive(r.empty_of(prev));
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_regs<128>(acc);
  if (lane0) mbar_arrive(r.empty_of(prev));
}

// One 64 x 64 box from shared memory to a 2-D tensor map at (column c0,
// row c1), in the calling thread's bulk group; the map clips what lies past
// the tensor's edge.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until the thread's bulk groups have written global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders the warpgroup's shared-memory writes before the TMA store that
// reads them, and syncs the warpgroup (named barrier 1 + wg).
__device__ __forceinline__ void wg_publish(int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// The calling consumer thread's place in a box of 64 rows of 128 swizzled
// bytes: its column pair 8 j + 2 (lane % 4) of row rl = 16 (warp % 4) +
// lane / 4 (+ 8 h) sits at at(j, h), chunk j of the row landing at j ^ (rl
// % 8). The 32 lanes of a warp reach 32 different banks. Accumulator d[4i +
// 2h + e] of an m64nN product is that row, column 8i + 2 (lane % 4) + e.
struct BoxPos {
  uint32_t base;  // row rl, chunk 0 ^ (rl % 8), the lane's pair
  __device__ __forceinline__ BoxPos() {
    const int lane = threadIdx.x & 31;
    const int rl = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    base = rl * 128 + ((rl & 7) << 4) + 4 * (lane & 3);
  }
  __device__ __forceinline__ uint32_t at(int j, int h) const {
    return (base ^ (j << 4)) + 1024 * h;
  }
};

// The warpgroup's 64 rows of a tile as bf16 (float16 with kF16), through its
// two epilogue boxes 128 columns at a time, stored by TMA (the map clips rows
// and columns past the output's edge).
template <bool kF16 = false>
__device__ __forceinline__ void store_acc(const float* acc, const Ring& r, const CUtensorMap* map,
                                          const Tile& t, int wg) {
  const BoxPos pos;
  const uint32_t buf = r.base + kEpiOff + 2 * wg * kBox;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 16 * half + i;  // column group: columns 8c + 2t, + 1
        sts32(buf + (i / 8) * kBox + pos.at(i % 8, h),
              pack2<kF16>(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]));
      }
    }
    wg_publish(wg);
    if ((threadIdx.x & 127) == 0) {
      tma_store_2d(map, buf, t.n0 + 128 * half, t.m0 + 64 * wg);
      tma_store_2d(map, buf + kBox, t.n0 + 128 * half + 64, t.m0 + 64 * wg);
      bulk_commit();
      bulk_wait_read();
    }
    wg_sync(wg);  // the boxes are free again
  }
}

// Producer: waits until *count reaches target (acquire, GPU scope), then
// orders the async proxy (TMA) after it. Traps after seconds of polling.
__device__ __forceinline__ void wait_count(const int* count, int target) {
  for (uint32_t polls = 0;; ++polls) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
    if (v >= target) break;
    if (polls == (1u << 24)) __trap();
    __nanosleep(128);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The leader thread of a consumer warpgroup, after the TMA stores of a
// tile: waits until they are written, orders them (async proxy) before its
// generic accesses, and adds one to *count (GPU-scope release).
__device__ __forceinline__ void signal_count(int* count) {
  bulk_wait();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(count) : "memory");
}

}  // namespace sm90

// (rows, cols) bf16 (float16 with f16) with row stride ld elements as a 2-D
// tensor map with 64 x 64 boxes and the 128-byte swizzle; coordinates past
// the edge read as zeros. ld * 2 must be a multiple of 16 and ptr 16-byte
// aligned.
bool make_map_2d(EncodeTiled encode, CUtensorMap* map, const void* ptr, long rows, long cols,
                 long ld, bool f16 = false) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {2ull * static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type =
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The device's SM count (the persistent grid's size), read once; 0 if the
// runtime cannot say.
int num_sms() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 0;
    }
  }
  return sms;
}

// setmaxnreg moves registers within the block's allocation at launch: a
// build that allocated fewer than 168 a thread would never leave reg_alloc,
// so it is refused. Sets the kernel's dynamic shared memory.
template <typename Kernel>
int prepare_kernel(Kernel kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * sm90::kThreads <
      128 * sm90::kProducerRegs + sm90::kConsumers * sm90::kConsumerRegs) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm90::kSmemAlloc);
  return static_cast<int>(err);
}

// prepare_kernel once per kernel (the caller's flag), then the SM count.
template <typename Kernel>
int launch_prepare(Kernel kernel, bool& prepared) {
  if (!prepared) {
    if (const int err = prepare_kernel(kernel)) return err;
    prepared = true;
  }
  return num_sms() > 0 ? 0 : static_cast<int>(cudaErrorNoDevice);
}

// ---------------------------------------------------------------------------
// The backward of a product out = x . w, x (N, D), w (D, F), g = d out (N, F):
// dx = g . w^T (role 0: tiles of 128 tokens x 256 of D, contracting F, g and
// w K-major) and dw = x^T . g (role 1: tiles of 128 of D x 256 of F,
// contracting the N tokens, x and g MN-major). Every output tile is owned by
// one block and summed in one fixed order, so two calls give the same bits.
// The roles share nothing; dx_first says which is handed out first. K5b is
// this with g = dgu, w = w_gu and F = 2F; K6 the attention projections'. kTag
// only names the instance (5 in mlp_bwd.cu, 6 in projection_bwd.cu), so that
// a profile tells K5b's launches from K6's; kF16 picks float16 operands and
// outputs in place of bf16.
// ---------------------------------------------------------------------------

namespace sm90 {

struct ProjMaps {
  CUtensorMap x, g, w, dx, dw;
};

struct ProjArgs {
  int* sched;  // [0] tile counter
  int n, d, f, tiles, dx_first;
};

__device__ __forceinline__ Tile proj_tile(const ProjArgs& p, int t) {
  const int tiles_tok = cdiv(p.n, kBM), tiles_d = cdiv(p.d, kBN);
  const int dx_tiles = tiles_tok * tiles_d, dw_tiles = p.tiles - dx_tiles;
  const bool dx = p.dx_first ? t < dx_tiles : t >= dw_tiles;
  int tm, tn;
  if (dx) {
    raster(p.dx_first ? t : t - dw_tiles, tiles_tok, tiles_d, tm, tn);
    return Tile{0, tm * kBM, tn * kBN, cdiv(p.f, kBK)};
  }
  raster(p.dx_first ? t - dx_tiles : t, p.d / kBM, cdiv(p.f, kBN), tm, tn);
  return Tile{1, tm * kBM, tn * kBN, cdiv(p.n, kBK)};
}

template <int kTag, bool kF16>
__global__ void __launch_bounds__(kThreads, 1)
proj_bwd_kernel(const __grid_constant__ ProjMaps m, const ProjArgs p) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring = ring_init(smem_raw);
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  if (warp >= kConsumers / 32) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      for (;;) {
        const int t = atomicAdd(p.sched, 1);
        if (t >= p.tiles) break;
        const Tile tile = proj_tile(p, t);
        if (tile.role == 0) produce<false, false>(ring, &m.g, &m.w, tile, t);
        else produce<true, true>(ring, &m.x, &m.g, tile, t);
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
      const Tile tile = proj_tile(p, t);
      if (tile.role == 0) {
        consume<false, false, kF16>(ring, wg, tile.nk, acc);
        store_acc<kF16>(acc, ring, &m.dx, tile, wg);
      } else {
        consume<true, true, kF16>(ring, wg, tile.nk, acc);
        store_acc<kF16>(acc, ring, &m.dw, tile, wg);
      }
    }
  }
}

}  // namespace sm90

// dx (N, D) and dw (D, F), contiguous, from x (N, D) at row stride ld_x, w
// (D, F) contiguous and g (N, F) at row stride ld_g, all bf16 (float16 with
// kF16); sched one zeroed int. D and F multiples of 128, N > 0, every row
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 =
// launched).
template <int kTag, bool kF16>
int proj_bwd_launch(const void* x, const void* w, const void* g, void* dx, void* dw, void* sched,
                    long ld_x, long ld_g, int n, int d, int f, bool dx_first,
                    cudaStream_t stream) {
  using namespace sm90;
  if (n <= 0 || d % kBM || f % kBM) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  ProjMaps m;
  if (!make_map_2d(encode, &m.x, x, n, d, ld_x, kF16) ||
      !make_map_2d(encode, &m.g, g, n, f, ld_g, kF16) ||
      !make_map_2d(encode, &m.w, w, d, f, f, kF16) ||
      !make_map_2d(encode, &m.dx, dx, n, d, d, kF16) ||
      !make_map_2d(encode, &m.dw, dw, d, f, f, kF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ProjArgs a{static_cast<int*>(sched), n, d, f,
                   cdiv(n, kBM) * cdiv(d, kBN) + (d / kBM) * cdiv(f, kBN), dx_first ? 1 : 0};
  static bool prepared = false;
  if (const int err = launch_prepare(proj_bwd_kernel<kTag, kF16>, prepared)) return err;
  proj_bwd_kernel<kTag, kF16>
      <<<std::min(a.tiles, num_sms()), kThreads, kSmemAlloc, stream>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
