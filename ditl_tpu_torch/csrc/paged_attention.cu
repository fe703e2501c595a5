// Paged decode attention for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces two Pallas TPU kernels of ditl_tpu/ops/paged_attention.py:
// - K3 _paged_tail_kernel (with _accumulate_block and _finalize_out), the
//   decode tick's kernel: one query token per slot attends the slot's KV
//   pages through the page table, positions [0, min(starts, lengths)), and
//   then the tick's contiguous tail buffer, positions [starts, lengths);
// - K4 _paged_kernel, the same without a tail: pages up to lengths.
// Entry points: ditl_paged_tail_bf16 (K3) and ditl_paged_bf16 (K4). Both are
// instances of one template, for head_dim 64 and 128, in float pools and
// single-query form (int8 pools and the multi-query verify are not here).
//
// Bound on the card: the kernel is bytes-bound. It must read each live key's
// K and V once per slot that reads it (2 * K * D * 2 bytes per key), the live
// tail, q and o; it does 4 * D flops per (query head, key). At the serving
// shape (8 slots, 32 query / 8 KV heads, D = 128, a few hundred to ~1500 live
// keys per slot) that is a few MB per call: a few microseconds at 3.35 TB/s,
// against well under a microsecond of tensor-core time.
//
// What this design does about it (a first, simple design):
// - No sequential grid. The TPU kernel walks a sequential (slot, page) grid
//   and carries m, l and acc in VMEM. Here one block owns one slot x one KV
//   head, i.e. its G = H / K query rows, and loops itself over the slot's live
//   keys in 64-key tiles, then over the tail. m and l live in shared memory,
//   the output accumulator in registers.
// - Only live keys are read: the loop stops at the last live position, so a
//   reserved but unwritten page costs nothing. The TPU's redirect of dead
//   pages to page 0 is not copied. A tile spans several pages when the page
//   is smaller than 64 tokens; each key row finds its page in the table.
// - K/V tiles are read with 16-byte loads, neighbouring threads on
//   neighbouring addresses, into shared memory rows padded by 8 bf16. Each
//   (query row, key) score is one thread's f32 dot product over D; the p.V
//   product gives each thread one output column.
// - The G query rows of a KV head share every K/V tile (GQA).
// Under-filling is expected: B x K blocks (64 at 8 slots x 8 KV heads) do
// not fill 132 SMs. Splitting a slot's keys over blocks (flash-decoding),
// cp.async / TMA double buffering and tensor-core products are later work.
//
// Semantics kept from the reference: q is scaled in f32 before the f32 q.k
// product; masked columns of a processed tile get the finite -2.3819763e38
// (never -inf); only tiles with a live column are processed; tail column j is
// live when starts + j < lengths; p is rounded to bf16 (v's type) before the
// p.v product, which accumulates in f32, while the row sum l adds the f32 p;
// a row with l == 0 (a dead slot, length 0) writes 0; o is bf16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (ditl_tpu_torch/ops/cuda_build.py). C interface, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys per tile; two per lane in the softmax
constexpr int kMaxGroups = 8;  // query heads per KV head
constexpr float kNegInf = -2.3819763e38f;  // ops/attention.py NEG_INF

__device__ __forceinline__ float bf16_to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;  // padded row, in bf16
  uint16_t k[kTile * kLd];
  uint16_t v[kTile * kLd];
  float q[kMaxGroups * D];  // q * scale, f32
  float p[kMaxGroups * kTile];  // scores, then p rounded to bf16
  float m[kMaxGroups];
  float l[kMaxGroups];
  float alpha[kMaxGroups];
};

// One 64-key tile: columns [base, base + 64) of the slot's sequence, live
// below `limit`; live row r of the tile sits at `src + row_offset(r)`
// (elements), and rows at or past `limit` are neither read nor weighted.
template <int D, typename RowOffset>
__device__ __forceinline__ void accumulate_tile(
    Smem<D>& sm, float* acc, const uint16_t* __restrict__ k_src,
    const uint16_t* __restrict__ v_src, RowOffset row_offset, int base,
    int limit, int groups) {
  constexpr int kLd = Smem<D>::kLd;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLoads = kTile * kChunks / kThreads;
  constexpr int kRowStep = kThreads / D;
  constexpr int kAcc = (kMaxGroups + kRowStep - 1) / kRowStep;
  const int tid = threadIdx.x;

  __syncthreads();  // the previous tile is consumed
  uint4 kx[kLoads], vx[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    kx[i] = vx[i] = make_uint4(0u, 0u, 0u, 0u);
    if (base + r < limit) {
      const long off = row_offset(r);
      kx[i] = *reinterpret_cast<const uint4*>(k_src + off + c);
      vx[i] = *reinterpret_cast<const uint4*>(v_src + off + c);
    }
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    *reinterpret_cast<uint4*>(&sm.k[r * kLd + c]) = kx[i];
    *reinterpret_cast<uint4*>(&sm.v[r * kLd + c]) = vx[i];
  }
  __syncthreads();

  // Scores: one (query row, key) pair per thread and step, f32 dot over D.
  for (int i = tid; i < kTile * groups; i += kThreads) {
    const int r = i % kTile;
    const int g = i / kTile;
    float s = kNegInf;
    if (base + r < limit) {
      const float* qg = &sm.q[g * D];
      const uint16_t* kr = &sm.k[r * kLd];
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        const uint4 w = *reinterpret_cast<const uint4*>(kr + c);
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a += qg[c + 2 * e] * __uint_as_float(u[e] << 16);
          a += qg[c + 2 * e + 1] * __uint_as_float(u[e] & 0xffff0000u);
        }
      }
      s = a;
    }
    sm.p[g * kTile + r] = s;
  }
  __syncthreads();

  // Online softmax, one warp per query row.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int g = warp; g < groups; g += kWarps) {
    const float s0 = sm.p[g * kTile + lane];
    const float s1 = sm.p[g * kTile + lane + 32];
    const float m_prev = sm.m[g];
    const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
    const float p0 = expf(s0 - m_next);
    const float p1 = expf(s1 - m_next);
    const float rs = warp_sum(p0 + p1);
    sm.p[g * kTile + lane] = round_bf16(p0);
    sm.p[g * kTile + lane + 32] = round_bf16(p1);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_next);
      sm.alpha[g] = alpha;
      sm.l[g] = alpha * sm.l[g] + rs;
      sm.m[g] = m_next;
    }
  }
  __syncthreads();

  // acc = acc * alpha + p.V over the tile's live rows (the rest have p = 0).
  const int n_live = min(kTile, limit - base);
  const int d = tid % D;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = tid / D + i * kRowStep;
    if (g < groups) {
      const float* pg = &sm.p[g * kTile];
      float a = acc[i] * sm.alpha[g];
      for (int r = 0; r < n_live; ++r) a += pg[r] * bf16_to_f32(sm.v[r * kLd + d]);
      acc[i] = a;
    }
  }
}

template <int D, bool kTail>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k_pages,
             const uint16_t* __restrict__ v_pages, const int* __restrict__ table,
             const int* __restrict__ lengths, const int* __restrict__ starts,
             const uint16_t* __restrict__ tail_k, const uint16_t* __restrict__ tail_v,
             uint16_t* __restrict__ o, int kv_heads, int groups, int page_size,
             int max_pages, int n_pool, int tail_len, float scale) {
  constexpr int kRowStep = kThreads / D;
  constexpr int kAcc = (kMaxGroups + kRowStep - 1) / kRowStep;
  __shared__ __align__(16) Smem<D> sm;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long row0 = (long)b * kv_heads * groups + (long)kh * groups;  // q row
  const int length = lengths[b];
  const int start = kTail ? starts[b] : length;
  // Keys past the table's last page are absent, as in the reference.
  const int page_limit = min(min(start, length), max_pages * page_size);

  for (int i = tid; i < groups * D; i += kThreads) {
    sm.q[i] = bf16_to_f32(q[row0 * D + i]) * scale;
  }
  if (tid < groups) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // Pages: positions [0, page_limit), each row through the table.
  const int* trow = table + (long)b * max_pages;
  for (int t0 = 0; t0 < page_limit; t0 += kTile) {
    auto page_row = [&](int r) -> long {
      const int pos = t0 + r;
      // Out-of-range page ids clamp into the pool, as JAX's gather does.
      const long pid = min(max(trow[pos / page_size], 0), n_pool - 1);
      return ((pid * kv_heads + kh) * page_size + pos % page_size) * D;
    };
    accumulate_tile<D>(sm, acc, k_pages, v_pages, page_row, t0, page_limit, groups);
  }
  // Tail: positions [start, length), column j = position - start.
  if (kTail) {
    const long tail0 = ((long)b * kv_heads + kh) * tail_len * D;
    const int tail_limit = min(length, start + tail_len);
    for (int j0 = 0; start + j0 < tail_limit; j0 += kTile) {
      auto tail_row = [&](int r) -> long { return tail0 + (long)(j0 + r) * D; };
      accumulate_tile<D>(sm, acc, tail_k, tail_v, tail_row, start + j0, tail_limit,
                         groups);
    }
  }

  __syncthreads();
  const int d = tid % D;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = tid / D + i * kRowStep;
    if (g < groups) {
      const float l = sm.l[g];
      const float out = acc[i] / (l == 0.f ? 1.f : l);
      o[(row0 + g) * D + d] = __bfloat16_as_ushort(__float2bfloat16_rn(out));
    }
  }
}

template <int D, bool kTail>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lengths, const void* starts, const void* tk, const void* tv,
           void* o, int batch, int heads, int kv_heads, int page_size,
           int max_pages, int n_pool, int tail_len, float scale, cudaStream_t stream) {
  paged_kernel<D, kTail><<<dim3(kv_heads, batch), kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(kp),
      static_cast<const uint16_t*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<const uint16_t*>(tk), static_cast<const uint16_t*>(tv),
      static_cast<uint16_t*>(o), kv_heads, heads / kv_heads, page_size, max_pages,
      n_pool, tail_len, scale);
  return (int)cudaGetLastError();
}

template <bool kTail>
int dispatch(const void* q, const void* kp, const void* vp, const void* table,
             const void* lengths, const void* starts, const void* tk,
             const void* tv, void* o, int batch, int heads, int kv_heads,
             int head_dim, int page_size, int max_pages, int n_pool, int tail_len,
             float scale, void* stream) {
  if (batch < 1 || kv_heads < 1 || heads % kv_heads || heads / kv_heads > kMaxGroups ||
      page_size < 1 || max_pages < 1 || n_pool < 1 || (kTail && tail_len < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, kTail>(q, kp, vp, table, lengths, starts, tk, tv, o, batch,
                               heads, kv_heads, page_size, max_pages, n_pool, tail_len,
                               scale, s);
    case 128:
      return launch<128, kTail>(q, kp, vp, table, lengths, starts, tk, tv, o, batch,
                                heads, kv_heads, page_size, max_pages, n_pool, tail_len,
                                scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K3. q (B, H, D); pools (P, K, ps, D) with P = n_pool; table (B, maxp)
// int32; lengths and starts (B,) int32; tails (B, K, T, D); o (B, H, D). bf16
// tensors, all contiguous. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int ditl_paged_tail_bf16(const void* q, const void* k_pages,
                                    const void* v_pages, const void* table,
                                    const void* lengths, const void* starts,
                                    const void* tail_k, const void* tail_v, void* o,
                                    int batch, int heads, int kv_heads, int head_dim,
                                    int page_size, int max_pages, int n_pool,
                                    int tail_len, float scale, void* stream) {
  return dispatch<true>(q, k_pages, v_pages, table, lengths, starts, tail_k, tail_v,
                        o, batch, heads, kv_heads, head_dim, page_size, max_pages,
                        n_pool, tail_len, scale, stream);
}

// K4: the same without a tail; pages up to lengths.
extern "C" int ditl_paged_bf16(const void* q, const void* k_pages, const void* v_pages,
                               const void* table, const void* lengths, void* o,
                               int batch, int heads, int kv_heads, int head_dim,
                               int page_size, int max_pages, int n_pool, float scale,
                               void* stream) {
  return dispatch<false>(q, k_pages, v_pages, table, lengths, nullptr, nullptr,
                         nullptr, o, batch, heads, kv_heads, head_dim, page_size,
                         max_pages, n_pool, 0, scale, stream);
}
