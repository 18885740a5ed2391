// Whisper encoder self-attention for Hopper (sm_90a): bf16 tensor-core
// products with f32 accumulation and f32 softmax statistics. Two entry
// points share one attention phase:
//
//  * freud_qkv_attention replaces the Pallas TPU kernel
//    freud_tpu/ops/attention.py (fused_qkv_attention →
//    _fused_qkv_attention_impl → _qkv_attn_kernel): per head
//    softmax((x·Wq + bq)·dh^-½ · (x·Wk)ᵀ) · (x·Wv + bv), k without bias,
//    heads concatenated; the caller applies the out-projection. x (b, s, d)
//    f32 or bf16, W (d, d) used as bf16, bq and bv f32, output in x's dtype.
//  * freud_whisper_attention replaces the Pallas TPU kernel
//    freud_tpu/ops/attention.py (whisper_attention → _whisper_attention_impl
//    → _kernel): softmax(bf16(q·dh^-½) · bf16(k)ᵀ) · bf16(v) over (b, h, s, 64)
//    strided views, f32 or bf16, output in the input's dtype. The medium and
//    large encoders (d > 768) take it, with q/k/v projected outside.
//
// What bounds it on an H100: per (clip, head) at s 1500 the two products are
// 4·s²·64 = 576 MFLOP of bf16 work and the softmax 2.25 M exponentials on
// f32 scores; the score matrix (9 MB of f32 per head) must not reach device
// memory. At head_dim 64 the exponentials on the f32 scores take about as
// long on the SM's exp units as the products on the tensor cores, so the
// bound is the tensor-core rate and the design overlaps the two.
//
// Why not the TPU design: the TPU kernel keeps one head's whole K and V
// ((1536 × 64) each) resident in VMEM next to a 512-row q tile and takes the
// softmax over full score rows. K and V of one head in bf16 alone take 384 KB
// against a Hopper block's 227 KB of shared memory, so the attention phase
// is flash-style: K/V stream through shared memory in 128-key tiles and the
// softmax statistics are kept online.
//
// The fused path's projection is 2·b·s·d·3d of bf16 products (42.5 GFLOP at
// (32, 1500, 384), 43 µs at the tensor-core peak) over ~150 MB of operand
// and q/k/v traffic: it has to run on wgmma, fed by TMA, to stay under the
// attention phase it feeds. At K = d = 384 a tile's products take ~2.5 µs,
// so its epilogue weighs as much as its main loop.
//
// Design:
//   (a) fused path only, two launches. prep_kernel packs [Wq | Wk | Wv] as
//       one K-major (3d, d) bf16 matrix from the caller's (d_in, d_out)
//       views (every call: the packing is part of the kernel's time) and,
//       for f32 x, rounds x to bf16 scratch (TMA copies bytes as they are;
//       bf16 x is read in place). qkv_projection_kernel is one GEMM
//       x(b·s, d) · W(d, 3d) on 128 × 192 output tiles (3d / 192 = heads
//       column tiles, so no ragged column tile), persistent: a producer
//       warp streams 64-wide K slices of both operands (128-byte swizzle)
//       by TMA through a 4-stage ring that runs on across a block's tiles,
//       so the next tile loads during this one's epilogue; two consumer
//       warpgroups of 64 rows issue m64n192k16 from shared memory. The
//       epilogue applies the contract's rounding — q = bf16((x·Wq +
//       bq)·dh^-½), k = bf16(x·Wk), v = bf16(x·Wv + bv) — with [bq | 0 |
//       bv] read from shared memory (loaded once a block; gathered from
//       global memory a column pair at a time it cost more than the
//       products) and writes q, k, v into (3, b, s, d) bf16 scratch through
//       a dedicated shared-memory stage in 16-byte pieces.
//   (b) to_bf16_kernel (whisper path, f32 input only): TMA copies bytes as
//       they are, so f32 head views are first rounded to bf16 scratch
//       (b, h, s, 64) in one elementwise pass (the conversion is part of the
//       kernel's time). bf16 head views are read in place.
//   (c) attention_kernel: persistent blocks, one an SM, each walking work
//       items of (128 query rows, head, clip) with three roles, so one
//       item's loads overlap the last one's epilogue. A producer warp
//       issues TMA loads through 4-D tensor maps over (64, s, h, b) — the
//       head views' own strides, so no copy splits the heads — first the
//       Q tile, then 128-key K and V tiles into a ring of kStages stages,
//       each stage handed over by a "full" mbarrier (TMA transaction bytes)
//       and returned by an "empty" one.
//       Two consumer warpgroups own 64 query rows each: S = Q·Kᵀ by wgmma
//       from shared memory (m64n128k16), the online softmax on the f32
//       accumulators (one FFMA and one exp2 a score: scores and max are
//       scaled by dh^-½·log2 e inside the exponent), P re-packed to
//       bf16 in registers as the A operand of O += P·V (m64n64k16, V read
//       MN-major with the transpose bit). A warpgroup's softmax of key
//       tile j overlaps its own P·V of tile j − 1, and the other
//       warpgroup's products keep the tensor cores busy too. O is
//       divided by the row sums once and written through the output's
//       strides, (b, s, h, 64) memory for a (b, h, s, 64) view.
// The q scale: bf16(q·scale) with the scale applied in f32 before the cast,
// as the contract asks; for a power-of-two scale (dh^-½ = 1/8, or 1 for the
// fused path's pre-scaled q) that equals bf16(q)·scale exactly, so the scale
// is applied to the f32 scores together with log2 e and q is never rescaled.
// The launcher refuses any other scale.
// s = 1500 is no multiple of the tiles: TMA fills rows past s with zeros,
// keys past s get −∞ scores, rows past s are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kHeadDim = 64;

// two bf16 (lo = lower column) as one 32-bit fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// eight neighbouring f32 (16-byte aligned) as eight bf16 in 16 bytes
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Element strides of a (b, h, s, 64) view whose head_dim is contiguous.
// Within one (clip, head) the offsets fit 32 bits (the wrapper checks).
struct HeadStrides {
  long long b, h;
  int s;
};

struct AttnArgs {
  HeadStrides q, k, v, out;
  int seq;
  float q_scale;  // q's scale, a power of two (see the header)
  int stable;     // 1: subtract the running row max before exp
};

constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // and one producer warp

// ---------------------------------------------------------------- phase (a)
constexpr int kProjBM = 128;   // x rows a tile: 64 per consumer warpgroup
constexpr int kProjBN = 192;   // output columns a tile: 3d / 192 = heads tiles
constexpr int kProjBK = 64;    // one 128-byte swizzle row of bf16
constexpr int kProjStages = 4;
constexpr int kGroup = 8;      // row tiles walked together (L2 reuse of x)

// Operand preparation, one launch: eight weights or sixteen x a thread. The
// packed weight wt (3d, d) bf16: row n is output column n of [Wq | Wk | Wv],
// K contiguous — the projection's K-major B operand — read from three
// (d_in, d_out) f32 views with element strides `ws` (the model passes
// nn.Linear's (out, in) weights transposed, so K is read contiguously). For
// f32 x also xb (m, d) = bf16(x): TMA copies bytes as they are.
struct WeightStrides {
  long long s[6];  // (d_in, d_out) element strides of Wq, Wk, Wv
};

__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
            const float* __restrict__ wv, const WeightStrides ws, int d,
            __nv_bfloat16* __restrict__ wt, const float* __restrict__ x,
            long long x_chunks, __nv_bfloat16* __restrict__ xb) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  const long long w_chunks = 3ll * d * (d / 8);
  if (i < w_chunks) {
    const int n = static_cast<int>(i / (d / 8));
    const int k0 = 8 * static_cast<int>(i % (d / 8));
    const int which = n / d;
    const float* w = which == 0 ? wq : which == 1 ? wk : wv;
    const long long s0 = ws.s[2 * which], s1 = ws.s[2 * which + 1];
    w += (n - which * d) * s1 + k0 * s0;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = w[e * s0];
    *reinterpret_cast<uint4*>(wt + (size_t)n * d + k0) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
    return;
  }
  const long long j = i - w_chunks;  // x: sixteen elements, four loads in flight
  if (j < x_chunks) {
    const uint4 lo = load8(x + 16 * j);
    const uint4 hi = load8(x + 16 * j + 8);
    *reinterpret_cast<uint4*>(xb + 16 * j) = lo;
    *reinterpret_cast<uint4*>(xb + 16 * j + 8) = hi;
  }
}

constexpr int kPitch = kProjBN + 8;  // bf16 a staged output row (padded: no bank conflicts)
constexpr int kMaxFusedD = 768;      // the fused path's widest d (Whisper small)

struct ProjSmem {  // every tile 1024-byte aligned (the swizzle atom)
  __nv_bfloat16 a[kProjStages][kProjBM * kProjBK];
  __nv_bfloat16 b[kProjStages][kProjBN * kProjBK];
  __nv_bfloat16 out[kProjBM * kPitch];  // the output tile on its way out
  float bias[3 * kMaxFusedD];           // [bq | 0 | bv], the epilogue's
  uint64_t full[kProjStages];
  uint64_t empty[kProjStages];
};
constexpr size_t kProjSmem = sizeof(ProjSmem) + 1024;  // + alignment slack

// xb (m, d) bf16 · wtᵀ → qkv (3, m, d) bf16, the contract's rounding: q =
// bf16((x·Wq + bq)·scale), k = bf16(x·Wk), v = bf16(x·Wv + bv). xmap: tensor
// map (d, m), box (64, 128); wmap: (d, 3d), box (64, 192). Persistent: block
// b takes output tiles b, b + gridDim.x, ... (kGroup row tiles at a time
// across all column tiles, so the x tiles are reused from L2). A producer
// warp streams 64-wide K slices of both operands through a ring of
// kProjStages stages that runs on across tiles, so the next tile's slices
// load while this one's epilogue runs; two consumer warpgroups of 64 rows
// each issue m64n192k16 from shared memory, one group of products in flight
// while the next slice's barrier is awaited.
__global__ void __launch_bounds__(kThreads, 1)
qkv_projection_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ bq, const float* __restrict__ bv,
                      __nv_bfloat16* __restrict__ qkv, int m, int d, float scale) {
  extern __shared__ unsigned char smem_raw[];
  ProjSmem& sm = *reinterpret_cast<ProjSmem*>(hopper::align1024(smem_raw));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_m = (m + kProjBM - 1) / kProjBM;
  const int tiles_n = 3 * d / kProjBN;
  const int tiles = tiles_m * tiles_n;
  const int k_tiles = d / kProjBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kProjStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ------------------------------ producer
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int tm, tn;
        hopper::grouped_tile(tile, tiles_m, tiles_n, kGroup, tm, tn);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int st = it % kProjStages;
          if (it >= kProjStages) hopper::mbar_wait(&sm.empty[st], ((it / kProjStages) & 1) ^ 1);
          hopper::mbar_expect_tx(&sm.full[st], (kProjBM + kProjBN) * kProjBK * 2);
          hopper::tma_load_2d(sm.a[st], &xmap, &sm.full[st], kt * kProjBK, tm * kProjBM);
          hopper::tma_load_2d(sm.b[st], &wmap, &sm.full[st], kt * kProjBK, tn * kProjBN);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;
  const int wt = threadIdx.x % 128;  // thread in the warpgroup
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = (warp % 4) * 16 + g;  // row in the warpgroup's 64
  __nv_bfloat16* stage = sm.out + wg * 64 * kPitch;
  // the biases once a block: the epilogue reads them with no branch and no
  // global-memory latency (read from global, a column pair at a time, they
  // cost more than the products)
  for (int c = threadIdx.x; c < 3 * d; c += kConsumers)
    sm.bias[c] = c < d ? bq[c] : c < 2 * d ? 0.f : bv[c - 2 * d];
  hopper::named_barrier(1, kConsumers);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int tm, tn;
    hopper::grouped_tile(tile, tiles_m, tiles_n, kGroup, tm, tn);
    float acc[kProjBN / 2];
#pragma unroll
    for (int i = 0; i < kProjBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int st = it % kProjStages;
      hopper::mbar_wait(&sm.full[st], (it / kProjStages) & 1);
      const uint64_t a_desc = hopper::desc_sw128(sm.a[st] + wg * 64 * kProjBK);
      const uint64_t b_desc = hopper::desc_sw128(sm.b[st]);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kProjBK / 16; ++kk)
        hopper::wgmma_m64n192k16_ss(acc, a_desc + hopper::k_step_kmajor(kk),
                                    b_desc + hopper::k_step_kmajor(kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous slice's products are done
      hopper::fence_regs(acc);
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[(it - 1) % kProjStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&sm.empty[(it - 1) % kProjStages]);

    // Epilogue: bias, q's scale, the bf16 rounding. A column pair never
    // straddles q | k | v (d is even). The warpgroup stages its 64 × 192
    // bf16 tile in shared memory, once its last tile has left it, and
    // writes it to its plane of qkv in 16-byte pieces (d % 8 == 0: a piece
    // never straddles two planes).
    hopper::named_barrier(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < kProjBN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int col = tn * kProjBN + c;
      const float2 bias = *reinterpret_cast<const float2*>(sm.bias + col);
      const float mul = col < d ? scale : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair(stage + (r0 + 8 * h) * kPitch + c, (acc[4 * j + 2 * h] + bias.x) * mul,
                   (acc[4 * j + 2 * h + 1] + bias.y) * mul);
    }
    hopper::named_barrier(2 + wg, 128);
    constexpr int kChunks = kProjBN / 8;  // 16-byte pieces a row
#pragma unroll 4
    for (int i = wt; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks;
      const int c = 8 * (i % kChunks);
      const int row = tm * kProjBM + wg * 64 + r;
      const int col = tn * kProjBN + c;
      const int which = (col >= d) + (col >= 2 * d);
      if (row < m)
        *reinterpret_cast<uint4*>(qkv + ((size_t)which * m + row) * d + col - which * d) =
            *reinterpret_cast<const uint4*>(stage + r * kPitch + c);
    }
  }
}

// ---------------------------------------------------------------- phase (b)
// q, k, v f32 (b, h, s, 64) views → bf16 (3, b, h, s, 64), eight elements a
// thread; blockIdx.y picks the tensor.
__global__ void __launch_bounds__(256)
to_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const AttnArgs args, int heads,
               long long rows, __nv_bfloat16* __restrict__ out) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= rows * (kHeadDim / 8)) return;
  const long long r = i / (kHeadDim / 8);
  const int c = 8 * static_cast<int>(i % (kHeadDim / 8));
  const int pos = static_cast<int>(r % args.seq);
  const long long bh = r / args.seq;
  const long long head = bh % heads;
  const long long clip = bh / heads;
  const float* src = blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v;
  const HeadStrides& st = blockIdx.y == 0 ? args.q : blockIdx.y == 1 ? args.k : args.v;
  const uint4 val = load8(src + clip * st.b + head * st.h + (long long)pos * st.s + c);
  *reinterpret_cast<uint4*>(out + blockIdx.y * rows * kHeadDim + r * kHeadDim + c) = val;
}

// ---------------------------------------------------------------- phase (c)
constexpr int kBQ = 128;   // query rows per block: 64 per consumer warpgroup
constexpr int kBKV = 128;  // keys per K/V tile
constexpr int kStages = 3;
constexpr uint32_t kTileBytes = kBKV * kHeadDim * 2;

struct AttnSmem {  // every tile 1024-byte aligned (the swizzle atom)
  __nv_bfloat16 q[kBQ * kHeadDim];
  __nv_bfloat16 k[kStages][kBKV * kHeadDim];
  __nv_bfloat16 v[kStages][kBKV * kHeadDim];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kAttnSmem = sizeof(AttnSmem) + 1024;  // + alignment slack

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O += P · V as one commit group: eight key steps of 16, P from registers,
// V read MN-major.
__device__ __forceinline__ void issue_pv(float (&o)[kHeadDim / 2], uint32_t (&p)[kBKV / 16][4],
                                         uint64_t v_desc) {
  hopper::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk) hopper::fence_regs(p[kk]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
    hopper::wgmma_m64n64k16_rs_mn(o, p[kk], v_desc + hopper::k_step_mnmajor(kk), 1);
  hopper::wgmma_commit();
}

// q, k, v: bf16 tensor maps over (64, s, h, b) → out (b, h, s, 64) view in
// TOut through its strides. score_scale = q scale · log2 e. Persistent:
// block b takes work items b, b + gridDim.x, ... of (query tile, head,
// clip), query tiles fastest; the K/V ring runs on across items (slice
// counter `it`), and Q has its own full / empty pair.
template <typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, TOut* __restrict__ out,
                 const HeadStrides out_st, int seq, int heads, int items, float score_scale,
                 int stable) {
  extern __shared__ unsigned char smem_raw[];
  AttnSmem& sm = *reinterpret_cast<AttnSmem*>(hopper::align1024(smem_raw));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_qt = (seq + kBQ - 1) / kBQ;
  const int n_tiles = (seq + kBKV - 1) / kBKV;

  if (tid == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init(&sm.q_empty, kConsumers / 32);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], kConsumers / 32);  // one arrival a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ------------------------------ producer
    if (lane == 0) {
      int it = 0;
      int i = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++i) {
        const int q0 = (item % n_qt) * kBQ;
        const int head = (item / n_qt) % heads;
        const int clip = item / n_qt / heads;
        if (i > 0) hopper::mbar_wait(&sm.q_empty, (i - 1) & 1);
        hopper::mbar_expect_tx(&sm.q_full, kBQ * kHeadDim * 2);
        hopper::tma_load_4d(sm.q, &qmap, &sm.q_full, 0, q0, head, clip);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % kStages;
          if (it >= kStages) hopper::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          hopper::mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
          hopper::tma_load_4d(sm.k[st], &kmap, &sm.full[st], 0, j * kBKV, head, clip);
          hopper::tma_load_4d(sm.v[st], &vmap, &sm.full[st], 0, j * kBKV, head, clip);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;  // 64-row half of the query tile
  const int g = lane / 4;
  const int t = lane % 4;
  const uint64_t q_desc = hopper::desc_sw128(sm.q + wg * 64 * kHeadDim);
  int it = 0;
  int i = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++i) {
    const int q0 = (item % n_qt) * kBQ;
    const int head = (item / n_qt) % heads;
    const int clip = item / n_qt / heads;
    // rows g (index 0) and g + 8 (index 1) of this warp's 16, in raw score
    // units; without `stable` the max stays 0 and exp2 takes the raw scores
    const float max0 = stable ? -INFINITY : 0.f;
    float row_max[2] = {max0, max0};
    float row_sum[2] = {0.f, 0.f};
    float o[kHeadDim / 2];
#pragma unroll
    for (int e = 0; e < kHeadDim / 2; ++e) o[e] = 0.f;

    hopper::mbar_wait(&sm.q_full, i & 1);
    // Tile j's scores are computed while tile j − 1's P·V runs: issue
    // S_j, issue O += P_{j−1}·V_{j−1}, wait for S_j alone, take the
    // exponentials in place, then wait for the P·V, rescale O and pack P_j.
    float s[kBKV / 2];
    uint32_t p[kBKV / 16][4];
    int prev_st = 0;
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(&sm.full[st], (it / kStages) & 1);

      // S = Q · Kᵀ: 64 rows × 128 keys, four k-steps over head_dim
      const uint64_t k_desc = hopper::desc_sw128(sm.k[st]);
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        hopper::wgmma_m64n128k16_ss(s, q_desc + hopper::k_step_kmajor(kk),
                                    k_desc + hopper::k_step_kmajor(kk), kk > 0);
      hopper::wgmma_commit();
      if (j > 0) {
        issue_pv(o, p, hopper::desc_sw128(sm.v[prev_st]));
        hopper::wgmma_wait<1>();  // S_j is done; P_{j−1}·V_{j−1} may run on
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(s);
      if (j == n_tiles - 1 && lane == 0) hopper::mbar_arrive(&sm.q_empty);  // Q read

      // mask keys past s, online max
      const int key0 = j * kBKV + 2 * t;
      const bool tail = (j + 1) * kBKV > seq;
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < kBKV / 2; ++e) {
        if (tail && key0 + 8 * (e / 4) + (e % 2) >= seq) s[e] = -INFINITY;
        tile_max[(e / 2) % 2] = fmaxf(tile_max[(e / 2) % 2], s[e]);
      }
      float alpha[2], shift[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
        const float m_new = stable ? fmaxf(row_max[h], tile_max[h]) : 0.f;
        alpha[h] = fast_exp2((row_max[h] - m_new) * score_scale);  // 0 on the first tile
        row_max[h] = m_new;
        shift[h] = -m_new * score_scale;
      }
      // P = exp2(S·scale − max·scale): one FFMA and one exp2 a score
      float tile_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < kBKV / 2; ++e) {
        s[e] = fast_exp2(fmaf(s[e], score_scale, shift[(e / 2) % 2]));
        tile_sum[(e / 2) % 2] += s[e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tile_sum[h] += __shfl_xor_sync(0xffffffffu, tile_sum[h], 1);
        tile_sum[h] += __shfl_xor_sync(0xffffffffu, tile_sum[h], 2);
        row_sum[h] = row_sum[h] * alpha[h] + tile_sum[h];
      }

      hopper::wgmma_wait<0>();  // P_{j−1}·V_{j−1} is done: O, P and its stage are free
      hopper::fence_regs(o);
      if (j > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[prev_st]);
#pragma unroll
      for (int e = 0; e < kHeadDim / 2; ++e) o[e] *= alpha[(e / 2) % 2];
      // bf16 A fragments: key step kk holds n-tiles 2kk and 2kk + 1 of S
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      prev_st = st;
    }
    issue_pv(o, p, hopper::desc_sw128(sm.v[prev_st]));
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (lane == 0) hopper::mbar_arrive(&sm.empty[prev_st]);

    // one normalisation of the (64, 64) output per warpgroup
    const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
    TOut* oh = out + clip * out_st.b + head * out_st.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wg * 64 + (warp % 4) * 16 + g + 8 * h;
      if (row >= seq) continue;
      TOut* dst = oh + (long long)row * out_st.s;
#pragma unroll
      for (int jn = 0; jn < kHeadDim / 8; ++jn)
        store_pair(dst + 8 * jn + 2 * t, o[4 * jn + 2 * h] * inv[h],
                   o[4 * jn + 2 * h + 1] * inv[h]);
    }
  }
}

// A bf16 tensor map over one of q, k, v: (64, s, h, b) elements with the
// given element strides of s, h and b.
int head_map(CUtensorMap* map, const void* base, int batch, int heads, int seq,
             const HeadStrides& st, int box_rows) {
  const uint64_t dims[4] = {kHeadDim, (uint64_t)seq, (uint64_t)heads, (uint64_t)batch};
  const uint64_t strides[3] = {2ull * st.s, 2ull * st.h, 2ull * st.b};
  const uint32_t box[4] = {kHeadDim, (uint32_t)box_rows, 1, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

// q, k, v bf16 in their head strides; q_scale a power of two.
template <typename TOut>
int launch_attention(const __nv_bfloat16* q, const __nv_bfloat16* k,
                     const __nv_bfloat16* v, TOut* out, const AttnArgs& args, int batch,
                     int heads, cudaStream_t s) {
  int e = 0;
  if (std::frexp(args.q_scale, &e) != 0.5f) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  int err = head_map(&qmap, q, batch, heads, args.seq, args.q, kBQ);
  if (!err) err = head_map(&kmap, k, batch, heads, args.seq, args.k, kBKV);
  if (!err) err = head_map(&vmap, v, batch, heads, args.seq, args.v, kBKV);
  if (!err) err = hopper::allow_smem(attention_kernel<TOut>, kAttnSmem);
  int sms = 0;
  if (!err) err = hopper::sm_count(&sms);
  if (err) return err;
  const int items = (args.seq + kBQ - 1) / kBQ * heads * batch;
  attention_kernel<TOut><<<std::min(items, sms), kThreads, kAttnSmem, s>>>(
      qmap, kmap, vmap, out, args.out, args.seq, heads, items,
      args.q_scale * 1.4426950408889634f, args.stable);
  return static_cast<int>(cudaGetLastError());
}

// x (m, d) as TIn; wq, wk, wv (d_in, d_out) f32 views; scratch: qkv
// (3, m, d), then wt (3d, d), then (f32 x only) xb (m, d), all bf16.
template <typename TIn>
int launch_fused(const void* x, const float* wq, const float* wk, const float* wv,
                 const WeightStrides& ws, const float* bq, const float* bv, void* scratch,
                 void* out, int batch, int seq, int d, int heads, float scale,
                 cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int m = batch * seq;
  bf16* qkv = static_cast<bf16*>(scratch);
  bf16* wt = qkv + 3ull * m * d;
  bf16* xb = wt + 3ull * d * d;
  const bool f32 = sizeof(TIn) == 4;
  const long long x_chunks = f32 ? (long long)m * d / 16 : 0;
  const long long chunks = 3ll * d * (d / 8) + x_chunks;
  // the pre-pass first: the host prepares the other launches while it runs
  prep_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
      wq, wk, wv, ws, d, wt, f32 ? static_cast<const float*>(x) : nullptr, x_chunks, xb);
  const bf16* xin = f32 ? xb : static_cast<const bf16*>(x);
  CUtensorMap xmap, wmap;
  int err = static_cast<int>(cudaGetLastError());
  if (!err) err = hopper::matrix_map(&xmap, xin, m, d, kProjBK, kProjBM);
  if (!err) err = hopper::matrix_map(&wmap, wt, 3 * d, d, kProjBK, kProjBN);
  if (!err) err = hopper::allow_smem(qkv_projection_kernel, kProjSmem);
  int sms = 0;
  if (!err) err = hopper::sm_count(&sms);
  if (err) return err;
  const int tiles = (m + kProjBM - 1) / kProjBM * (3 * d / kProjBN);
  qkv_projection_kernel<<<std::min(tiles, sms), kThreads, kProjSmem, s>>>(xmap, wmap, bq, bv,
                                                                         qkv, m, d, scale);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  // q, k, v scratch planes and out are (b, s, d): head h of clip c starts
  // at c·s·d + h·64, rows d apart; q is pre-scaled
  const HeadStrides bsd{(long long)seq * d, kHeadDim, d};
  const AttnArgs args{bsd, bsd, bsd, bsd, seq, 1.f, 1};
  const size_t plane = (size_t)m * d;
  return launch_attention<TIn>(qkv, qkv + plane, qkv + 2 * plane, static_cast<TIn*>(out),
                               args, batch, heads, s);
}

AttnArgs whisper_args(const long long* st, int seq, float scale, int stable) {
  return AttnArgs{{st[0], st[1], (int)st[2]}, {st[3], st[4], (int)st[5]},
                  {st[6], st[7], (int)st[8]}, {st[9], st[10], (int)st[11]},
                  seq, scale, stable};
}

}  // namespace

extern "C" {

// x (b, s, d) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), contiguous, 16-byte
// aligned; wq, wk, wv (d_in, d_out) f32 views with element strides
// wstrides[2i], wstrides[2i + 1] (any layout); bq, bv (d,) f32; scratch
// (3·b·s·d + 3·d² [+ b·s·d for f32 x]) bf16; out (b, s, d) in x's dtype.
// d = heads · 64. Returns cudaError_t.
int freud_qkv_attention(const void* x, int x_bf16, const float* wq, const float* wk,
                        const float* wv, const long long* wstrides, const float* bq,
                        const float* bv, void* scratch, void* out, int batch, int seq,
                        int d, int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WeightStrides ws;
  for (int i = 0; i < 6; ++i) ws.s[i] = wstrides[i];
  if (x_bf16)
    return launch_fused<__nv_bfloat16>(x, wq, wk, wv, ws, bq, bv, scratch, out, batch, seq,
                                       d, heads, scale, s);
  return launch_fused<float>(x, wq, wk, wv, ws, bq, bv, scratch, out, batch, seq, d, heads,
                             scale, s);
}

// q, k, v, out: (b, h, s, 64) views, f32 (in_bf16 = 0) or bf16 (in_bf16 = 1),
// out in the same dtype; strides: 12 element strides (b, h, s) of q, k, v
// and out, in that order, head_dim contiguous; q, k, v strides multiples of
// 8 and bases 16-byte aligned, out strides even. scratch: (3, b, h, s, 64)
// bf16 for f32 input (unused for bf16). scale: q's scale, a power of two,
// applied in f32 before the bf16 cast; stable = 0 drops the
// max-subtraction. Returns cudaError_t.
int freud_whisper_attention(const void* q, const void* k, const void* v, void* out,
                            int in_bf16, int batch, int heads, int seq,
                            const long long* strides, float scale, int stable,
                            void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AttnArgs args = whisper_args(strides, seq, scale, stable);
  using T = __nv_bfloat16;
  if (in_bf16)
    return launch_attention(static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<T*>(out), args, batch,
                            heads, s);
  const long long rows = (long long)batch * heads * seq;
  const dim3 cgrid(static_cast<unsigned>((rows * (kHeadDim / 8) + 255) / 256), 3);
  T* bf = static_cast<T*>(scratch);
  to_bf16_kernel<<<cgrid, 256, 0, s>>>(static_cast<const float*>(q),
                                       static_cast<const float*>(k),
                                       static_cast<const float*>(v), args, heads, rows, bf);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the scratch is (b, h, s, 64) contiguous
  const HeadStrides dense{(long long)heads * seq * kHeadDim, (long long)seq * kHeadDim,
                          kHeadDim};
  args.q = args.k = args.v = dense;
  return launch_attention(bf, bf + rows * kHeadDim, bf + 2 * rows * kHeadDim,
                          static_cast<float*>(out), args, batch, heads, s);
}

}  // extern "C"
