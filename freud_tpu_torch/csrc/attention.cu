// Whisper encoder self-attention for Hopper (sm_90a): bf16 tensor-core
// products (mma.sync m16n8k16), f32 accumulation and f32 softmax statistics.
// Two entry points share one attention phase:
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
// f32 scores; the score matrix (9 MB of f32 per head) is what must not reach
// device memory. At bf16 tensor-core rates the exp/max/sum on the f32 scores
// and the operand feed from shared memory are the limits.
//
// Why not the TPU design: the TPU kernel keeps one head's whole K and V
// ((1536 × 64) each) resident in VMEM next to a 512-row q tile and takes the
// softmax over full score rows. A Hopper block has 227 KB of shared memory;
// K and V of one head in bf16 alone take 384 KB. So the attention phase is
// flash-style: K/V stream through shared memory in 64-key tiles and the
// softmax statistics are kept online.
//
// Design (the simple form; keeping q/k/v out of device memory in the fused
// path, and wgmma/TMA pipelines, are later work):
//   (a) qkv_projection_kernel (fused path only): one GEMM x(b·s, d) ·
//       [Wq | Wk | Wv](d, 3d) on 64 × 64 tiles, x rounded to bf16 on load;
//       the epilogue adds bq, folds dh^-½ into q after the bias, adds bv, and
//       writes bf16 q, k, v scratch.
//   (b) attention_kernel: one block of 4 warps per (query tile of 64, head,
//       clip), reading q/k/v through (b, h, s) element strides with head_dim
//       contiguous, so a (b, s, d) projection's head view needs no copy. q is
//       scaled in f32 and rounded to bf16 as it is staged (scale 1 for the
//       fused path's pre-scaled q), k and v are rounded to bf16; every tile
//       is staged row-major with 16-byte copies, and P·V reads V's fragments
//       transposed with ldmatrix. Each warp
//       owns 16 query rows whose Q fragments stay in registers. The loop over
//       64-key K/V tiles keeps an online f32 row max (with `stable`) and row
//       sum; scores stay in mma accumulator registers, are exponentiated in
//       f32 and re-packed to bf16 as the A operand of P·V without a trip
//       through shared memory. The (16, 64) output of each warp is divided by
//       its row sums once, at the end, and written through the output's
//       strides.
// s = 1500 is no multiple of the tiles: rows and keys past s are masked by
// bounds (zero-filled loads, −∞ scores), not by padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;  // 4 warps

// projection tiles
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kBKPad = kBK + 8;

// attention tiles
constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBKV = 64;  // keys per K/V tile
constexpr int kRowPad = 8;  // bf16 padding per smem row (bank spread)

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 (lo = lower column) as one 32-bit fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// eight neighbouring elements (16-byte aligned) as eight bf16 in 16 bytes
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}

// the same, each element multiplied by `scale` in f32 before the bf16 cast
__device__ __forceinline__ uint4 load8_scaled(const float* p, float scale) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale),
                    pack_bf16(b.x * scale, b.y * scale), pack_bf16(b.z * scale, b.w * scale));
}
__device__ __forceinline__ uint4 load8_scaled(const __nv_bfloat16* p, float scale) {
  uint4 v = load8(p);
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    w[e] = pack_bf16(f.x * scale, f.y * scale);
  }
  return v;
}

// four 8 × 8 bf16 matrices from shared memory, transposed: lanes 8m..8m+7
// give the row addresses of matrix m, register m receives its fragment
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

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
  float q_scale;  // applied to q in f32 before the bf16 cast
  int stable;     // 1: subtract the running row max before exp
};

// ---------------------------------------------------------------- phase (a)
// x (m_rows, d) · w (d, 3d) → qkv (3, m_rows, d) bf16.
template <typename TIn>
__global__ void __launch_bounds__(kThreads)
qkv_projection_kernel(const TIn* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bq,
                      const float* __restrict__ bv,
                      __nv_bfloat16* __restrict__ qkv,
                      int m_rows, int d, float scale) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kBKPad];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN][kBKPad];  // [col][k]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int ldw = 3 * d;

  float acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const int m = m0 + r;
      As[r][c] = m < m_rows ? to_bf16(x[(size_t)m * d + k0 + c])
                            : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN;
      const int nn = i % kBN;
      Bs[nn][kk] = w[(size_t)(k0 + kk) * ldw + n0 + nn];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      const int r = warp * 16 + g;
      uint32_t a[4];
      a[0] = load_pair(&As[r][ks + 2 * t]);
      a[1] = load_pair(&As[r + 8][ks + 2 * t]);
      a[2] = load_pair(&As[r][ks + 2 * t + 8]);
      a[3] = load_pair(&As[r + 8][ks + 2 * t + 8]);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        uint32_t b[2];
        b[0] = load_pair(&Bs[j * 8 + g][ks + 2 * t]);
        b[1] = load_pair(&Bs[j * 8 + g][ks + 2 * t + 8]);
        mma_16816(acc[j], a, b);
      }
    }
    __syncthreads();
  }

  // Epilogue. A 64-wide column tile never straddles q | k | v (d % 64 == 0).
  const int which = n0 / d;
  __nv_bfloat16* dst = qkv + (size_t)which * m_rows * d;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = n0 - which * d + j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp * 16 + g + 8 * half;
      if (m >= m_rows) continue;
      float v0 = acc[j][2 * half];
      float v1 = acc[j][2 * half + 1];
      if (which == 0) {
        v0 = (v0 + bq[c]) * scale;
        v1 = (v1 + bq[c + 1]) * scale;
      } else if (which == 2) {
        v0 += bv[c];
        v1 += bv[c + 1];
      }
      store_pair(dst + (size_t)m * d + c, v0, v1);
    }
  }
}

// ---------------------------------------------------------------- phase (b)
// q, k, v (b, h, s, 64) views in TIn → out (b, h, s, 64) view in TOut, each
// addressed through its own strides (multiples of 8, bases 16-byte aligned).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, TOut* __restrict__ out,
                 const AttnArgs args) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ][kHeadDim + kRowPad];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBKV][kHeadDim + kRowPad];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBKV][kHeadDim + kRowPad];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int seq = args.seq;
  const int q0 = blockIdx.x * kBQ;
  const long long head = blockIdx.y;
  const long long clip = blockIdx.z;
  const TIn* qh = q + clip * args.q.b + head * args.q.h;
  const TIn* kh = k + clip * args.k.b + head * args.k.h;
  const TIn* vh = v + clip * args.v.b + head * args.v.h;
  constexpr int kChunks = kHeadDim / 8;  // 16-byte bf16 chunks per row

  // Q tile, scaled in f32 then rounded to bf16; rows past s are zero
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = 8 * (i % kChunks);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < seq) val = load8_scaled(qh + (q0 + r) * args.q.s + c, args.q_scale);
    *reinterpret_cast<uint4*>(&Qs[r][c]) = val;
  }
  __syncthreads();
  uint32_t qa[kHeadDim / 16][4];
  {
    const int r = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
      qa[ks][0] = load_pair(&Qs[r][16 * ks + 2 * t]);
      qa[ks][1] = load_pair(&Qs[r + 8][16 * ks + 2 * t]);
      qa[ks][2] = load_pair(&Qs[r][16 * ks + 2 * t + 8]);
      qa[ks][3] = load_pair(&Qs[r + 8][16 * ks + 2 * t + 8]);
    }
  }

  // rows g (index 0) and g + 8 (index 1) of this warp's 16; without
  // `stable` the max stays 0 and exp takes the raw scores
  const float max0 = args.stable ? -INFINITY : 0.f;
  float row_max[2] = {max0, max0};
  float row_sum[2] = {0.f, 0.f};
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int j0 = 0; j0 < seq; j0 += kBKV) {
    __syncthreads();  // the previous tile's K/V are consumed
    for (int i = tid; i < kBKV * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = 8 * (i % kChunks);
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = kval;
      if (j0 + r < seq) {
        kval = load8(kh + (j0 + r) * args.k.s + c);
        vval = load8(vh + (j0 + r) * args.v.s + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kval;
      *reinterpret_cast<uint4*>(&Vs[r][c]) = vval;
    }
    __syncthreads();

    // scores S = Q · Kᵀ for 16 rows × 64 keys (8 n-tiles of 8 keys)
    float sc[kBKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        uint32_t b[2];
        b[0] = load_pair(&Ks[nt * 8 + g][16 * ks + 2 * t]);
        b[1] = load_pair(&Ks[nt * 8 + g][16 * ks + 2 * t + 8]);
        mma_16816(sc[nt], qa[ks], b);
      }
    }

    // mask keys past s; online max (the tile holds at least one valid key)
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + nt * 8 + 2 * t + (e & 1);
        if (key >= seq) sc[nt][e] = -INFINITY;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], sc[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
      const float m_new = args.stable ? fmaxf(row_max[h], tile_max[h]) : 0.f;
      alpha[h] = expf(row_max[h] - m_new);  // 0 on the first tile if stable
      row_max[h] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] - row_max[e >> 1]);
        tile_sum[e >> 1] += sc[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_sum[h] += __shfl_xor_sync(0xffffffffu, tile_sum[h], 1);
      tile_sum[h] += __shfl_xor_sync(0xffffffffu, tile_sum[h], 2);
      row_sum[h] = row_sum[h] * alpha[h] + tile_sum[h];
    }
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P · V: the score accumulators of key n-tiles 2kk, 2kk+1 are the
    // A fragment of key step kk; the B fragments (V[key][dh] taken as
    // key × dh, col-major) come transposed from the row-major V tile, two
    // 8-column dh tiles per ldmatrix.x4 (matrix m: keys +8·(m & 1), dh
    // tile j + (m >> 1))
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const int m = lane / 8;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &Vs[16 * kk + 8 * (m & 1) + (lane & 7)][8 * (j + (m >> 1))]);
        const uint32_t b0[2] = {b[0], b[1]};
        const uint32_t b1[2] = {b[2], b[3]};
        mma_16816(o[j], pa, b0);
        mma_16816(o[j + 1], pa, b1);
      }
    }
  }

  // one normalisation of the (16, 64) output per warp
  const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
  TOut* oh = out + clip * args.out.b + head * args.out.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= seq) continue;
    TOut* dst = oh + row * args.out.s;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j)
      store_pair(dst + j * 8 + 2 * t, o[j][2 * h] * inv[h], o[j][2 * h + 1] * inv[h]);
  }
}

template <typename TIn, typename TOut>
int launch_attention(const TIn* q, const TIn* k, const TIn* v, TOut* out,
                     const AttnArgs& args, int batch, int heads, cudaStream_t s) {
  const dim3 grid((args.seq + kBQ - 1) / kBQ, heads, batch);
  attention_kernel<TIn, TOut><<<grid, kThreads, 0, s>>>(q, k, v, out, args);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_fused(const void* x, const void* w, const float* bq, const float* bv,
                 void* qkv, void* out, int batch, int seq, int d, int heads,
                 float scale, cudaStream_t s) {
  const int m_rows = batch * seq;
  const dim3 pgrid(3 * d / kBN, (m_rows + kBM - 1) / kBM);
  qkv_projection_kernel<TIn><<<pgrid, kThreads, 0, s>>>(
      static_cast<const TIn*>(x), static_cast<const __nv_bfloat16*>(w), bq, bv,
      static_cast<__nv_bfloat16*>(qkv), m_rows, d, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // q, k, v scratch planes and out are (b, s, d): head h of clip c starts
  // at c·s·d + h·64, rows d apart; q is pre-scaled
  const HeadStrides bsd{(long long)seq * d, kHeadDim, d};
  const AttnArgs args{bsd, bsd, bsd, bsd, seq, 1.f, 1};
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(qkv);
  const size_t plane = (size_t)m_rows * d;
  return launch_attention(qp, qp + plane, qp + 2 * plane, static_cast<TIn*>(out),
                          args, batch, heads, s);
}

AttnArgs whisper_args(const long long* st, int seq, float scale, int stable) {
  return AttnArgs{{st[0], st[1], (int)st[2]}, {st[3], st[4], (int)st[5]},
                  {st[6], st[7], (int)st[8]}, {st[9], st[10], (int)st[11]},
                  seq, scale, stable};
}

}  // namespace

extern "C" {

// x (b, s, d) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (d, 3d) bf16 =
// [Wq | Wk | Wv] in (d_in, d_out) layout; bq, bv (d,) f32; qkv scratch
// (3, b, s, d) bf16; out (b, s, d) in x's dtype. d = heads · 64, d % 64 == 0.
// Returns cudaError_t.
int freud_qkv_attention(const void* x, int x_bf16, const void* w,
                        const float* bq, const float* bv, void* qkv, void* out,
                        int batch, int seq, int d, int heads, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_fused<__nv_bfloat16>(x, w, bq, bv, qkv, out, batch, seq, d,
                                       heads, scale, s);
  return launch_fused<float>(x, w, bq, bv, qkv, out, batch, seq, d, heads, scale, s);
}

// q, k, v, out: (b, h, s, 64) views, f32 (in_bf16 = 0) or bf16 (in_bf16 = 1),
// out in the same dtype; strides: 12 element strides (b, h, s) of q, k, v
// and out, in that order, head_dim contiguous; q, k, v strides multiples of
// 8 and bases 16-byte aligned, out strides even; s · stride_s < 2³¹. scale
// multiplies q in f32 before the bf16 cast; stable = 0 drops the
// max-subtraction. Returns cudaError_t.
int freud_whisper_attention(const void* q, const void* k, const void* v, void* out,
                            int in_bf16, int batch, int heads, int seq,
                            const long long* strides, float scale, int stable,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AttnArgs args = whisper_args(strides, seq, scale, stable);
  if (in_bf16) {
    using T = __nv_bfloat16;
    return launch_attention(static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<T*>(out), args,
                            batch, heads, s);
  }
  return launch_attention(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<float*>(out), args,
                          batch, heads, s);
}

}  // extern "C"
