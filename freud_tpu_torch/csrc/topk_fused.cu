// TopK-SAE training forward for Hopper (sm_90a): encode GEMM, per-row exact
// thresholds and fired mask, then both masked decodes as a second GEMM.
//
// Replaces the Pallas TPU kernel freud_tpu/ops/topk_fused.py
// (topk_sae_forward → _forward_impl → _kernel):
//   acts   = relu(bf16(bf16(x − b_dec) · W_encᵀ) + bf16(b_enc))   (M, n_dict) bf16
//   t_main = the k-th largest of each acts row; t_aux = the k_aux-th largest
//            among dead columns (edge rules in csrc/topk_select.cuh)
//   y_main = Σ_{acts ≥ t_main} acts · W_dec,  y_aux = Σ_{dead, acts ≥ t_aux}
//            acts · W_dec   (M, d_in) f32, b_dec excluded
//   fired  = any valid row with acts ≥ t_main and acts > 0
//
// What bounds it on an H100: the encode, 2·M·d_in·n_dict of bf16 products
// (2.5 TFLOP at M 48,000, d_in 1280, n_dict 20,480: 2.5 ms at the
// tensor-core peak), and the 2 GB of acts it writes; the selection reads the
// acts once more. The decodes need only (k + k_aux)·d_in multiply-adds a
// row, but a gather of up to k + k_aux W_dec rows a row reads them from L2
// one row at a time (~80 GB a step at large width), which bound the earlier
// design. So the decodes run dense on the tensor cores, where the masked
// zeros cost products but no memory traffic: 2·2·M·n_dict·d_in operations.
//
// Design: five launches on the caller's stream.
//   (a) center_kernel: xs = bf16(x − b_dec), (M, d_in), because TMA copies
//       bytes as they are and can neither subtract nor convert.
//   (b) dead_bits_kernel (topk_select.cuh): the dead mask as bits.
//   (c) encode_kernel: xs · W_encᵀ with wgmma on 128 × 256 output tiles.
//       A producer warp streams 64-wide K slices of both operands (K-major,
//       128-byte swizzle) by TMA through a ring of kStages stages; two
//       consumer warpgroups of 64 rows each issue m64n256k16 from shared
//       memory and keep one group of products in flight while the next
//       slice's barrier is awaited. The epilogue keeps the TPU kernel's
//       rounding exactly (topk_fused.py:298-302 of the JAX package):
//       bf16(z), + bf16(b_enc) rounded to bf16, ReLU; it stages the tile in
//       the freed stage buffers and writes acts in 16-byte pieces.
//   (d) the selection core of csrc/topk_select.cuh (topk::launch_select
//       with the exact keys, two selections): exact t_main and t_aux and
//       the fired bits, from a persistent grid that streams acts rows into
//       a ring of row buffers and radix-selects each over the keys that can
//       hold its k-th values.
//   (e) decode_kernel: acts · W_dec for both masks at once, on 128-row ×
//       128-column output tiles over K = n_dict. The producer streams acts
//       (K-major) and W_dec (MN-major: d_in contiguous) tiles by TMA; each
//       consumer warpgroup masks its 64 acts rows of a slice into two
//       shared-memory copies — by the row's threshold keys (non-negative
//       bf16 bits order as their values, so a 16-bit unsigned compare is
//       the selection's own) and, for aux, the column's dead bit — and
//       issues m64n128k16 from shared memory for each mask into its own f32
//       accumulators; both share every W_dec tile. The copies alternate
//       between two buffers, so masking slice k + 1 overlaps the products
//       of slice k (masking in registers instead would make ptxas
//       serialise the products). No masked (M, n_dict) buffer, no split-K,
//       no atomics: each output sums in a fixed order and repeats bit for
//       bit.
// Row tiles are walked kGroup at a time across all column tiles, so the
// other operand's tiles are reused from L2.
//
// On a dictionary split over model ranks a row's thresholds are the whole
// row's, which no rank holds: there freud_topk_sae_encode runs (a) and (c)
// on the rank's rows, the selection across shards (csrc/topk_sharded.cu)
// takes (d)'s place, and freud_topk_sae_decode runs (b) and (e) under its
// thresholds; the ranks' partial decodes are summed after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "topk_select.cuh"

namespace {


constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kBK = 64;                        // one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kGroup = 8;                      // row tiles walked together
constexpr int kEncBM = 128, kEncBN = 256;      // encode output tile
constexpr int kDecBM = 128, kDecBN = 128;      // decode output tile (2 × 64 columns)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// relu(bf16(bf16(z) + b)), b already bf16
__device__ __forceinline__ __nv_bfloat16 act_of(float z, float b) {
  const float zb = __bfloat162float(__float2bfloat16_rn(z));
  const float s = __bfloat162float(__float2bfloat16_rn(zb + b));
  return __float2bfloat16_rn(s > 0.f ? s : 0.f);
}

// ---------------------------------------------------------------- phase (a)
// x (m, d) f32, b_dec (d,) f32 → xs (m, d) bf16; eight elements a thread.
__global__ void __launch_bounds__(256)
center_kernel(const float* __restrict__ x, const float* __restrict__ b_dec, int d,
              long long chunks, __nv_bfloat16* __restrict__ xs) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= chunks) return;
  const long long e = 8 * i;
  const int c = static_cast<int>(e % d);
  const float4 a = *reinterpret_cast<const float4*>(x + e);
  const float4 b = *reinterpret_cast<const float4*>(x + e + 4);
  const float4 p = *reinterpret_cast<const float4*>(b_dec + c);
  const float4 q = *reinterpret_cast<const float4*>(b_dec + c + 4);
  *reinterpret_cast<uint4*>(xs + e) =
      make_uint4(pack_bf16(a.x - p.x, a.y - p.y), pack_bf16(a.z - p.z, a.w - p.w),
                 pack_bf16(b.x - q.x, b.y - q.y), pack_bf16(b.z - q.z, b.w - q.w));
}

// ---------------------------------------------------------------- phase (c)
struct EncSmem {  // every tile 1024-byte aligned (the swizzle atom)
  __nv_bfloat16 a[kStages][kEncBM * kBK];
  __nv_bfloat16 b[kStages][kEncBN * kBK];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kEncSmem = sizeof(EncSmem) + 1024;

// xs: tensor map (d, m), box (64, 128); w_enc: tensor map (d, n), box
// (64, 256); b_enc (n,) bf16 → acts (m, n) bf16.
__global__ void __launch_bounds__(kThreads, 1)
encode_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              const __nv_bfloat16* __restrict__ b_enc, __nv_bfloat16* __restrict__ acts,
              int m, int n, int d) {
  extern __shared__ unsigned char smem_raw[];
  EncSmem& sm = *reinterpret_cast<EncSmem*>(hopper::align1024(smem_raw));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int tm, tn;
  hopper::grouped_tile(blockIdx.x, (m + kEncBM - 1) / kEncBM, (n + kEncBN - 1) / kEncBN,
                       kGroup, tm, tn);
  const int k_tiles = (d + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ------------------------------ producer
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) hopper::mbar_wait(&sm.empty[st], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&sm.full[st], (kEncBM + kEncBN) * kBK * 2);
        hopper::tma_load_2d(sm.a[st], &xmap, &sm.full[st], kt * kBK, tm * kEncBM);
        hopper::tma_load_2d(sm.b[st], &wmap, &sm.full[st], kt * kBK, tn * kEncBN);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;
  float acc[kEncBN / 2];
#pragma unroll
  for (int i = 0; i < kEncBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % kStages;
    hopper::mbar_wait(&sm.full[st], (kt / kStages) & 1);
    const uint64_t a_desc = hopper::desc_sw128(sm.a[st] + wg * 64 * kBK);
    const uint64_t b_desc = hopper::desc_sw128(sm.b[st]);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_m64n256k16_ss(acc, a_desc + hopper::k_step_kmajor(kk),
                                  b_desc + hopper::k_step_kmajor(kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous slice's products are done
    hopper::fence_regs(acc);
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // Epilogue: the TPU kernel's rounding order. The stage buffers are free
  // once both warpgroups' products are done (every slice was loaded and
  // consumed), so each warpgroup stages its 64 × 256 bf16 tile there (rows
  // padded against bank conflicts) and writes it out in 16-byte pieces.
  hopper::named_barrier(1, kConsumers);
  constexpr int kPitch = kEncBN + 8;  // bf16 per staged row
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(&sm) + wg * 64 * kPitch;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = (warp % 4) * 16 + g;  // row in the warpgroup's 64
#pragma unroll
  for (int j = 0; j < kEncBN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const int col = tn * kEncBN + c;
    const float2 b = col < n
        ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_enc + col))
        : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 out;
      out.x = act_of(acc[4 * j + 2 * h], b.x);
      out.y = act_of(acc[4 * j + 2 * h + 1], b.y);
      *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * h) * kPitch + c) = out;
    }
  }
  hopper::named_barrier(2 + wg, 128);
  const int wt = threadIdx.x % 128;
  constexpr int kChunks = kEncBN / 8;  // 16-byte pieces a row
#pragma unroll 4
  for (int i = wt; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks;
    const int c = 8 * (i % kChunks);
    const int row = tm * kEncBM + wg * 64 + r;
    const int col = tn * kEncBN + c;
    if (row < m && col < n)  // n % 8 == 0: a piece is all in or all out
      *reinterpret_cast<uint4*>(acts + (size_t)row * n + col) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + c);
  }
}

// ---------------------------------------------------------------- phase (e)
struct DecSmem {
  __nv_bfloat16 a[kStages][kDecBM * kBK];       // acts: 128 rows × 64 columns
  __nv_bfloat16 b[kStages][2][kBK * 64];        // W_dec: 64 rows × (2 × 64) columns
  // each warpgroup's 64 acts rows masked for main and aux, two slices in turn
  __nv_bfloat16 masked[2][2][2][64 * kBK];      // [slice & 1][warpgroup][main, aux]
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kDecSmem = sizeof(DecSmem) + 1024;

// A threshold's bf16 bits in both 16-bit halves; +inf (selects nothing)
// for rows past m.
__device__ __forceinline__ uint32_t threshold_halves(const float* t, int row, int m) {
  const uint32_t bits = row < m ? __float_as_uint(t[row]) >> 16 : 0x7F80u;
  return bits | (bits << 16);
}

// Eight dead bits (columns c..c + 7 of a 64-column slice, c % 8 == 0) as
// four masks of two 16-bit halves.
__device__ __forceinline__ uint4 dead_mask8(uint2 dw, int c) {
  const uint32_t byte = ((c < 32 ? dw.x : dw.y) >> (c & 31)) & 0xFFu;
  uint32_t h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t bits = byte >> (2 * q);
    h[q] = ((bits & 1u) ? 0x0000FFFFu : 0u) | ((bits & 2u) ? 0xFFFF0000u : 0u);
  }
  return make_uint4(h[0], h[1], h[2], h[3]);
}

// Keeps the 16-bit halves of v that are >= t (and set in mask).
__device__ __forceinline__ uint4 keep_ge(uint4 v, uint32_t t, uint4 mask) {
  return make_uint4(v.x & __vcmpgeu2(v.x, t) & mask.x, v.y & __vcmpgeu2(v.y, t) & mask.y,
                    v.z & __vcmpgeu2(v.z, t) & mask.z, v.w & __vcmpgeu2(v.w, t) & mask.w);
}

// The decode's f32 accumulators: 64 rows × 128 columns per mask.
struct DecAcc {
  float main[64];
  float aux[64];
};

__device__ __forceinline__ void fence_acc(DecAcc& acc) {
  hopper::fence_regs(acc.main);
  hopper::fence_regs(acc.aux);
}

// acts: tensor map (n, m), box (64, 128); w_dec: tensor map (d, n), box
// (64, 64); t_main, t_aux (m,) f32; dead_bits (2·ceil(n / 64) words, zero
// past n) → y_main, y_aux (m, d) f32.
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap wmap, const float* __restrict__ t_main,
              const float* __restrict__ t_aux, const uint32_t* __restrict__ dead_bits,
              float* __restrict__ y_main, float* __restrict__ y_aux, int m, int n, int d) {
  extern __shared__ unsigned char smem_raw[];
  DecSmem& sm = *reinterpret_cast<DecSmem*>(hopper::align1024(smem_raw));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int tm, tn;
  hopper::grouped_tile(blockIdx.x, (m + kDecBM - 1) / kDecBM, (d + kDecBN - 1) / kDecBN,
                       kGroup, tm, tn);
  const int k_tiles = (n + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ------------------------------ producer
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) hopper::mbar_wait(&sm.empty[st], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&sm.full[st], (kDecBM + 2 * kBK) * kBK * 2);
        hopper::tma_load_2d(sm.a[st], &amap, &sm.full[st], kt * kBK, tm * kDecBM);
        hopper::tma_load_2d(sm.b[st][0], &wmap, &sm.full[st], tn * kDecBN, kt * kBK);
        hopper::tma_load_2d(sm.b[st][1], &wmap, &sm.full[st], tn * kDecBN + 64, kt * kBK);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;
  const int wt = threadIdx.x % 128;  // thread in the warpgroup
  // The masking pass: this thread takes 16-byte chunk wt % 8 of rows
  // wt / 8 + 16·i of the warpgroup's 64, in the swizzled layout TMA wrote
  // (the chunk holds logical columns 8·(chunk ^ row % 8) onward); the masked
  // copies keep that layout, so wgmma reads them as it reads a TMA tile.
  const int chunk = wt % 8;
  uint32_t tm2[4], ta2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tm * kDecBM + wg * 64 + wt / 8 + 16 * i;
    tm2[i] = threshold_halves(t_main, row, m);
    ta2[i] = threshold_halves(t_aux, row, m);
  }
  DecAcc acc;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc.main[i] = acc.aux[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % kStages;
    const uint2 dw = *reinterpret_cast<const uint2*>(dead_bits + 2 * kt);
    __nv_bfloat16* mm = sm.masked[kt & 1][wg][0];
    __nv_bfloat16* ma = sm.masked[kt & 1][wg][1];
    hopper::mbar_wait(&sm.full[st], (kt / kStages) & 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wt / 8 + 16 * i;
      const int at = r * kBK + 8 * chunk;  // bf16 offset of the physical chunk
      const uint4 v = *reinterpret_cast<const uint4*>(sm.a[st] + wg * 64 * kBK + at);
      const uint4 all = make_uint4(~0u, ~0u, ~0u, ~0u);
      *reinterpret_cast<uint4*>(mm + at) = keep_ge(v, tm2[i], all);
      *reinterpret_cast<uint4*>(ma + at) =
          keep_ge(v, ta2[i], dead_mask8(dw, 8 * (chunk ^ (r & 7))));
    }
    hopper::fence_proxy_async();          // the masked tiles, for wgmma
    hopper::named_barrier(1 + wg, 128);   // every thread of the warpgroup wrote
    const uint64_t b = hopper::desc_sw128(sm.b[st][0], sizeof(sm.b[st][0]));
    const uint64_t am = hopper::desc_sw128(mm);
    const uint64_t aa = hopper::desc_sw128(ma);
    fence_acc(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t step_b = hopper::k_step_mnmajor(kk);
      const uint64_t step_a = hopper::k_step_kmajor(kk);
      hopper::wgmma_m64n128k16_ss_mn(acc.main, am + step_a, b + step_b, 1);
      hopper::wgmma_m64n128k16_ss_mn(acc.aux, aa + step_a, b + step_b, 1);
    }
    hopper::wgmma_commit();
    // slice kt − 1's products are done: its stage and masked tiles are free
    hopper::wgmma_wait<1>();
    fence_acc(acc);
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  fence_acc(acc);

  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = tm * kDecBM + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int j = 0; j < kDecBN / 8; ++j) {
    const int col = tn * kDecBN + 8 * j + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      const size_t at = (size_t)row * d + col;
      *reinterpret_cast<float2*>(y_main + at) =
          make_float2(acc.main[4 * j + 2 * h], acc.main[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(y_aux + at) =
          make_float2(acc.aux[4 * j + 2 * h], acc.aux[4 * j + 2 * h + 1]);
    }
  }
}

// (a) and (c): acts from x; xs is the centred operand's scratch.
int launch_encode(const float* x, const float* b_dec, const void* w_enc, const void* b_enc,
                  int m, int n, int d, void* acts, void* xs, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  CUtensorMap xmap, wemap;
  int err = hopper::matrix_map(&xmap, xs, m, d, kBK, kEncBM);
  if (!err) err = hopper::matrix_map(&wemap, w_enc, n, d, kBK, kEncBN);
  if (!err) err = hopper::allow_smem(encode_kernel, kEncSmem);
  if (err) return err;
  const long long chunks = (long long)m * d / 8;
  center_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
      x, b_dec, d, chunks, static_cast<bf16*>(xs));
  const int enc_tiles = ((m + kEncBM - 1) / kEncBM) * ((n + kEncBN - 1) / kEncBN);
  encode_kernel<<<enc_tiles, kThreads, kEncSmem, s>>>(
      xmap, wemap, static_cast<const bf16*>(b_enc), static_cast<bf16*>(acts), m, n, d);
  return static_cast<int>(cudaGetLastError());
}

// (e): both masked decodes of acts under the per-row thresholds.
int launch_decode(const void* acts, const void* w_dec, const float* t_main,
                  const float* t_aux, const uint32_t* dead_bits, int m, int n, int d,
                  float* y_main, float* y_aux, cudaStream_t s) {
  CUtensorMap amap, wdmap;
  int err = hopper::matrix_map(&amap, acts, m, n, kBK, kDecBM);
  if (!err) err = hopper::matrix_map(&wdmap, w_dec, n, d, 64, kBK);
  if (!err) err = hopper::allow_smem(decode_kernel, kDecSmem);
  if (err) return err;
  const int dec_tiles = ((m + kDecBM - 1) / kDecBM) * ((d + kDecBN - 1) / kDecBN);
  decode_kernel<<<dec_tiles, kThreads, kDecSmem, s>>>(amap, wdmap, t_main, t_aux, dead_bits,
                                                      y_main, y_aux, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

void launch_dead_bits(const uint8_t* dead, int n, uint32_t* dead_bits, cudaStream_t s) {
  topk::dead_bits_kernel<<<(n + topk::kBitsThreads - 1) / topk::kBitsThreads,
                           topk::kBitsThreads, 0, s>>>(dead, n, dead_bits);
}

}  // namespace

extern "C" {

// The widest n_dict the selection takes (its rows live in registers).
int freud_topk_fused_max_n() { return topk::max_n<topk::Bf16Bits>(); }

// x (m, d) f32; b_dec (d,) f32; w_enc (n, d) bf16; b_enc (n,) bf16;
// w_dec (n, d) bf16; dead (n,) uint8 → acts (m, n) bf16; y_main, y_aux (m, d)
// f32; t_main, t_aux (m,) f32; fired ceil(n / 32) words of bits, zeroed by
// the caller.
// Scratch: xs (m, d) bf16; dead_bits 2·ceil(n / 64) int32, zeroed by the
// caller. d % 32 == 0, n % 8 == 0, all bases 16-byte aligned. Returns
// cudaError_t.
int freud_topk_sae_forward(const float* x, const float* b_dec, const void* w_enc,
                           const void* b_enc, const void* w_dec, const uint8_t* dead,
                           int m, int n, int d, int k, int k_aux, void* acts,
                           float* y_main, float* y_aux, float* t_main, float* t_aux,
                           uint32_t* fired, void* xs, uint32_t* dead_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  launch_dead_bits(dead, n, dead_bits, s);
  int err = launch_encode(x, b_dec, w_enc, b_enc, m, n, d, acts, xs, s);
  if (err) return err;
  topk::SelectParams sel{};
  sel.acts = acts;
  sel.dead = dead_bits;
  sel.fired = fired;
  sel.t[0] = t_main;
  sel.t[1] = t_aux;
  sel.k[0] = static_cast<uint32_t>(k);
  sel.k[1] = static_cast<uint32_t>(k_aux);
  sel.m = m;
  sel.n = n;
  sel.nsel = 2;
  err = topk::launch_select<topk::Bf16Bits>(sel, s);
  if (err) return err;
  return launch_decode(acts, w_dec, t_main, t_aux, dead_bits, m, n, d, y_main, y_aux, s);
}

// The forward's encode alone, for a dictionary split over model ranks (the
// thresholds come from the selection across shards): launches (a) and (c).
// Arguments as freud_topk_sae_forward's.
int freud_topk_sae_encode(const float* x, const float* b_dec, const void* w_enc,
                          const void* b_enc, int m, int n, int d, void* acts, void* xs,
                          void* stream) {
  if (m == 0) return 0;
  return launch_encode(x, b_dec, w_enc, b_enc, m, n, d, acts, xs,
                       static_cast<cudaStream_t>(stream));
}

// The forward's decodes alone: launches (b) and (e) under the caller's
// thresholds t_main, t_aux (m,) f32, each a bf16 value (the exact path's).
// Arguments as freud_topk_sae_forward's.
int freud_topk_sae_decode(const void* acts, const void* w_dec, const uint8_t* dead,
                          const float* t_main, const float* t_aux, int m, int n, int d,
                          float* y_main, float* y_aux, uint32_t* dead_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  launch_dead_bits(dead, n, dead_bits, s);
  return launch_decode(acts, w_dec, t_main, t_aux, dead_bits, m, n, d, y_main, y_aux, s);
}

}  // extern "C"
