// f32-grade matrix product y = x · Wᵀ (+ b) on Hopper's tensor cores in
// three TF32 products (3xTF32), for the f32 linears of the Whisper encoder
// and the SAE encode's product.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA, and
// the port ran them on cuBLAS's f32 SIMT kernel (TF32 off), which holds
// most of an f32 collection batch at ~75% of the card's 67 TFLOP/s f32
// peak, with the tensor cores idle. One TF32 product keeps 10 bits of each
// operand and fails the f32 configurations' checks; three keep f32's
// precision:
//   v = hi + lo,  hi = rna_tf32(v),  lo = rna_tf32(v − hi)
//   x · Wᵀ ≈ x_lo · W_hiᵀ + x_hi · W_loᵀ + x_hi · W_hiᵀ
// (the dropped x_lo · W_loᵀ and lo's rounding are ≤ ~2⁻²¹ of a product).
// W's limbs are split on every call, by one elementwise pass launched just
// before the product (W read once, both limbs written: ~1% of the product's
// time at the encoder's shapes); x's are built in the product kernel, in
// registers, from the staged f32 tile.
//
// Accumulation. The tensor cores' f32 accumulator rounds toward zero
// (Ootomo & Yokota 2022), so sums are not left in it for long: each
// warpgroup sums one 32-wide K slice into a fresh partial accumulator — the
// two correction products of the whole slice first, then x_hi · W_hiᵀ — and
// promotes it into f32 registers with a round-to-nearest add. The slice's
// register A fragments are reused, so its products are waited for anyway;
// promoting every 2 or 4 slices instead measured no faster and up to 3×
// less accurate. No split-K, no atomics: every output sums in a fixed order
// and repeats bit for bit.
//
// What bounds it on an H100: the three TF32 products, 3 · 2·M·N·K at 495
// TFLOP/s (a large collection batch: 3 × 34.6 TFLOP); device memory carries
// x once a column tile and W's two limbs once a row tile, and the split
// reads W once and writes its limbs (3 · 4·N·K bytes a call).
//
// Design: the split (gemm_f32x3_split_kernel), then a persistent grid of one block an SM over 128 × 128 output tiles
// (row tiles walked kGroup at a time across the column tiles, so a
// weight's tiles are reused from L2), warp-specialised:
//   * a producer warp streams 32-wide K slices of x and of both W limbs
//     (K-major, f32, 128-byte swizzle; TMA zero-fills past M, N and K)
//     through a ring of kStages stages, running ahead into the next tile
//     while the consumers write one out;
//   * two consumer warpgroups of 64 rows each load their A fragments of the
//     slice from the swizzled tile (conflict-free), split each into TF32 hi
//     and lo limbs (cvt.rna), issue the slice's twelve m64n128k8 products
//     with A from registers and B from shared memory, wait for them, free
//     the stage and promote; one warpgroup's wait overlaps the other's
//     products;
//   * the epilogue adds the bias (when given) and stores from registers,
//     masking rows past M and columns past N.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kBM = 128, kBN = 128;         // output tile
constexpr int kBK = 32;                     // one 128-byte swizzle row of f32
constexpr int kSteps = kBK / 8;             // k-steps of 8 a slice
constexpr int kStages = 4;
constexpr int kGroup = 8;                   // row tiles walked together
constexpr uint32_t kStageBytes = (kBM + 2 * kBN) * kBK * 4;

struct Smem {  // every tile 1024-byte aligned (the swizzle atom)
  float a[kStages][kBM * kBK];        // x: 128 rows × 32
  float b[kStages][2][kBN * kBK];     // W_hi, W_lo: 128 rows × 32 each
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmem = sizeof(Smem) + 1024;

// An f32 tensor map over a row-major (rows, cols) matrix, box (32, box_rows),
// 128-byte swizzle; cols × 4 must be a multiple of 16.
int f32_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectInitFailed);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {4ull * cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// v rounded to TF32, to nearest with ties away from zero, as f32 bits.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xFFFFE000u;
}

// W (count4 float4s) → its TF32 limbs, hi = rna_tf32(W), lo = rna_tf32(W − hi).
__global__ void __launch_bounds__(256)
gemm_f32x3_split_kernel(const float4* __restrict__ w, float4* __restrict__ hi,
                        float4* __restrict__ lo, long long count4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < count4; i += gridDim.x * 256ll) {
    const float4 v = w[i];
    const float4 h = make_float4(__uint_as_float(tf32_rna(v.x)), __uint_as_float(tf32_rna(v.y)),
                                 __uint_as_float(tf32_rna(v.z)), __uint_as_float(tf32_rna(v.w)));
    hi[i] = h;
    lo[i] = make_float4(__uint_as_float(tf32_rna(v.x - h.x)), __uint_as_float(tf32_rna(v.y - h.y)),
                        __uint_as_float(tf32_rna(v.z - h.z)), __uint_as_float(tf32_rna(v.w - h.w)));
  }
}

// D(64 × 128) (+)= A(64 × 8, registers) · B(128 × 8)ᵀ in TF32, B K-major in
// shared memory. A fragment of warp w: a0 (16w + g, t), a1 (16w + g + 8, t),
// a2 (16w + g, t + 4), a3 (16w + g + 8, t + 4), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// xmap: tensor map (k, m), box (32, 128); hmap, lmap: W_hi, W_lo (k, n), box
// (32, 128); bias (n,) or null → y (m, n) f32.
__global__ void __launch_bounds__(kThreads, 1)
gemm_f32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap lmap, const float* __restrict__ bias,
                  float* __restrict__ y, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hopper::align1024(smem_raw));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_m = (m + kBM - 1) / kBM;
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int k_tiles = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
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
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int tm, tn;
        hopper::grouped_tile(tile, tiles_m, tiles_n, kGroup, tm, tn);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int st = it % kStages;
          if (it >= kStages) hopper::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          hopper::mbar_expect_tx(&sm.full[st], kStageBytes);
          hopper::tma_load_2d(sm.a[st], &xmap, &sm.full[st], kt * kBK, tm * kBM);
          hopper::tma_load_2d(sm.b[st][0], &hmap, &sm.full[st], kt * kBK, tn * kBN);
          hopper::tma_load_2d(sm.b[st][1], &lmap, &sm.full[st], kt * kBK, tn * kBN);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;
  const int wl = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int tm, tn;
    hopper::grouped_tile(tile, tiles_m, tiles_n, kGroup, tm, tn);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(&sm.full[st], (it / kStages) & 1);
      // A fragments of the slice: element (r, c) of the swizzled tile sits
      // at float 32·r + 4·((c / 4) ^ (r % 8)) + c % 4, and r % 8 = g here
      const float* at = sm.a[st] + (wg * 64 + wl * 16 + g) * kBK + t;
      uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int chunk = (2 * kk + (e >> 1)) ^ g;
          const float v = at[(e & 1) * 8 * kBK + 4 * chunk];
          hi[kk][e] = tf32_rna(v);
          lo[kk][e] = tf32_rna(v - __uint_as_float(hi[kk][e]));
        }
      }
      const uint64_t bhi = hopper::desc_sw128(sm.b[st][0]);
      const uint64_t blo = hopper::desc_sw128(sm.b[st][1]);
      hopper::fence_regs(part);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        wgmma_m64n128k8_tf32_rs(part, lo[kk], bhi + hopper::k_step_kmajor(kk), kk > 0);
        wgmma_m64n128k8_tf32_rs(part, hi[kk], blo + hopper::k_step_kmajor(kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_m64n128k8_tf32_rs(part, hi[kk], bhi + hopper::k_step_kmajor(kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[st]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    const int row0 = tm * kBM + wg * 64 + wl * 16 + g;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = tn * kBN + 8 * j + 2 * t;
      if (col >= n) continue;
      const bool pair = col + 1 < n;
      const float b0 = bias != nullptr ? bias[col] : 0.f;
      const float b1 = bias != nullptr && pair ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= m) continue;
        float* out = y + (size_t)row * n + col;
        const float v0 = acc[4 * j + 2 * h] + b0;
        const float v1 = acc[4 * j + 2 * h + 1] + b1;
        if (pair && (n % 2 == 0)) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (pair) out[1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x (m, k) f32, w (n, k) f32; bias (n,) f32 or null → y (m, n) f32. w_hi,
// w_lo (n, k) f32: scratch for W's TF32 limbs (hi = rna_tf32(W), lo =
// rna_tf32(W − hi)), written by the split launched first on the stream.
// k % 4 == 0; x, w, w_hi and w_lo 16-byte aligned. Returns cudaError_t.
int freud_gemm_f32x3(const float* x, const float* w, float* w_hi, float* w_lo, const float* bias,
                     float* y, int m, int n, int k, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k <= 0 || k % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap xmap, hmap, lmap;
  int err = f32_map(&xmap, x, m, k, kBM);
  if (!err) err = f32_map(&hmap, w_hi, n, k, kBN);
  if (!err) err = f32_map(&lmap, w_lo, n, k, kBN);
  if (!err) err = hopper::allow_smem(gemm_f32x3_kernel, kSmem);
  int sms = 0;
  if (!err) err = hopper::sm_count(&sms);
  if (err) return err;
  const long long count4 = (long long)n * k / 4;
  const long long blocks = (count4 + 255) / 256;
  gemm_f32x3_split_kernel<<<static_cast<int>(blocks < 8ll * sms ? blocks : 8ll * sms), 256, 0, s>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<float4*>(w_hi),
      reinterpret_cast<float4*>(w_lo), count4);
  const long long tiles = (long long)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_f32x3_kernel<<<grid, kThreads, kSmem, s>>>(
      xmap, hmap, lmap, bias, y, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
