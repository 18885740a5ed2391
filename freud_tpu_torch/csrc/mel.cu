// Whisper log-mel front end for Hopper (sm_90a): the DFT on the tensor cores
// in the TPU kernel's three-product bf16 split, the rest in f32.
//
// Replaces the Pallas TPU kernel freud_tpu/ops/mel_pallas.py
// (log_mel_spectrogram_pallas → _mel_pallas_call → _kernel): reflect pad 200,
// frames of 400 at hop 160, Hann-windowed real DFT (201 bins), power, Slaney
// mel bank, log10(max(·, 1e-10)), per-clip floor at max − 8, (x + 4) / 4.
// (B, 480000) f32 → (B, n_mels, 3000) f32.
//
// Precision: the TPU kernel's recipe. Samples x and the windowed basis B are
// split into bf16 limbs, x = x_hi + x_lo and B = B_hi + B_lo (hi = bf16(v),
// lo = bf16(v − hi)), and the DFT is x_hi·B_hi + x_hi·B_lo + x_lo·B_hi with
// f32 sums (the dropped x_lo·B_lo is below 2^-18 of the product). The
// power, the mel projection and the rest stay f32.
//
// What bounds it on an H100: the three bf16 products, 3 × 2·3000·400·416 ≈
// 3.0 GFLOP a 30-s clip at the tensor-core rate (0.10 ms for a batch of
// 32); device memory carries only ~3 MB a clip. The basis limbs (2 × 416 ×
// 400 bf16, 666 KB) do not fit in shared memory, so every block streams
// them from L2: ~0.5 GB of L2 reads a batch of 32, which the design halves
// by sharing each basis tile between two consumer warpgroups.
//
// Design, one block per (128-frame tile, clip), warp-specialised:
//   * Frames as a plain matrix, the TPU kernel's reshape: over the (rows,
//     160) view of the padded clip, frame j is [row j | row j+1 | row j+2
//     [:80]], so sample n of frame j sits at row j + n / 160, column n % 160,
//     and a k-step of 16 samples never crosses a row. The 130 × 160 f32
//     samples of the tile are staged once in shared memory (cp.async; rows
//     padded to 168 floats against bank conflicts), reflect-padded by index
//     at the clip's ends: no padded copy of the audio in device memory. A row shift of 1 or 2 breaks a
//     swizzled descriptor's 8-row alignment, so A is not read by wgmma from
//     shared memory: each consumer warpgroup builds its bf16 hi and lo A
//     fragments in registers from the staged f32 samples at the k-step's
//     row shift (wgmma …_rs), double-buffered so one k-step's products run
//     while the next k-step's fragments are built.
//   * The basis as the B operand, K-major (416, 400) per limb: cos bins in
//     rows [0, 208), −sin bins in [208, 416), 201 of each nonzero. A
//     producer warp streams 32-wide K slices of both limbs by TMA (64-byte
//     swizzle) through a 4-stage ring, three slices in flight while one is
//     consumed; the two consumer warpgroups (64 frames each) share every
//     slice.
//   * Registers: the bins are walked in two chunks of 104; a chunk's B is
//     the 104 cos rows followed by the 104 −sin rows of the same bins
//     (m64n208k16, 104 f32 accumulators a thread), so a thread holds re and
//     im of the same bins and forms re² + im² in registers. The first
//     chunk's 52 power values a thread wait in registers through the
//     second chunk.
//   * Power then goes to shared memory (over the freed ring and samples).
//     The Slaney filters are triangles: band m is nonzero only on bins
//     [lo_m, hi_m) (391 weights of 16,080 at 80 bands), so the mel
//     projection sums that range only, in f32 — skipping exact zeros leaves
//     every sum unchanged — a warp a band, a lane four frames, the nonzero
//     weights staged in shared memory beside the samples. log10 goes
//     straight into the (B, n_mels, 3000) layout (a warp stores 32
//     consecutive frames of one band: coalesced).
//   * The per-clip max is a reduction across blocks: each block folds its max
//     into one unsigned word per clip with atomicMax on an order-preserving
//     float → uint mapping (log10 values are negative down to −10, so the raw
//     float bits would compare wrongly). Pass 2 applies the floor and affine.
// No sum is split across blocks or taken by atomics, so two launches agree
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSamples = 480000;
constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kFrames = 3000;
constexpr int kFreqs = 201;
constexpr int kPad = kNFFT / 2;
constexpr int kPaddedLen = kSamples + 2 * kPad;

constexpr int kTileFrames = 128;              // 64 per consumer warpgroup
constexpr int kRows = kTileFrames + 2;        // sample rows of 160 a tile needs
constexpr int kRowPitch = kHop + 8;           // floats a staged row
constexpr int kChunkBins = 104;               // bins a chunk: 2 chunks, 208 ≥ 201
constexpr int kChunkCols = 2 * kChunkBins;    // cos | −sin of the same bins
constexpr int kBasisRows = 2 * kChunkCols;    // 416 a limb: cos 0..207 | −sin 0..207
constexpr int kBK = 32;                       // one 64-byte swizzle row of bf16
constexpr int kSlices = (kNFFT + kBK - 1) / kBK;  // 13 (the last one 16 wide)
constexpr int kSteps = kNFFT / 16;            // 25 k-steps of 16 samples
constexpr int kStepsPerSlice = kBK / 16;
constexpr int kStages = 4;
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kPowerPitch = kChunkCols + 1;   // floats a power row (odd: no conflicts)
constexpr int kMaxMels = 128;
constexpr int kMaxWeights = 2 * kFreqs;       // a bin lies in at most two triangles
constexpr uint32_t kBoxBytes = kChunkBins * kBK * 2;

struct MelSmem {  // the basis tiles 512-byte aligned (the swizzle atom)
  __nv_bfloat16 b[kStages][2][kChunkCols * kBK];  // [stage][hi, lo]: cos rows, then −sin
  float samples[kRows * kRowPitch];
  float weights[kMaxWeights];  // the bank's nonzero weights, band after band
  int bands[3 * kMaxMels];     // a band's first bin, end bin, first weight
  uint64_t full[kStages];
  uint64_t empty[kStages];
  unsigned int block_max;
};
constexpr size_t kMelSmem = sizeof(MelSmem) + 1024;  // + alignment slack
static_assert(kTileFrames * kPowerPitch * sizeof(float) <=
                  sizeof(MelSmem::b) + sizeof(MelSmem::samples),
              "the power tile overlays the ring and the samples");

// Order-preserving map float → uint32 (0 sorts below every float).
__device__ __forceinline__ unsigned int ordered_bits(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Two neighbouring f32 samples as bf16 hi and lo limbs, one 32-bit fragment
// register each (the lower column in the low half).
__device__ __forceinline__ void split_limbs(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Padded sample p of a clip: audio index p − 200, reflected at both ends;
// zero past the padded signal (frames ≥ 3000 of the last tile, never stored).
__device__ __forceinline__ float padded_sample(const float* x, int p) {
  if (p >= kPaddedLen) return 0.f;
  int a = p - kPad;
  if (a < 0) a = -a;
  if (a >= kSamples) a = 2 * (kSamples - 1) - a;
  return x[a];
}

// The A fragments (64 frames × 16 samples) of k-step q for the frame rows r
// and r + 8 of this thread: from the staged samples at the step's row shift.
__device__ __forceinline__ void build_fragments(const float* srow, int q, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  const int band = (16 * q) / kHop;  // the row shift, 0, 1 or 2
  const float* src = srow + band * kRowPitch + 16 * q - kHop * band;
  const float2 r0k0 = *reinterpret_cast<const float2*>(src);
  const float2 r8k0 = *reinterpret_cast<const float2*>(src + 8 * kRowPitch);
  const float2 r0k8 = *reinterpret_cast<const float2*>(src + 8);
  const float2 r8k8 = *reinterpret_cast<const float2*>(src + 8 * kRowPitch + 8);
  split_limbs(r0k0, hi[0], lo[0]);
  split_limbs(r8k0, hi[1], lo[1]);
  split_limbs(r0k8, hi[2], lo[2]);
  split_limbs(r8k8, hi[3], lo[3]);
}

// One chunk of 104 bins: acc (64 frames × [104 cos | 104 −sin]) over the 25
// k-steps, hi·hi + hi·lo + lo·hi. `it0` counts the slices consumed before.
__device__ __forceinline__ void dft_chunk(MelSmem& sm, const float* srow, int it0, int lane,
                                          float (&acc)[kChunkCols / 2]) {
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] = 0.f;
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const int sl = q / kStepsPerSlice;
    const int kk = q % kStepsPerSlice;
    const int st = (it0 + sl) % kStages;
    // fragments of step q: the buffer of step q − 2, whose products are done
    build_fragments(srow, q, hi[q & 1], lo[q & 1]);
    if (kk == 0) hopper::mbar_wait(&sm.full[st], ((it0 + sl) / kStages) & 1);
    const uint64_t bhi = hopper::desc_sw64(sm.b[st][0]) + hopper::k_step_kmajor(kk);
    const uint64_t blo = hopper::desc_sw64(sm.b[st][1]) + hopper::k_step_kmajor(kk);
    hopper::fence_regs(acc);
    hopper::fence_regs(hi[q & 1]);
    hopper::fence_regs(lo[q & 1]);
    hopper::wgmma_fence();
    hopper::wgmma_m64n208k16_rs(acc, hi[q & 1], bhi, 1);
    hopper::wgmma_m64n208k16_rs(acc, hi[q & 1], blo, 1);
    hopper::wgmma_m64n208k16_rs(acc, lo[q & 1], bhi, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // step q − 1's products are done
    hopper::fence_regs(acc);
    // the slice of step q − 1 is free once its last step is done
    if (kk == 0 && q > 0 && lane == 0)
      hopper::mbar_arrive(&sm.empty[(it0 + sl - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (lane == 0) hopper::mbar_arrive(&sm.empty[(it0 + kSlices - 1) % kStages]);
}

// re² + im² of a chunk: power index 4j + e from accumulator columns 8j +
// 2t + e % 2 (cos, bin 8j + 2t + e % 2) and 104 further (−sin, same bin).
__device__ __forceinline__ void chunk_power(const float (&acc)[kChunkCols / 2],
                                            float (&p)[kChunkCols / 4]) {
#pragma unroll
  for (int i = 0; i < kChunkCols / 4; ++i) {
    const float re = acc[i];
    const float im = acc[i + kChunkCols / 4];
    p[i] = re * re + im * im;
  }
}

// audio (B, kSamples) f32; bmap: tensor map over the basis limbs (2·416,
// 400) bf16, box (32, 104); weights (n_weights,) f32, the filterbank's
// nonzero weights band after band; bands (3, n_mels) i32: each band's first
// bin, end bin and first weight → out (B, n_mels, kFrames) unfloored
// log10-mel; clip_max (B,) ordered bits, zeroed by the caller.
__global__ void __launch_bounds__(kThreads, 1)
log10_mel_kernel(const float* __restrict__ audio, const __grid_constant__ CUtensorMap bmap,
                 const float* __restrict__ weights, int n_weights, const int* __restrict__ bands,
                 float* __restrict__ out, unsigned int* __restrict__ clip_max, int n_mels) {
  extern __shared__ unsigned char smem_raw[];
  MelSmem& sm = *reinterpret_cast<MelSmem*>(hopper::align1024(smem_raw));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int clip = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], kConsumers / 32);  // one arrival a warp
    }
    sm.block_max = 0u;
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ------------------------------ producer
    if (lane == 0) {
      for (int it = 0; it < 2 * kSlices; ++it) {
        const int st = it % kStages;
        const int c = it / kSlices;  // chunk: bins 104c … 104c + 103
        const int k0 = (it % kSlices) * kBK;
        if (it >= kStages) hopper::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&sm.full[st], 4 * kBoxBytes);
        for (int limb = 0; limb < 2; ++limb) {
          __nv_bfloat16* dst = sm.b[st][limb];
          const int row0 = limb * kBasisRows + c * kChunkBins;
          hopper::tma_load_2d(dst, &bmap, &sm.full[st], k0, row0);
          hopper::tma_load_2d(dst + kChunkBins * kBK, &bmap, &sm.full[st], k0,
                              row0 + kBasisRows / 2);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  // Stage the tile's samples: padded index p = 160·t0 + i lands at row
  // i / 160, column i % 160. Pieces of 4 inside the clip are copied with
  // cp.async, all in flight at once (160·t0 − 200 is a multiple of 4); the
  // pieces past either end reflect and zero-fill by index.
  const float* x = audio + (size_t)clip * kSamples;
  const int first = kHop * t0 - kPad;  // audio index of padded sample 160·t0
  for (int i = 4 * tid; i < kRows * kHop; i += 4 * kConsumers) {
    float* dst = sm.samples + (i / kHop) * kRowPitch + i % kHop;
    if (first + i >= 0 && first + i + 4 <= kSamples) {
      hopper::cp_async16(dst, x + first + i);
    } else {
      const int p = kHop * t0 + i;
      *reinterpret_cast<float4*>(dst) =
          make_float4(padded_sample(x, p), padded_sample(x, p + 1), padded_sample(x, p + 2),
                      padded_sample(x, p + 3));
    }
  }
  // the filterbank beside them: the epilogue reads it with no global latency
  for (int i = tid; i < n_weights; i += kConsumers) sm.weights[i] = weights[i];
  for (int i = tid; i < 3 * n_mels; i += kConsumers) sm.bands[i] = bands[i];
  hopper::cp_async_wait_all();
  hopper::named_barrier(1, kConsumers);

  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r = wg * 64 + (warp % 4) * 16 + g;  // tile frames r and r + 8
  const float* srow = sm.samples + r * kRowPitch + 2 * t;
  float acc[kChunkCols / 2];
  float p0[kChunkCols / 4], p1[kChunkCols / 4];
  dft_chunk(sm, srow, 0, lane, acc);
  chunk_power(acc, p0);
  dft_chunk(sm, srow, kSlices, lane, acc);
  chunk_power(acc, p1);

  // Both warpgroups are done with the ring and the samples: power over them.
  hopper::named_barrier(1, kConsumers);
  float* power = reinterpret_cast<float*>(&sm);  // (128, kPowerPitch)
#pragma unroll
  for (int i = 0; i < kChunkCols / 4; ++i) {
    const int row = r + 8 * ((i / 2) % 2);
    const int bin = 8 * (i / 4) + 2 * t + i % 2;
    power[row * kPowerPitch + bin] = p0[i];
    power[row * kPowerPitch + kChunkBins + bin] = p1[i];
  }
  hopper::named_barrier(1, kConsumers);

  // Mel projection over each band's nonzero bins + log10: a warp takes a
  // band at a time (its weights are one broadcast load a bin), a lane four
  // frames, lane + 32i, so the four sums run side by side and each store of
  // 32 neighbouring frames is coalesced.
  float local_max = -INFINITY;
  for (int m = warp; m < n_mels; m += kConsumers / 32) {
    const int lo = sm.bands[m];
    const int hi = sm.bands[n_mels + m];
    const float* w = sm.weights + sm.bands[2 * n_mels + m] - lo;
    float a[kTileFrames / 32] = {};
    for (int k = lo; k < hi; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int i = 0; i < kTileFrames / 32; ++i)
        a[i] = fmaf(power[(lane + 32 * i) * kPowerPitch + k], wk, a[i]);
    }
#pragma unroll
    for (int i = 0; i < kTileFrames / 32; ++i) {
      const int frame = t0 + lane + 32 * i;
      if (frame < kFrames) {
        const float v = log10f(fmaxf(a[i], 1e-10f));
        out[((size_t)clip * n_mels + m) * kFrames + frame] = v;
        local_max = fmaxf(local_max, v);
      }
    }
  }
  atomicMax(&sm.block_max, ordered_bits(local_max));
  hopper::named_barrier(1, kConsumers);
  if (tid == 0) atomicMax(clip_max + clip, sm.block_max);
}

// Four values a thread (a clip's n_mels · 3000 values are a multiple of 4).
__global__ void floor_affine_kernel(float* __restrict__ out,
                                    const unsigned int* __restrict__ clip_max,
                                    int per_clip, long long total) {
  const long long i = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
  if (i >= total) return;
  const float floor_v = from_ordered_bits(clip_max[i / per_clip]) - 8.0f;
  float4 v = *reinterpret_cast<const float4*>(out + i);
  v.x = (fmaxf(v.x, floor_v) + 4.0f) * 0.25f;
  v.y = (fmaxf(v.y, floor_v) + 4.0f) * 0.25f;
  v.z = (fmaxf(v.z, floor_v) + 4.0f) * 0.25f;
  v.w = (fmaxf(v.w, floor_v) + 4.0f) * 0.25f;
  *reinterpret_cast<float4*>(out + i) = v;
}

}  // namespace

extern "C" {

// audio (B, 480000) f32, 16-byte aligned; basis (2, 416, 400) bf16, the hi
// and lo limbs of the windowed basis, K-major: row n of a limb is cos bin n
// (n < 208) or −sin bin n − 208, zero past bin 200; weights (n_weights,) f32,
// the Slaney filterbank's nonzero weights band after band (n_weights ≤ 402);
// bands (3, n_mels) i32: each band's first bin, end bin and first weight;
// out (B, n_mels, 3000) f32; clip_max (B,) u32 scratch; n_mels ≤ 128.
// Returns cudaError_t.
int freud_log_mel(const float* audio, const void* basis, const float* weights, int n_weights,
                  const int* bands, float* out, unsigned int* clip_max, int batch, int n_mels,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_mels > kMaxMels || n_weights > kMaxWeights)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap bmap;
  int err = hopper::matrix_map(&bmap, basis, 2 * kBasisRows, kNFFT, kBK, kChunkBins,
                               CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err) err = hopper::allow_smem(log10_mel_kernel, kMelSmem);
  if (!err) err = static_cast<int>(cudaMemsetAsync(clip_max, 0, sizeof(unsigned int) * batch, s));
  if (err) return err;
  const dim3 grid((kFrames + kTileFrames - 1) / kTileFrames, batch);
  log10_mel_kernel<<<grid, kThreads, kMelSmem, s>>>(audio, bmap, weights, n_weights, bands,
                                                    out, clip_max, n_mels);
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const long long total = (long long)batch * n_mels * kFrames;
  const int threads = 256;
  floor_affine_kernel<<<(unsigned)((total / 4 + threads - 1) / threads), threads, 0, s>>>(
      out, clip_max, n_mels * kFrames, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
