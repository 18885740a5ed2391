// Per-row selection core shared by csrc/topk_threshold.cu and
// csrc/topk_fused.cu: one block of kSelectThreads threads owns one row of the
// (M, n_dict) latent, staged in shared memory as 16-bit order keys beside
// the dead mask as bits (dead_bits_kernel packs it once per launch), so a
// row at n_dict 20,480 takes 43 KB and several rows' blocks share an SM.
//
// For non-negative bf16 values the bit pattern orders like the value. The JAX
// kernels (freud_tpu/ops/topk_fused.py _int_bisect_packed) bisect the bf16
// bits read as int16; key = bits ^ 0x8000 is that int16 order as an unsigned
// 16-bit number, so a comparison of keys is the TPU kernel's comparison of
// bits, for every input. The k-th largest key is found exactly by radix
// select: a histogram of the high byte picks the bucket that holds it, a
// histogram of the low byte inside that bucket picks the key; the passes are
// shared by every threshold of the row. The rules at the edges are the
// bisection's (topk_fused.py:85-110, 319-321, 351-354):
//   * t is the largest key with count(key >= t) >= k;
//   * fewer than k candidates: t is the smallest candidate (select all);
//   * no candidate at all: t is +inf (bits 0x7F80), which selects nothing.
// Shared-memory atomics on a histogram are contended when many values share a
// byte (half a ReLU row is zero), so in the high-byte pass each warp first
// merges equal bins with __match_any_sync and one lane adds the group's
// count; the dead keys' histogram shares that pass (one match per key).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr int kSelectThreads = 256;
constexpr int kWarps = kSelectThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kInfKey = 0x7F80u ^ 0x8000u;  // the key of bf16 +inf

constexpr int kMaxSel = 3;  // t_main, t_aux, t_multi

struct Scratch {
  uint32_t hist[kMaxSel][256];
  uint32_t bcast[4 * kMaxSel];
  uint32_t warp[kWarps];
  float warp_f[kWarps];
};

__device__ __forceinline__ uint32_t key_to_bits(uint32_t key) {
  return (key ^ 0x8000u) & 0xFFFFu;
}
__device__ __forceinline__ float key_to_float(uint32_t key) {
  return __uint_as_float(key_to_bits(key) << 16);
}
// value > 0  <=>  int16(bits) > 0  <=>  key > 0x8000
__device__ __forceinline__ bool key_positive(uint32_t key) { return key > 0x8000u; }

// The dead mask (n,) bytes → bits (ceil(n / 32) words), bit j % 32 of word
// j / 32 set for a dead column j.
__global__ void __launch_bounds__(kSelectThreads)
dead_bits_kernel(const uint8_t* __restrict__ dead_g, int n, uint32_t* __restrict__ bits) {
  const int j = blockIdx.x * kSelectThreads + threadIdx.x;
  const uint32_t word = __ballot_sync(kFull, j < n && dead_g[j] != 0);
  if ((threadIdx.x & 31) == 0 && j < n) bits[j >> 5] = word;
}

__device__ __forceinline__ bool is_dead(const uint32_t* bits, int j) {
  return (bits[j >> 5] >> (j & 31)) & 1u;
}

// Bytes of dynamic shared memory a row of n keys and its dead bits take.
__host__ __device__ constexpr size_t row_smem_bytes(int n) {
  return ((2 * (size_t)n + 15) & ~(size_t)15) + 4 * (((size_t)n + 31) / 32);
}

// Stage one bf16 row as keys and the dead bits; returns the number of dead
// columns (every thread gets it).
__device__ uint32_t load_row(const uint16_t* __restrict__ src,
                             const uint32_t* __restrict__ dead_g, int n,
                             uint16_t* keys, uint32_t* dead, Scratch& s) {
  const int tid = threadIdx.x;
  if ((n & 7) == 0) {  // 16-byte loads: 8 bf16 per thread and step
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* k4 = reinterpret_cast<uint4*>(keys);
    for (int i = tid; i < n / 8; i += kSelectThreads) {
      uint4 v = s4[i];
      v.x ^= 0x80008000u;
      v.y ^= 0x80008000u;
      v.z ^= 0x80008000u;
      v.w ^= 0x80008000u;
      k4[i] = v;
    }
  } else {
    for (int j = tid; j < n; j += kSelectThreads) keys[j] = src[j] ^ 0x8000u;
  }
  uint32_t nd = 0;
  for (int w = tid; w < (n + 31) / 32; w += kSelectThreads) {
    const uint32_t word = dead_g[w];
    dead[w] = word;
    nd += __popc(word);
  }
  nd = __reduce_add_sync(kFull, nd);
  if ((tid & 31) == 0) s.warp[tid >> 5] = nd;
  __syncthreads();
  uint32_t total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s.warp[w];
  __syncthreads();  // s.warp is reused by the next reduction
  return total;
}

// Smallest key among candidates (dead[j] when only_dead).
__device__ uint32_t block_min_key(const uint16_t* keys, const uint32_t* dead,
                                  bool only_dead, int n, Scratch& s) {
  uint32_t m = 0xFFFFu;
  for (int j = threadIdx.x; j < n; j += kSelectThreads)
    if (!only_dead || is_dead(dead, j)) m = min(m, (uint32_t)keys[j]);
  m = __reduce_min_sync(kFull, m);
  if ((threadIdx.x & 31) == 0) s.warp[threadIdx.x >> 5] = m;
  __syncthreads();
  uint32_t out = 0xFFFFu;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) out = min(out, s.warp[w]);
  __syncthreads();
  return out;
}

// Adds one to hist[bin] for every lane whose bin < bins; lanes with equal
// bins are merged first (one atomic per group). All 32 lanes must call it.
__device__ __forceinline__ void warp_count(uint32_t bin, uint32_t* hist, uint32_t bins) {
  const int lane = threadIdx.x & 31;
  const uint32_t peers = __match_any_sync(kFull, bin);
  if (bin < bins && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
}

// Run by one warp: the largest bin b of hist with (count of bins >= b) >= k,
// and the count of bins above it, into out[0], out[1]. The histogram's total
// must be >= k.
__device__ void find_bin(const uint32_t* hist, uint32_t k, uint32_t* out) {
  const int lane = threadIdx.x & 31;
  uint32_t own = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) own += hist[8 * lane + b];
  uint32_t suffix = own;  // bins of lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_down_sync(kFull, suffix, off);
    if (lane + off < 32) suffix += v;
  }
  uint32_t above = __shfl_down_sync(kFull, suffix, 1);  // bins of lanes > lane
  if (lane == 31) above = 0;
  if (suffix >= k && above < k) {
    for (int b = 8 * lane + 7; b >= 8 * lane; --b) {
      if (above + hist[b] >= k) {
        out[0] = b;
        out[1] = above;
        break;
      }
      above += hist[b];
    }
  }
}

// Up to kMaxSel selections over one staged row, sharing the passes: one
// pass histograms the high bytes of all keys and of the dead keys, warp i
// finds selection i's bucket, one pass histograms each selection's low
// bytes inside its bucket, warp i finds the key. k[i] is selection i's rank,
// only_dead[i] whether its candidates are the dead columns; n_dead counts
// those. out[i] follows the edge rules in the header.
__device__ void select_many(const uint16_t* keys, const uint32_t* dead, int n,
                            int nsel, const uint32_t* k, const bool* only_dead,
                            uint32_t n_dead, uint32_t* out, Scratch& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  bool radix[kMaxSel];
  bool any_dead = false;
  for (int i = 0; i < nsel; ++i) {
    const uint32_t count = only_dead[i] ? n_dead : (uint32_t)n;
    radix[i] = count >= k[i] && count > 0;
    if (count == 0)
      out[i] = kInfKey;
    else if (count < k[i])
      out[i] = block_min_key(keys, dead, only_dead[i], n, s);
    any_dead |= radix[i] && only_dead[i];
  }
  // high bytes in one pass of one 512-bin histogram: a live key counts in
  // bin hi of hist[0], a dead one in bin hi of hist[1]; then hist[0] +=
  // hist[1] makes hist[0] count all keys
  for (int i = tid; i < 2 * 256; i += kSelectThreads) s.hist[i / 256][i % 256] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kSelectThreads) {
    const int j = base + tid;
    uint32_t bin = 0x200u + lane;  // no bin, and unique: matches no lane
    if (j < n) bin = ((uint32_t)keys[j] >> 8) | (any_dead && is_dead(dead, j) ? 0x100u : 0u);
    warp_count(bin, s.hist[0], 0x200u);
  }
  __syncthreads();
  if (any_dead) {
    for (int b = tid; b < 256; b += kSelectThreads) s.hist[0][b] += s.hist[1][b];
    __syncthreads();
  }
  if (warp < nsel && radix[warp])
    find_bin(s.hist[only_dead[warp] ? 1 : 0], k[warp], &s.bcast[4 * warp]);
  __syncthreads();
  uint32_t bucket[kMaxSel];
  for (int i = 0; i < nsel; ++i) bucket[i] = radix[i] ? s.bcast[4 * i] : 0x100u;
  for (int i = tid; i < nsel * 256; i += kSelectThreads) s.hist[i / 256][i % 256] = 0;
  __syncthreads();
  // low bytes inside each bucket: few keys fall there, so plain atomics
  for (int j = tid; j < n; j += kSelectThreads) {
    const uint32_t key = keys[j];
    for (int i = 0; i < nsel; ++i)
      if ((key >> 8) == bucket[i] && (!only_dead[i] || is_dead(dead, j)))
        atomicAdd(&s.hist[i][key & 0xFFu], 1u);
  }
  __syncthreads();
  if (warp < nsel && radix[warp])
    find_bin(s.hist[warp], k[warp] - s.bcast[4 * warp + 1], &s.bcast[4 * warp + 2]);
  __syncthreads();
  for (int i = 0; i < nsel; ++i)
    if (radix[i]) out[i] = (bucket[i] << 8) | s.bcast[4 * i + 2];
  __syncthreads();  // s.bcast and s.hist are reused by the next call
}

// One block per row: the exact thresholds of `nsel` selections (t_main
// with k[0], t_aux with k[1] among dead columns, t_multi with k[2]) into
// t[i][row] as f32, and fired[j] = 1 for every positive key >= t_main.
// keys and dead point into dynamic shared memory (row_smem_bytes).
__device__ void select_row(const uint16_t* __restrict__ acts, const uint32_t* __restrict__ dead_g,
                           int n, int nsel, const uint32_t* k, float* const* t,
                           int* __restrict__ fired, unsigned char* smem, Scratch& s) {
  uint16_t* keys = reinterpret_cast<uint16_t*>(smem);
  uint32_t* dead = reinterpret_cast<uint32_t*>(smem + ((2 * (size_t)n + 15) & ~(size_t)15));
  const size_t row = blockIdx.x;
  const uint32_t n_dead = load_row(acts + row * n, dead_g, n, keys, dead, s);
  __syncthreads();
  const bool only_dead[kMaxSel] = {false, true, false};
  uint32_t out[kMaxSel];
  select_many(keys, dead, n, nsel, k, only_dead, n_dead, out, s);
  if (threadIdx.x == 0)
    for (int i = 0; i < nsel; ++i) t[i][row] = key_to_float(out[i]);
  const uint32_t km = out[0];
  for (int j = threadIdx.x; j < n; j += kSelectThreads) {
    const uint32_t key = keys[j];
    // OR into the mask: every writer stores the same 1
    if (key >= km && key_positive(key)) fired[j] = 1;
  }
}

}  // namespace topk
