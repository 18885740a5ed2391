// TopK thresholds across dictionary shards, for Hopper (sm_90a): kernel #3's
// selection (csrc/topk_threshold.cu) when each of P model ranks holds
// n_dict / P columns of every row of the (M, n_dict) latent.
//
// Replaces the Pallas TPU kernel freud_tpu/ops/topk_threshold.py
// (topk_thresholds_fired) on a dictionary split over the mesh's model axis,
// where XLA gathers the whole latent for it. Here the latent never moves;
// two launches and one all-gather of O(M · P · (k_sel + k_aux)) keys do:
//
//   * candidates, on the local (M, n_s) shard: the shard's top
//     min(k_sel, n_s) order keys (k_sel = max(k, k_multi)), its top
//     min(k_aux, d_s) keys among its d_s dead columns, and a header: the
//     smallest finite and the largest key of the row, all columns and the
//     dead ones, and d_s. A row of the output is
//         [c_main keys | k_aux keys | lo_all, hi_all, lo_dead, hi_dead, d_s]
//     with c_main = min(k_sel, n_s); the aux region past min(k_aux, d_s) is
//     padding (0) that the combine never reads. The global top-k of a row
//     lies in the union of the shards' top-k, so the gathered keys hold the
//     k-th largest with its multiplicity, however ties split over shards.
//   * (between them, on the host side) the rows of every model rank
//     gathered: (P, M, width) keys, the same bytes on every rank;
//   * combine: t_main, t_aux and t_multi from the gathered keys with kernel
//     #3's rules, bit for bit, and this shard's fired bits. Exact path (bf16
//     bits): the k-th key; fewer than k candidates in the whole row: the
//     smallest; none: +inf. Float path: the 26-step bisection replayed on
//     scalars from the GLOBAL lo and hi (the headers' min and max), with v_k
//     the gathered k-th key (csrc/topk_select.cuh says why that equals the
//     bisection). Candidates alone would give a different lo and hi, hence
//     a different threshold. Every count that routes a selection (n_dict,
//     the dead count) is the global one.
//
// The keys are csrc/topk_select.cuh's order keys (Bf16Bits, Bf16Value,
// F32Value).
//
// What bounds it on an H100: the candidates launch reads the shard once
// (M · n_s · 2 bytes in bf16) and writes M · width words; the combine reads
// the gathered P · M · width words and the shard again for the fired bits,
// most of its bytes. The design:
//   * candidates is kernel #3's selection core (topk_select.cuh) with its
//     candidates epilogue: rows stream by bulk copies into a ring, keys sit
//     in registers, the zero key is counted apart, the radix passes run over
//     the keys staged above the last row's cutoffs (a stage sized from the
//     ranks: k_aux 640 of a narrow shard stages more than #3's eighth of a
//     row), and the epilogue sends the keys above each k-th key from the
//     stage, slots claimed by one prefix over the block, with the header's
//     range taken two 16-bit keys at a time. It runs at #3's rate on the
//     same shard. f32 shards of 49,153-53,248 columns take a kernel of 13
//     chunks a thread at 1024 threads, loading straight from global memory.
//   * combine gives a row to one warp, so no block-wide barrier runs a row:
//     the warp copies its row's P · (c_main + k_aux) gathered keys into its
//     own shared memory and finds each k-th key a bit at a time from the top
//     (a binary radix select: the largest t with count(key >= t) >= k, the
//     counts summed over the lanes, four keys a 16-byte load; f32 dead keys
//     are cut in place to those sharing the k-th key's top 16 bits once
//     those are known), then streams the shard's row in 16-byte loads, four
//     in flight a lane, testing keys against the fired key held in a
//     register. The CTA's fired bits stay in shared memory and are ORed
//     into the global mask once, at its end. Knock-out copies on the card
//     (PERF.md §6) put what is left in the stream at P = 2 and in the
//     selection at P = 4 (2,560 dead keys a row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_select.cuh"

namespace shard {

constexpr int kWarps = 8;       // the combine's warps a CTA at most, one row each
constexpr int kUnroll = 4;      // the fired test's 16-byte loads in flight a lane
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr size_t kRoom = topk::kBlockSmem;  // the combine's dynamic shared memory

// Element j of row `row` of an (m, n) matrix of Row's raw elements, as a key.
template <class Row>
__device__ __forceinline__ uint32_t load_key(const void* acts, size_t row, int n, int j) {
  if constexpr (Row::kBits == 16)
    return Row::key(static_cast<const uint16_t*>(acts)[row * n + j]);
  else
    return Row::key(static_cast<const uint32_t*>(acts)[row * n + j]);
}

// Keeps the warp's keys[0..count) whose top 16 bits are t's, in place and
// zero-padded to whole 16-byte pieces; k drops by the keys above them. →
// how many were kept.
__device__ int warp_keep(uint32_t* keys, int count, uint32_t t, uint32_t& k) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u, top = t >> 16;
  int kept = 0;
  uint32_t above = 0u;
  for (int j0 = 0; j0 < count; j0 += 32) {  // a write never passes an unread key
    const int j = j0 + lane;
    const uint32_t key = j < count ? keys[j] : 0u;
    __syncwarp();
    const bool keep = j < count && (key >> 16) == top;
    above += j < count && (key >> 16) > top;
    const uint32_t b = __ballot_sync(kFull, keep);
    if (keep) keys[kept + __popc(b & below)] = key;
    kept += __popc(b);
  }
  k -= __reduce_add_sync(kFull, above);
  __syncwarp();
  if (lane < 3 && kept + lane < ((kept + 3) & ~3)) keys[kept + lane] = 0u;
  __syncwarp();
  return kept;
}

// The k-th largest of the warp's keys[0..count) (count >= k >= 1; 16-byte
// aligned, zero-padded to whole pieces of 4): the largest t with
// count(keys >= t) >= k, decided a bit at a time from the top. A zero key
// never counts (every t tested is >= 1). With `keep`, 32-bit keys are cut
// in place to those that share t's top 16 bits once those are decided, so
// the last 16 steps read few keys. Every lane returns it.
template <int Bits>
__device__ uint32_t warp_kth(uint32_t* keys, int count, uint32_t k, bool keep) {
  const int lane = threadIdx.x & 31;
  const uint4* q = reinterpret_cast<const uint4*>(keys);
  int n4 = (count + 3) >> 2;
  uint32_t t = 0u;
#pragma unroll 1
  for (int b = Bits - 1; b >= 0; --b) {
    if (Bits == 32 && keep && b == 15) n4 = (warp_keep(keys, count, t, k) + 3) >> 2;
    const uint32_t c = t | (1u << b);
    uint32_t above = 0u;
    for (int j = lane; j < n4; j += 32) {
      const uint4 v = q[j];
      above += (v.x >= c) + (v.y >= c) + (v.z >= c) + (v.w >= c);
    }
    if (__reduce_add_sync(kFull, above) >= k) t = c;
  }
  return t;
}

// The smallest of the warp's keys[0..count).
__device__ __forceinline__ uint32_t warp_min(const uint32_t* keys, int count) {
  uint32_t v = kNone;
  for (int j = threadIdx.x & 31; j < count; j += 32) v = min(v, keys[j]);
  return __reduce_min_sync(kFull, v);
}

// The bits of a 16-byte chunk's keys (8 bf16 or 4 f32 elements) >= fk.
template <class Row>
__device__ __forceinline__ uint32_t chunk_bits(uint4 v, uint32_t fk) {
  const uint32_t w[4] = {Row::word(v.x), Row::word(v.y), Row::word(v.z), Row::word(v.w)};
  uint32_t bits = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (Row::kBits == 16) {
      bits |= static_cast<uint32_t>((w[i] & 0xFFFFu) >= fk) << (2 * i);
      bits |= static_cast<uint32_t>((w[i] >> 16) >= fk) << (2 * i + 1);
    } else {
      bits |= static_cast<uint32_t>(w[i] >= fk) << i;
    }
  }
  return bits;
}

// ------------------------------------------------------------ candidates

template <class Row>
int candidates(const void* acts, const uint32_t* dead_bits, int m, int n, int k_sel, int k_aux,
               uint32_t* out, int width, cudaStream_t s) {
  topk::SelectParams p{};
  p.acts = acts;
  p.dead = dead_bits;
  p.k[0] = static_cast<uint32_t>(k_sel);
  p.k[1] = static_cast<uint32_t>(k_aux);
  p.m = m;
  p.n = n;
  p.nsel = 2;
  p.out = out;
  p.width = width;
  return topk::launch_select<Row, true>(p, s);
}

// the widest shard a candidates launch takes, for every kind (f32's limit)
constexpr int max_local() { return topk::max_n<topk::F32Value, true>(); }

// -------------------------------------------------------------- combine

template <class Row>
__global__ void __launch_bounds__(kWarps * 32, 4)
combine_kernel(const uint32_t* __restrict__ g, int p, int m, int width, int c_main, int k_aux,
               const void* __restrict__ acts, int n_local, int n_dict, uint32_t k_main,
               uint32_t k_multi, int iters, float* t_main, float* t_aux, float* t_multi,
               uint32_t* fired) {
  extern __shared__ __align__(16) uint32_t dyn[];
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwords = (n_local + 31) >> 5;
  const int n_main = p * c_main;
  const int main4 = (n_main + 3) & ~3, aux4 = (p * k_aux + 3) & ~3;  // in whole 16-byte pieces
  uint32_t* cm = dyn + warp * (main4 + aux4);  // every shard's top keys
  uint32_t* ca = cm + main4;                   // the shards' dead keys, packed
  uint32_t* fmask = dyn + warps * (main4 + aux4);
  for (int w = tid; w < nwords; w += blockDim.x) fmask[w] = 0u;
  __syncthreads();
  const size_t row_bytes = static_cast<size_t>(n_local) * Row::kElem;
  const bool vec = reinterpret_cast<uintptr_t>(acts) % 16 == 0 && row_bytes % 16 == 0;
  const int chunks = static_cast<int>(row_bytes / 16);
  const uint32_t un = static_cast<uint32_t>(n_dict);
  const uint32_t ks[topk::kMaxSel] = {k_main, static_cast<uint32_t>(k_aux), k_multi};
  float* const t_out[topk::kMaxSel] = {t_main, t_aux, t_multi};
  const int nsel = k_multi > 0u ? 3 : 2;

  for (int row = blockIdx.x * warps + warp; row < m; row += gridDim.x * warps) {
    // the headers: global range and dead count; each shard's dead keys
    // packed after the last one's
    uint32_t lo_a = kNone, hi_a = 0u, lo_d = kNone, hi_d = 0u, dead_total = 0u;
    int n_aux = 0;
    for (int s0 = 0; s0 < p; s0 += 32) {
      const int s = s0 + lane;
      uint32_t a_s = 0u;
      if (s < p) {
        const uint32_t* h = g + (static_cast<size_t>(s) * m + row) * width + c_main + k_aux;
        lo_a = min(lo_a, h[0]);
        hi_a = max(hi_a, h[1]);
        lo_d = min(lo_d, h[2]);
        hi_d = max(hi_d, h[3]);
        dead_total += h[4];
        a_s = min(h[4], static_cast<uint32_t>(k_aux));
      }
      uint32_t incl = a_s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      const uint32_t at = n_aux + incl - a_s;
      for (int i = 0; i < min(32, p - s0); ++i) {
        const uint32_t a_i = __shfl_sync(kFull, a_s, i), at_i = __shfl_sync(kFull, at, i);
        const uint32_t* src = g + (static_cast<size_t>(s0 + i) * m + row) * width + c_main;
        for (uint32_t j = lane; j < a_i; j += 32) ca[at_i + j] = src[j];
      }
      n_aux += static_cast<int>(__shfl_sync(kFull, incl, 31));
    }
    for (int s = 0; s < p; ++s) {
      const uint32_t* src = g + (static_cast<size_t>(s) * m + row) * width;
      for (int j = lane; j < c_main; j += 32) cm[s * c_main + j] = src[j];
    }
    if (lane < 3) {  // zeros up to whole pieces
      if (n_main + lane < main4) cm[n_main + lane] = 0u;
      if (n_aux + lane < ((n_aux + 3) & ~3)) ca[n_aux + lane] = 0u;
    }
    lo_a = __reduce_min_sync(kFull, lo_a);
    hi_a = __reduce_max_sync(kFull, hi_a);
    lo_d = __reduce_min_sync(kFull, lo_d);
    hi_d = __reduce_max_sync(kFull, hi_d);
    dead_total = __reduce_add_sync(kFull, dead_total);
    __syncwarp();

    // the k-th keys, where the whole row holds k candidates; the dead keys
    // last, as the f32 select cuts them in place (the exact path's
    // smallest-candidate rule reads them only when they are not selected)
    const uint32_t cand[topk::kMaxSel] = {un, dead_total, un};
    uint32_t kth[topk::kMaxSel];
    bool sel[topk::kMaxSel];
#pragma unroll
    for (int i = 0; i < topk::kMaxSel; ++i) sel[i] = i < nsel && ks[i] > 0u && cand[i] >= ks[i];
    kth[0] = sel[0] ? warp_kth<Row::kBits>(cm, n_main, ks[0], false) : 0u;
    kth[2] = sel[2] ? warp_kth<Row::kBits>(cm, n_main, ks[2], false) : 0u;
    kth[1] = sel[1] ? warp_kth<Row::kBits>(ca, n_aux, ks[1], true) : 0u;
    uint32_t fk;
    if constexpr (Row::kFloat) {
      float tmain = 0.f;
#pragma unroll
      for (int i = 0; i < topk::kMaxSel; ++i) {
        if (i >= nsel) continue;
        float vk;  // the k-th largest entry of the (masked) row
        if (sel[i])
          vk = Row::value(kth[i]);
        else if (i == topk::kAux && ks[i] <= un)
          vk = -INFINITY;
        else
          vk = NAN;  // fewer than k entries: count >= k never holds
        const uint32_t lo_key = i == topk::kAux ? lo_d : lo_a;
        float lo = lo_key == kNone ? INFINITY : Row::value(lo_key);
        float hi = i == topk::kAux ? (dead_total > 0u ? Row::value(hi_d) : -INFINITY)
                                   : Row::value(hi_a);
        for (int step = 0; step < iters; ++step) {
          const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
          if (mid <= vk)
            lo = mid;
          else
            hi = mid;
        }
        if (lane == 0) t_out[i][row] = lo;
        if (i == 0) tmain = lo;
      }
      fk = max(Row::fire_key(tmain), Row::kZero + 1u);
    } else {
      uint32_t o[topk::kMaxSel];
#pragma unroll
      for (int i = 0; i < topk::kMaxSel; ++i) {
        if (i >= nsel) continue;
        if (sel[i])
          o[i] = kth[i];
        else if (cand[i] == 0u)
          o[i] = Row::kInf;
        else  // fewer than k in the whole row: the smallest candidate
          o[i] = i == topk::kAux ? warp_min(ca, n_aux) : warp_min(cm, n_main);
        if (lane == 0) t_out[i][row] = Row::value(o[i]);
      }
      fk = max(o[0], Row::kZero + 1u);  // >= t_main and positive
    }
    __syncwarp();  // the keys are the next row's

    // this shard's fired columns
    const unsigned char* base = static_cast<const unsigned char*>(acts) + row * row_bytes;
    if (vec) {
      const uint4* src = reinterpret_cast<const uint4*>(base);
      for (int c0 = lane; c0 < chunks; c0 += 32 * kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + 32 * u;
          v[u] = c < chunks ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + 32 * u;
          const uint32_t bits = c < chunks ? chunk_bits<Row>(v[u], fk) : 0u;
          if (bits) {
            const int col = c * Row::kPerChunk;
            atomicOr(&fmask[col >> 5], bits << (col & 31));
          }
        }
      }
    } else {  // a row not in whole 16-byte pieces: a warp tests 32 columns at a time
      for (int b = 0; b < n_local; b += 32) {
        const int j = b + lane;
        const bool hit = j < n_local && load_key<Row>(acts, row, n_local, j) >= fk;
        const uint32_t word = __ballot_sync(kFull, hit);
        if (lane == 0 && word) atomicOr(&fmask[b >> 5], word);
      }
    }
  }
  __syncthreads();
  for (int w = tid; w < nwords; w += blockDim.x)
    if (fmask[w]) atomicOr(&fired[w], fmask[w]);
}

template <class Row>
int combine(const uint32_t* g, int p, int m, int width, int c_main, int k_aux, const void* acts,
            int n_local, int n_dict, int k_main, int k_multi, int iters, float* t_main,
            float* t_aux, float* t_multi, uint32_t* fired, cudaStream_t s) {
  if (m == 0) return 0;
  // a warp's keys (each region in whole 16-byte pieces), and the fired
  // mask; as many warps a CTA as fit, up to 8
  const size_t keys = 4 * ((static_cast<size_t>(p) * c_main + 3) / 4 * 4 +
                           (static_cast<size_t>(p) * k_aux + 3) / 4 * 4);
  const size_t mask = 4 * static_cast<size_t>((n_local + 31) / 32);
  if (keys + mask > kRoom) return static_cast<int>(cudaErrorInvalidValue);
  const size_t fit_warps = (kRoom - mask) / keys;
  const int warps = fit_warps < kWarps ? static_cast<int>(fit_warps) : kWarps;
  const size_t dyn = mask + warps * keys;
  auto kern = combine_kernel<Row>;
  int err = hopper::allow_smem(kern, dyn);
  if (err) return err;
  int per_sm = 0, sms = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps * 32, dyn));
  if (err) return err;
  err = hopper::sm_count(&sms);
  if (err) return err;
  const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long need = (m + warps - 1) / warps;
  const int grid = static_cast<int>(need < fit ? need : fit);
  kern<<<grid, warps * 32, dyn, s>>>(g, p, m, width, c_main, k_aux, acts, n_local, n_dict,
                                     static_cast<uint32_t>(k_main),
                                     static_cast<uint32_t>(k_multi), iters, t_main, t_aux,
                                     t_multi, fired);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace shard

extern "C" {

// Key kinds: 0 the exact path (bf16 bits), 1 bf16 values, 2 f32 values.

int freud_shard_max_local() { return shard::max_local(); }

// acts (m, n) row-major of the kind's element type; dead (n,) uint8;
// dead_bits: ceil(n / 32) words of scratch; out (m, width) words, width =
// min(k_sel, n) + k_aux + 5. Returns cudaError_t.
int freud_shard_candidates(const void* acts, int kind, const uint8_t* dead, uint32_t* dead_bits,
                           int m, int n, int k_sel, int k_aux, uint32_t* out, int width,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (n < 1 || n > shard::max_local()) return static_cast<int>(cudaErrorInvalidValue);
  topk::dead_bits_kernel<<<(n + topk::kBitsThreads - 1) / topk::kBitsThreads,
                           topk::kBitsThreads, 0, s>>>(dead, n, dead_bits);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (kind == 0)
    return shard::candidates<topk::Bf16Bits>(acts, dead_bits, m, n, k_sel, k_aux, out, width, s);
  if (kind == 1)
    return shard::candidates<topk::Bf16Value>(acts, dead_bits, m, n, k_sel, k_aux, out, width, s);
  return shard::candidates<topk::F32Value>(acts, dead_bits, m, n, k_sel, k_aux, out, width, s);
}

// g (p, m, width) words: every model rank's candidates; acts (m, n_local)
// this rank's shard. t_main, t_aux (m,) f32, t_multi (m,) when k_multi >
// 0; fired: ceil(n_local / 32) words, zeroed by the caller.
int freud_shard_combine(const uint32_t* g, int p, int m, int width, int c_main, int k_aux,
                        const void* acts, int kind, int n_local, int n_dict, int k_main,
                        int k_multi, int iters, float* t_main, float* t_aux, float* t_multi,
                        uint32_t* fired, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return shard::combine<topk::Bf16Bits>(g, p, m, width, c_main, k_aux, acts, n_local, n_dict,
                                          k_main, k_multi, iters, t_main, t_aux, t_multi,
                                          fired, s);
  if (kind == 1)
    return shard::combine<topk::Bf16Value>(g, p, m, width, c_main, k_aux, acts, n_local,
                                           n_dict, k_main, k_multi, iters, t_main, t_aux,
                                           t_multi, fired, s);
  return shard::combine<topk::F32Value>(g, p, m, width, c_main, k_aux, acts, n_local, n_dict,
                                        k_main, k_multi, iters, t_main, t_aux, t_multi, fired,
                                        s);
}

}  // extern "C"
