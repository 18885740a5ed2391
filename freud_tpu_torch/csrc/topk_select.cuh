// Per-row selection core shared by csrc/topk_threshold.cu (kernel #3),
// csrc/topk_fused.cu (kernel #4's select launch) and csrc/topk_sharded.cu
// (the candidates launch of kernel #3 across dictionary shards): for every
// row of an (M, n) matrix, up to three k-th largest keys (k[0]; k[1] among
// the dead columns; k[2]), then one of two epilogues (select_rows' kCand):
//   * thresholds: t_main, t_aux and t_multi by the edge rules below, and
//     the fired mask, the columns where any row holds a positive value >=
//     t_main;
//   * candidates: the row's keys above each k-th key and that key's ties,
//     and the header the combine reads (emit_candidates says what).
//
// Order keys. A value becomes an unsigned key whose order is the order the
// selection needs:
//   * Bf16Bits, the exact path: key = bits ^ 0x8000, the bf16 bits read as
//     int16 (the TPU kernels bisect those, freud_tpu/ops/topk_fused.py
//     _int_bisect_packed); for non-negative values that is value order;
//   * Bf16Value and F32Value, the float path: the IEEE order key (sign set:
//     all bits flipped; else the sign bit set), value order for every
//     non-NaN value, with -0 just below +0.
// A radix select finds the k-th largest key exactly: a histogram of the top
// 11 bits picks the bin that holds it, then histograms of the next digits
// inside that bin (5 bits for 16-bit keys; 11 and 10 for 32-bit keys). The
// passes are shared by every selection of the row. Edge rules of the exact
// path (the bisection's, topk_fused.py:85-110, 319-321, 351-354): t is the
// largest key with count(key >= t) >= k; fewer than k candidates: the
// smallest candidate; none: +inf.
//
// The float path reproduces the JAX kernel's 26-step bisection
// (freud_tpu/ops/topk_threshold.py _bisect) without a pass per step: for a
// row, count(a >= mid) >= k holds exactly when mid <= v_k, v_k the k-th
// largest entry counted with multiplicity (-inf when the masked row has
// fewer than k entries above -inf; never when it has fewer than k entries).
// So one exact select gives v_k, and the bisection replays on scalars from
// lo = the smallest finite entry and hi = the largest, bit for bit
// (ops/topk_threshold.py replay_kth models it).
//
// Design (H100): a persistent grid of a few CTAs an SM, NT threads a row,
// each CTA walking rows blockIdx.x, + gridDim.x, ... . Rows stream into a
// ring of one or two row buffers in shared memory by 1-D bulk copies that
// complete on an mbarrier, issued as soon as a buffer's row has moved into
// registers, so the next rows' reads are in flight while a row is selected.
// Each thread holds CH 16-byte chunks of the row as keys (packed pairs for
// bf16). A row of a width that is not a multiple of 16 bytes (or an
// unaligned base) loads straight from global memory into the same
// registers.
//
// What costs is the histograms' shared-memory atomics: a warp issues one
// atomic instruction per key it tests, however few of its lanes take it
// (knock-out copies on the card, PERF.md §6). So a row first stages the
// keys that can matter: those at or above cutoffs one first-digit bin below
// the last row's buckets (the dead keys' cutoff for the aux selection), a
// ballot and a shared-memory store a key, about a tenth of a row. The radix
// passes then run over the staged keys alone, a warp's lanes all busy. A
// selection whose bin falls below its cutoff, a warp whose staged keys
// overflow its segment, and a CTA's first row select from every key held,
// where the zero key (+0.0, half of a post-ReLU row) is counted apart and
// added to its bin, never by atomics. A thread owns a slice of the bins,
// reads and clears it itself, and a block-wide suffix scan finds each
// selection's bin. The fired test runs from registers; fired is a bitmask
// that each thread ORs a chunk's selected columns into, one shared word,
// and the CTA ORs into the global one once, at its end.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace topk {

constexpr uint32_t kFull = 0xffffffffu;
constexpr int kMaxSel = 3;                // t_main, t_aux, t_multi
constexpr int kAux = 1;                   // the selection among dead columns
constexpr int kDigit0 = 11;               // width of the first digit
constexpr int kBins0 = 1 << kDigit0;
constexpr int kBitsThreads = 256;         // dead_bits_kernel's block
constexpr size_t kBlockSmem = 232448;     // shared memory a block may use
constexpr uint32_t kPiece = 32768;        // bytes a bulk copy

// The dead mask (n,) bytes → bits (ceil(n / 32) words), bit j % 32 of word
// j / 32 set for a dead column j.
__global__ void __launch_bounds__(kBitsThreads)
dead_bits_kernel(const uint8_t* __restrict__ dead_g, int n, uint32_t* __restrict__ bits) {
  const int j = blockIdx.x * kBitsThreads + threadIdx.x;
  const uint32_t word = __ballot_sync(kFull, j < n && dead_g[j] != 0);
  if ((threadIdx.x & 31) == 0 && j < n) bits[j >> 5] = word;
}

// ------------------------------------------------------------ order keys
// word(): a 32-bit word of raw elements → the same word of keys; key(): one
// raw element → its key; value(): a key → the f32 value it stands for.

struct Bf16Bits {
  static constexpr int kBits = 16, kPerChunk = 8, kElem = 2;
  static constexpr bool kFloat = false;
  static constexpr uint32_t kZero = 0x8000u;      // +0.0
  static constexpr uint32_t kInf = 0xFF80u;       // +inf: selects nothing
  static constexpr uint32_t kNegInf = 0u;         // finite: 0 < key < 2^16
  static constexpr uint32_t kPosInf = 0x10000u;
  __device__ static uint32_t word(uint32_t w) { return w ^ 0x80008000u; }
  __device__ static uint32_t key(uint32_t bits) { return (bits ^ 0x8000u) & 0xFFFFu; }
  __device__ static float value(uint32_t key) {
    return __uint_as_float(((key ^ 0x8000u) & 0xFFFFu) << 16);
  }
  __device__ static uint32_t fire_key(float) { return 0u; }  // exact path: unused
};

struct Bf16Value {
  static constexpr int kBits = 16, kPerChunk = 8, kElem = 2;
  static constexpr bool kFloat = true;
  static constexpr uint32_t kZero = 0x8000u;
  static constexpr uint32_t kInf = 0xFF80u;
  static constexpr uint32_t kNegInf = 0x007Fu;
  static constexpr uint32_t kPosInf = 0xFF80u;
  __device__ static uint32_t word(uint32_t w) {
    const uint32_t neg = ((w >> 15) & 0x00010001u) * 0xFFFFu;  // halves with the sign set
    return w ^ (neg | 0x80008000u);
  }
  __device__ static uint32_t key(uint32_t bits) { return word(bits & 0xFFFFu) & 0xFFFFu; }
  __device__ static float value(uint32_t key) {
    const uint32_t bits = (key & 0x8000u) ? (key ^ 0x8000u) : (~key & 0xFFFFu);
    return __uint_as_float(bits << 16);
  }
  // the smallest key whose value is >= t: a bf16 b is >= t exactly when it
  // is >= t rounded up to bf16
  __device__ static uint32_t fire_key(float t) {
    return key(__bfloat16_as_ushort(__float2bfloat16_ru(t)));
  }
};

struct F32Value {
  static constexpr int kBits = 32, kPerChunk = 4, kElem = 4;
  static constexpr bool kFloat = true;
  static constexpr uint32_t kZero = 0x80000000u;
  static constexpr uint32_t kInf = 0xFF800000u;
  static constexpr uint32_t kNegInf = 0x007FFFFFu;
  static constexpr uint32_t kPosInf = 0xFF800000u;
  __device__ static uint32_t word(uint32_t w) {
    return w ^ (static_cast<uint32_t>(static_cast<int32_t>(w) >> 31) | 0x80000000u);
  }
  __device__ static uint32_t key(uint32_t bits) { return word(bits); }
  __device__ static float value(uint32_t key) {
    return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
  }
  __device__ static uint32_t fire_key(float t) { return key(__float_as_uint(t)); }
};

// Digit p of a kBits-bit key: `width` bits above `shift`.
template <int Bits>
__host__ __device__ constexpr int digit_shift(int p) {
  return Bits == 16 ? (p == 0 ? 5 : 0) : (p == 0 ? 21 : (p == 1 ? 10 : 0));
}
template <int Bits>
__host__ __device__ constexpr int digit_width(int p) {
  return Bits == 16 ? (p == 0 ? 11 : 5) : (p == 2 ? 10 : 11);
}

// ------------------------------------------------------------ launch data

struct SelectParams {
  const void* acts;      // (m, n) row-major, Row's element type
  const uint32_t* dead;  // ceil(n / 32) words of dead bits
  uint32_t* fired;       // ceil(n / 32) words, OR-ed; zeroed by the caller
  float* t[kMaxSel];     // (m,) each, f32
  uint32_t k[kMaxSel];   // ranks, >= 1 for the first nsel
  int m, n, nsel, iters; // iters: the float path's bisection steps
  int slots;             // ring buffers; 0: rows load straight from global
  int seg;               // staged keys a warp holds at most (the launcher sets it)
  uint32_t* out;         // the candidates epilogue's rows: (m, width) words
  int width;
};

template <class Row, int NT>
struct Smem {
  static constexpr int kWarps = NT / 32;
  static constexpr int kLaterBins = Row::kBits == 16 ? 32 : kBins0;
  uint32_t h[2][kBins0];                 // first digit: live keys, dead keys
  uint32_t g[kMaxSel][kLaterBins];       // later digits, a histogram a selection
  uint4 counts[kWarps];                  // zero key all, dead; key 0 all, dead
  uint32_t staged[kWarps];               // keys a warp staged, or kNone when they overflowed
  uint4 range[kWarps];                   // min finite, max: all; dead
  uint4 wsum[kWarps];                    // warp totals of a scan, one a selection
  uint32_t pick[kMaxSel][2];             // the bin found, the count above it
  uint64_t full[2];                      // ring buffers filled
};

// Suffix sum over the lanes of a warp: the sum of v over lanes >= lane.
__device__ __forceinline__ uint32_t warp_suffix(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += o;
  }
  return v;
}

// This thread's kPer bins of a histogram (bins tid·kPer …), read into v and
// cleared for the next use, in 16-byte pieces where they allow it. Only the
// owner reads or clears a bin, so no barrier is needed between the two.
template <int kPer>
__device__ __forceinline__ void take_bins(uint32_t* hist, uint32_t (&v)[kPer]) {
  uint32_t* own = hist + threadIdx.x * kPer;
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kPer; j += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(own + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
      *reinterpret_cast<uint4*>(own + j) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = own[j];
      own[j] = 0u;
    }
  }
}

// For each selection i < nsel with radix[i], from count(i, b), its count
// in this thread's bin tid·kPer + b: the largest bin with count(bins >= it)
// >= k[i], and that count of bins above it, into pick[i] (a block-wide
// suffix scan). Two barriers; pick is readable after the second.
template <int NT, int kPer, class Count>
__device__ __forceinline__ void pick_bins(int nsel, const bool (&radix)[kMaxSel],
                                          const uint32_t (&k)[kMaxSel], Count count,
                                          uint4* wsum, uint32_t (*pick)[2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t own[kMaxSel], above[kMaxSel];
#pragma unroll
  for (int i = 0; i < kMaxSel; ++i) {
    own[i] = 0u;
    if (i < nsel && radix[i]) {
#pragma unroll
      for (int b = 0; b < kPer; ++b) own[i] += count(i, b);
    }
    above[i] = warp_suffix(own[i]);
  }
  if (lane == 0) wsum[warp] = make_uint4(above[0], above[1], above[2], 0u);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxSel; ++i) above[i] -= own[i];
  for (int w = warp + 1; w < NT / 32; ++w) {
    const uint4 v = wsum[w];
    above[0] += v.x;
    above[1] += v.y;
    above[2] += v.z;
  }
#pragma unroll
  for (int i = 0; i < kMaxSel; ++i) {
    if (i < nsel && radix[i] && above[i] < k[i] && above[i] + own[i] >= k[i]) {
      uint32_t a = above[i];
#pragma unroll
      for (int b = kPer - 1; b >= 0; --b) {
        const uint32_t c = count(i, b);
        if (a + c >= k[i]) {
          pick[i][0] = tid * kPer + b;
          pick[i][1] = a;
          break;
        }
        a += c;
      }
    }
  }
  __syncthreads();
}

// The same over 32 bins, by warp i for selection i (lane = bin); the
// caller's barrier makes pick readable.
template <class Count>
__device__ __forceinline__ void find_warp(int i, uint32_t k, Count count, uint32_t (*pick)[2]) {
  const int lane = threadIdx.x & 31;
  const uint32_t own = count(i, lane);
  const uint32_t suffix = warp_suffix(own);
  if (suffix >= k && suffix - own < k) {
    pick[i][0] = lane;
    pick[i][1] = suffix - own;
  }
}

// The key of element e of chunk i: packed pairs for 16-bit keys.
template <class Row, int CH>
__device__ __forceinline__ uint32_t key_at(const uint32_t (&kw)[CH][4], int i, int e) {
  if constexpr (Row::kBits == 16)
    return (kw[i][e >> 1] >> (16 * (e & 1))) & 0xFFFFu;
  else
    return kw[i][e];
}

// A staged key: 16-bit keys with the dead flag above them in one word,
// 32-bit keys beside it.
template <class Row>
struct Staged {
  using Entry = typename std::conditional<Row::kBits == 16, uint32_t, uint2>::type;
  __device__ static Entry make(uint32_t key, uint32_t dead) {
    if constexpr (Row::kBits == 16)
      return key | (dead << 16);
    else
      return make_uint2(key, dead);
  }
  __device__ static uint32_t key(Entry e) {
    if constexpr (Row::kBits == 16)
      return e & 0xFFFFu;
    else
      return e.x;
  }
  __device__ static uint32_t dead(Entry e) {
    if constexpr (Row::kBits == 16)
      return e >> 16;
    else
      return e.y;
  }
};

// Calls f(key, dead) for each key of the row this thread holds.
template <class Row, int NT, int CH, class F>
__device__ __forceinline__ void each_held_key(const uint32_t (&kw)[CH][4], const uint32_t (&dm)[CH],
                                              int chunks, F f) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (tid + i * NT >= chunks) continue;  // whole chunks of padding
#pragma unroll
    for (int e = 0; e < Row::kPerChunk; ++e) f(key_at<Row, CH>(kw, i, e), (dm[i] >> e) & 1u);
  }
}

// Calls f(key, dead) for each key this warp staged (count of them).
template <class Row, class F>
__device__ __forceinline__ void each_staged_key(const typename Staged<Row>::Entry* seg,
                                                uint32_t count, F f) {
  for (uint32_t j = threadIdx.x & 31; j < count; j += 32) {
    const auto e = seg[j];
    f(Staged<Row>::key(e), Staged<Row>::dead(e));
  }
}

// Copies the keys this thread holds that are at least the cutoff (cut_dead
// for dead columns, cut_live for the others) into the warp's segment of seg
// entries, in order of arrival; → how many, or kNone when they did not fit.
// Every lane of the warp calls it.
template <class Row, int NT, int CH>
__device__ __forceinline__ uint32_t stage_keys(const uint32_t (&kw)[CH][4],
                                               const uint32_t (&dm)[CH], uint32_t cut_live,
                                               uint32_t cut_dead,
                                               typename Staged<Row>::Entry* seg, uint32_t cap) {
  const uint32_t below = (1u << (threadIdx.x & 31)) - 1u;
  uint32_t count = 0u;
  bool fits = true;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
#pragma unroll
    for (int e = 0; e < Row::kPerChunk; ++e) {
      const uint32_t key = key_at<Row, CH>(kw, i, e);  // padding is key 0: never taken
      const uint32_t dead = (dm[i] >> e) & 1u;
      const bool take = key >= (dead ? cut_dead : cut_live);
      const uint32_t ballot = __ballot_sync(kFull, take);
      fits = fits && count + __popc(ballot) <= cap;
      if (take && fits) seg[count + __popc(ballot & below)] = Staged<Row>::make(key, dead);
      count += __popc(ballot);
    }
  }
  return fits ? count : 0xFFFFFFFFu;
}

// A later digit (width wd above shift sh) of the keys whose higher digits
// are selection q's prefix match[q] (the aux selection's among dead columns
// only) into g[q·kStride + digit], for each key f is given. The zero key is
// left out when kZeros (its count is added to its bin instead).
template <class Row, int kStride, bool kZeros>
struct LaterDigit {
  uint32_t m0, m1, m2;  // the prefixes of t_main, t_aux, t_multi
  int sh, wd;
  uint32_t* g;
  __device__ __forceinline__ void operator()(uint32_t key, uint32_t dead) const {
    if (kZeros && key == Row::kZero) return;
    const uint32_t top = key >> (sh + wd);
    const uint32_t bin = (key >> sh) & ((1u << wd) - 1u);
    if (top == m0) atomicAdd(&g[bin], 1u);
    if (top == m1 && dead) atomicAdd(&g[kStride + bin], 1u);
    if (top == m2) atomicAdd(&g[2 * kStride + bin], 1u);
  }
};

// For the edge rules: the count of key 0 (all, dead) into cnt.z, cnt.w, and
// the smallest finite and the largest key, of all columns and of the dead
// ones, into rng.
template <class Row, int NT, int CH>
__device__ __forceinline__ void key_range(const uint32_t (&kw)[CH][4], const uint32_t (&dm)[CH],
                                          int chunks, uint4& cnt, uint4& rng) {
  each_held_key<Row, NT, CH>(kw, dm, chunks, [&](uint32_t key, uint32_t dead) {
    const uint32_t bottom = key == 0u;
    cnt.z += bottom;
    cnt.w += bottom & dead;
    const uint32_t km = (key > Row::kNegInf && key < Row::kPosInf) ? key : 0xFFFFFFFFu;
    rng.x = min(rng.x, km);
    rng.y = max(rng.y, key);
    if (dead) {
      rng.z = min(rng.z, km);
      rng.w = max(rng.w, key);
    }
  });
}

// key_range's smallest finite and largest keys (rng) for 16-bit keys, two
// at a time in packed pairs (the candidates epilogue's header, which needs
// no count of key 0). Padding is key 0, never finite and never dead.
template <class Row, int CH>
__device__ __forceinline__ void packed_range(const uint32_t (&kw)[CH][4],
                                             const uint32_t (&dm)[CH], uint4& rng) {
  constexpr uint32_t kLo = Row::kNegInf * 0x10001u;
  uint32_t lo = 0xFFFFFFFFu, hi = 0u, lo_d = 0xFFFFFFFFu, hi_d = 0u, fin = 0u, fin_d = 0u;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = kw[i][j];
      uint32_t f = __vcmpgtu2(w, kLo);  // 0xFFFF in each finite half
      if constexpr (Row::kPosInf <= 0xFFFFu) f &= __vcmpltu2(w, Row::kPosInf * 0x10001u);
      const uint32_t b = (dm[i] >> (2 * j)) & 3u;
      const uint32_t d = (b & 1u) * 0xFFFFu | (b >> 1) * 0xFFFF0000u;  // dead halves
      const uint32_t km = w | ~f;  // a key that is not finite counts as the largest
      lo = __vminu2(lo, km);
      hi = __vmaxu2(hi, w);
      lo_d = __vminu2(lo_d, km | ~d);
      hi_d = __vmaxu2(hi_d, w & d);
      fin |= f;
      fin_d |= f & d;
    }
  }
  rng.x = fin ? min(lo & 0xFFFFu, lo >> 16) : 0xFFFFFFFFu;
  rng.y = max(hi & 0xFFFFu, hi >> 16);
  rng.z = fin_d ? min(lo_d & 0xFFFFu, lo_d >> 16) : 0xFFFFFFFFu;
  rng.w = max(hi_d & 0xFFFFu, hi_d >> 16);
}

// ------------------------------------------------------------ candidates

// emit_candidates from the keys a thread holds: a thread counts the keys
// it sends, a block-wide prefix over the counts gives it its slots.
template <class Row, int NT, int CH>
__device__ __forceinline__ void emit_held(const SelectParams& p, uint32_t* o, uint32_t* aux,
                                          const uint32_t (&kw)[CH][4],
                                          const uint32_t (&dm)[CH], int chunks,
                                          const bool (&radix)[kMaxSel],
                                          const uint32_t (&prefix)[kMaxSel], uint4* wsum) {
  constexpr int kPer = Row::kPerChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t n = static_cast<uint32_t>(p.n);
  // where element e of chunk i goes: bit 0 the main region, bit 1 the aux one
  auto place = [&](int i, int e) -> uint32_t {
    const int c = tid + i * NT;
    if (c >= chunks || static_cast<uint32_t>(c * kPer + e) >= n) return 0u;  // padding
    const uint32_t key = key_at<Row, CH>(kw, i, e);
    const uint32_t dead = (dm[i] >> e) & 1u;
    return static_cast<uint32_t>(!radix[0] || key > prefix[0]) |
           (static_cast<uint32_t>(dead && (!radix[kAux] || key > prefix[kAux])) << 1);
  };
  uint32_t cm = 0u, ca = 0u;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const uint32_t w = place(i, e);
      cm += w & 1u;
      ca += w >> 1;
    }
  }
  uint32_t om = cm, oa = ca;  // inclusive prefix over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t vm = __shfl_up_sync(kFull, om, off), va = __shfl_up_sync(kFull, oa, off);
    if (lane >= off) {
      om += vm;
      oa += va;
    }
  }
  if (lane == 31) wsum[warp] = make_uint4(om, oa, 0u, 0u);
  __syncthreads();
  om -= cm;
  oa -= ca;
  for (int w = 0; w < warp; ++w) {
    const uint4 v = wsum[w];
    om += v.x;
    oa += v.y;
  }
#pragma unroll
  for (int i = 0; i < CH; ++i) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const uint32_t w = place(i, e);
      if (w & 1u) o[om++] = key_at<Row, CH>(kw, i, e);
      if (w & 2u) aux[oa++] = key_at<Row, CH>(kw, i, e);
    }
  }
}

// The candidates epilogue: row `row` of p.out (p.width words) becomes
//     [c_main keys | k[1] keys | lo_all, hi_all, lo_dead, hi_dead, d_s]
// with c_main = min(k[0], n): each region holds the keys above its
// selection's k-th key (every key, or every dead key, where the row holds
// fewer than k), then that key's ties until the region is full; the aux
// region past d_s (the dead count) is padding (0); the header is the
// smallest finite and the largest key, of all columns and of the dead
// ones. The k-th key is the exact one the radix select found (prefix),
// never the float path's replayed threshold, which may lie below it. Each
// warp counts the keys it sends, a block-wide prefix over the counts gives
// each its slots (one barrier, no atomics), and it writes them, a ballot
// placing a lane's key; the order within a region is the warps', not the
// columns'. A row selected from its staged keys sends from those (every key
// above a k-th key is staged, and every dead key where the row holds fewer
// than k[1]), others from the keys held in registers.
template <class Row, int NT, int CH>
__device__ __forceinline__ void emit_candidates(
    const SelectParams& p, int row, const uint32_t (&kw)[CH][4], const uint32_t (&dm)[CH],
    int chunks, const bool (&radix)[kMaxSel], const uint32_t (&prefix)[kMaxSel],
    const uint32_t (&need)[kMaxSel], uint4 rng, uint32_t n_dead, bool from_stage,
    const typename Staged<Row>::Entry* seg, uint32_t staged, uint4* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t n = static_cast<uint32_t>(p.n);
  const uint32_t c_main = min(p.k[0], n), k_aux = p.k[kAux];
  uint32_t* const o = p.out + static_cast<size_t>(row) * p.width;
  uint32_t* const aux = o + c_main;
  if (from_stage && radix[0]) {
    uint32_t cm = 0u, ca = 0u;
    each_staged_key<Row>(seg, staged, [&](uint32_t key, uint32_t dead) {
      cm += key > prefix[0];
      ca += dead && (!radix[kAux] || key > prefix[kAux]);
    });
    cm = __reduce_add_sync(kFull, cm);
    ca = __reduce_add_sync(kFull, ca);
    if (lane == 0) wsum[warp] = make_uint4(cm, ca, 0u, 0u);
    __syncthreads();
    uint32_t om = 0u, oa = 0u;
    for (int w = 0; w < warp; ++w) {
      const uint4 v = wsum[w];
      om += v.x;
      oa += v.y;
    }
    const uint32_t below = (1u << lane) - 1u;
    for (uint32_t j0 = 0; j0 < staged; j0 += 32) {
      bool tm = false, ta = false;
      uint32_t key = 0u;
      if (j0 + lane < staged) {
        const auto e = seg[j0 + lane];
        key = Staged<Row>::key(e);
        tm = key > prefix[0];
        ta = Staged<Row>::dead(e) && (!radix[kAux] || key > prefix[kAux]);
      }
      const uint32_t bm = __ballot_sync(kFull, tm), ba = __ballot_sync(kFull, ta);
      if (tm) o[om + __popc(bm & below)] = key;
      if (ta) aux[oa + __popc(ba & below)] = key;
      om += __popc(bm);
      oa += __popc(ba);
    }
  } else {
    emit_held<Row, NT, CH>(p, o, aux, kw, dm, chunks, radix, prefix, wsum);
  }
  // the k-th keys' ties fill what is left of each region
  if (radix[0])
    for (uint32_t t = c_main - need[0] + tid; t < c_main; t += NT) o[t] = prefix[0];
  if (radix[kAux])
    for (uint32_t t = k_aux - need[kAux] + tid; t < k_aux; t += NT) aux[t] = prefix[kAux];
  else
    for (uint32_t t = n_dead + tid; t < k_aux; t += NT) aux[t] = 0u;
  if (tid < 5)
    o[c_main + k_aux + tid] =
        tid == 0 ? rng.x : (tid == 1 ? rng.y : (tid == 2 ? rng.z : (tid == 3 ? rng.w : n_dead)));
}

// ------------------------------------------------------------ the kernel

template <class Row, int NT, int CH, bool kCand>
__global__ void __launch_bounds__(NT, (NT == 256 ? 3 : (NT == 512 ? 2 : 1)))
select_rows(const SelectParams p) {
  using S = Smem<Row, NT>;
  using Entry = typename Staged<Row>::Entry;
  constexpr int kWarps = NT / 32;
  constexpr int kPer = Row::kPerChunk;
  constexpr uint32_t kChunkMask = (1u << kPer) - 1u;
  constexpr int kPasses = Row::kBits == 16 ? 2 : 3;
  constexpr int kShift0 = digit_shift<Row::kBits>(0);
  constexpr uint32_t kZeroBin = Row::kZero >> kShift0;
  constexpr uint32_t kNone = 0xFFFFFFFFu;
  constexpr int kPer0 = kBins0 / NT;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(16) S s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n;
  const int chunks = (n + kPer - 1) / kPer;
  const uint32_t row_bytes = static_cast<uint32_t>(n) * Row::kElem;
  const int nwords = (n + 31) >> 5;
  uint32_t* fmask = reinterpret_cast<uint32_t*>(dyn + static_cast<size_t>(p.slots) * row_bytes);
  Entry* seg = reinterpret_cast<Entry*>(fmask + ((nwords + 3) & ~3)) + warp * p.seg;

  // the dead bits of this thread's chunks, kept for every row
  uint32_t dm[CH];
  uint32_t nd = 0;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = tid + i * NT;
    dm[i] = c < chunks ? (p.dead[(c * kPer) >> 5] >> ((c * kPer) & 31)) & kChunkMask : 0u;
    nd += __popc(dm[i]);
  }
  for (int b = tid; b < 2 * kBins0; b += NT) (&s.h[0][0])[b] = 0u;
  for (int b = tid; b < kMaxSel * S::kLaterBins; b += NT) (&s.g[0][0])[b] = 0u;
  for (int w = tid; w < nwords; w += NT) fmask[w] = 0u;
  nd = __reduce_add_sync(kFull, nd);
  if (lane == 0) s.wsum[warp].x = nd;
  if (tid == 0 && p.slots > 0) {
    for (int j = 0; j < p.slots; ++j) hopper::mbar_init(&s.full[j], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  uint32_t n_dead = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_dead += s.wsum[w].x;

  auto issue = [&](int slot, int row) {
    if (row >= p.m) return;
    unsigned char* dst = dyn + static_cast<size_t>(slot) * row_bytes;
    const unsigned char* src =
        static_cast<const unsigned char*>(p.acts) + static_cast<size_t>(row) * row_bytes;
    hopper::mbar_expect_tx(&s.full[slot], row_bytes);
    for (uint32_t off = 0; off < row_bytes; off += kPiece)
      hopper::bulk_load_1d(dst + off, src + off, min(kPiece, row_bytes - off), &s.full[slot]);
  };
  if (tid == 0)
    for (int j = 0; j < p.slots; ++j) issue(j, blockIdx.x + j * gridDim.x);

  // what every row shares: candidates, which selections radix-select, and
  // whether the exact path's edge rule needs a row's smallest key
  bool radix[kMaxSel];
  bool need_min = false;
#pragma unroll
  for (int i = 0; i < kMaxSel; ++i) {
    const uint32_t cand = i == kAux ? n_dead : static_cast<uint32_t>(n);
    radix[i] = i < p.nsel && cand >= p.k[i];
    need_min |= i < p.nsel && !radix[i] && cand > 0;
  }
  const bool need_range = kCand || Row::kFloat || need_min;
  // key 0 in the last chunk past n (rows loaded without the ring), live
  const uint32_t pads = static_cast<uint32_t>(chunks * kPer - n);
  // first-digit bins from the last row's buckets, one bin lower: a row
  // stages its keys at or above them (cut_dead for dead columns) and
  // selects from those alone when every k-th key lies there; kNone, or a
  // row whose k-th key lies lower, selects from all the keys it holds
  uint32_t cut_live = kNone, cut_dead = kNone;

  for (int it = 0, row = blockIdx.x; row < p.m; ++it, row += gridDim.x) {
    // ---- the row into registers, as keys
    uint32_t kw[CH][4];
    if (p.slots > 0) {
      const int slot = it % p.slots;
      hopper::mbar_wait(&s.full[slot], (it / p.slots) & 1);
      const uint4* src = reinterpret_cast<const uint4*>(dyn + static_cast<size_t>(slot) * row_bytes);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = tid + i * NT;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < chunks) {
          v = src[c];
          v = make_uint4(Row::word(v.x), Row::word(v.y), Row::word(v.z), Row::word(v.w));
        }
        kw[i][0] = v.x;
        kw[i][1] = v.y;
        kw[i][2] = v.z;
        kw[i][3] = v.w;
      }
    } else {
      const size_t base = static_cast<size_t>(row) * n;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = tid + i * NT;
        kw[i][0] = kw[i][1] = kw[i][2] = kw[i][3] = 0u;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int j = c * kPer + e;
          if (c < chunks && j < n) {
            if constexpr (Row::kBits == 16) {
              const uint32_t raw = static_cast<const uint16_t*>(p.acts)[base + j];
              kw[i][e >> 1] |= Row::key(raw) << (16 * (e & 1));
            } else {
              kw[i][e] = Row::key(static_cast<const uint32_t*>(p.acts)[base + j]);
            }
          }
        }
      }
    }

    // ---- stage the keys above the cutoffs; the range for the edge rules
    uint32_t staged = kNone;
    if (cut_dead != kNone)
      staged = stage_keys<Row, NT, CH>(kw, dm, cut_live << kShift0, cut_dead << kShift0, seg,
                                       p.seg);
    uint4 cnt = make_uint4(0u, 0u, 0u, 0u);
    uint4 rng = make_uint4(0xFFFFFFFFu, 0u, 0xFFFFFFFFu, 0u);
    if constexpr (kCand && Row::kBits == 16) {
      packed_range<Row, CH>(kw, dm, rng);
      rng = make_uint4(__reduce_min_sync(kFull, rng.x), __reduce_max_sync(kFull, rng.y),
                       __reduce_min_sync(kFull, rng.z), __reduce_max_sync(kFull, rng.w));
    } else if (need_range) {
      key_range<Row, NT, CH>(kw, dm, chunks, cnt, rng);
      cnt = make_uint4(0u, 0u, __reduce_add_sync(kFull, cnt.z), __reduce_add_sync(kFull, cnt.w));
      rng = make_uint4(__reduce_min_sync(kFull, rng.x), __reduce_max_sync(kFull, rng.y),
                       __reduce_min_sync(kFull, rng.z), __reduce_max_sync(kFull, rng.w));
    }
    if (lane == 0) {
      s.staged[warp] = staged;
      s.counts[warp] = cnt;
      s.range[warp] = rng;
    }
    __syncthreads();  // the row is in registers: its buffer takes the next row
    if (tid == 0 && p.slots > 0) issue(it % p.slots, row + p.slots * gridDim.x);
    bool from_stage = cut_dead != kNone;
    uint32_t bottom_all = 0u, bottom_dead = 0u;  // keys 0, padding included
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      from_stage = from_stage && s.staged[w] != kNone;
      if (need_range) {
        const uint4 c = s.counts[w], r = s.range[w];
        bottom_all += c.z;
        bottom_dead += c.w;
        rng = make_uint4(min(rng.x, r.x), max(rng.y, r.y), min(rng.z, r.z), max(rng.w, r.w));
      }
    }

    // ---- first digit: from the staged keys, else (or when a k-th key lies
    // below the cutoffs) from every key held, the zero key counted apart
    uint32_t zc[kMaxSel], prefix[kMaxSel], need[kMaxSel];
    for (int attempt = from_stage ? 0 : 1; attempt < 2; ++attempt) {
      const bool stage_pass = attempt == 0;
      uint32_t zl = 0u, zd = 0u;
      if (stage_pass) {
        each_staged_key<Row>(seg, staged, [&](uint32_t key, uint32_t dead) {
          atomicAdd(&s.h[dead][key >> kShift0], 1u);
        });
      } else {
        each_held_key<Row, NT, CH>(kw, dm, chunks, [&](uint32_t key, uint32_t dead) {
          const uint32_t zero = key == Row::kZero;
          zl += zero & (dead ^ 1u);
          zd += zero & dead;
          if (!zero) atomicAdd(&s.h[dead][key >> kShift0], 1u);
        });
        zl = __reduce_add_sync(kFull, zl);
        zd = __reduce_add_sync(kFull, zd);
        if (lane == 0) s.counts[warp] = make_uint4(zl, zd, 0u, 0u);
      }
      __syncthreads();
      if (tid == 0) {
#pragma unroll
        for (int i = 0; i < kMaxSel; ++i) s.pick[i][0] = kNone;
      }
      if (!stage_pass) {
        zl = zd = 0u;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          zl += s.counts[w].x;
          zd += s.counts[w].y;
        }
      }
      // each selection's zero keys (at kZeroBin), and the padding in bin 0
      // of live keys
      uint32_t padc[kMaxSel];
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        zc[i] = i == kAux ? zd : zl + zd;
        padc[i] = (i == kAux || stage_pass) ? 0u : pads;
      }
      uint32_t all[kPer0], dead[kPer0];
      take_bins<kPer0>(s.h[0], all);
      take_bins<kPer0>(s.h[1], dead);
#pragma unroll
      for (int b = 0; b < kPer0; ++b) all[b] += dead[b];
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) need[i] = p.k[i];
      pick_bins<NT, kPer0>(
          p.nsel, radix, need,
          [&](int i, int b) -> uint32_t {
            const int bin = tid * kPer0 + b;
            uint32_t v = i == kAux ? dead[b] : all[b];
            if (bin == static_cast<int>(kZeroBin)) v += zc[i];
            if (bin == 0) v -= padc[i];
            return v;
          },
          s.wsum, s.pick);
      bool found = true;
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        prefix[i] = s.pick[i][0];
        if (radix[i]) {
          // from the stage, a bin below a cutoff holds only some of its keys
          found = found && prefix[i] != kNone &&
                  (!stage_pass || prefix[i] >= (i == kAux ? cut_dead : cut_live));
          need[i] -= s.pick[i][1];
        }
      }
      from_stage = stage_pass && found;
      if (found) break;
    }
    {  // the next row's cutoffs
      uint32_t lo_live = kBins0;
      if (radix[0]) lo_live = min(lo_live, prefix[0]);
      if (radix[2]) lo_live = min(lo_live, prefix[2]);
      const uint32_t lo_dead = radix[kAux] ? min(lo_live, prefix[kAux]) : lo_live;
      const bool use = lo_dead < kBins0 && lo_dead > kZeroBin + 1u;  // the zero key stays out
      cut_live = use ? lo_live - 1u : kNone;
      cut_dead = use ? lo_dead - 1u : kNone;
      // candidates send every dead key where the row holds fewer than k[1]:
      // the stage keeps them all
      if constexpr (kCand)
        if (use && !radix[kAux]) cut_dead = 0u;
    }

    // ---- later digits, inside each selection's bin
#pragma unroll
    for (int pass = 1; pass < kPasses; ++pass) {
      const int sh = digit_shift<Row::kBits>(pass), wd = digit_width<Row::kBits>(pass);
      const uint32_t dmask = (1u << wd) - 1u;
      const uint32_t zero_top = Row::kZero >> (sh + wd);
      // a selection that does not radix-select matches nothing
      uint32_t match[kMaxSel];
#pragma unroll
      for (int q = 0; q < kMaxSel; ++q) match[q] = radix[q] ? prefix[q] : kNone;
      if (from_stage) {
        each_staged_key<Row>(seg, staged,
                             LaterDigit<Row, S::kLaterBins, false>{match[0], match[1], match[2], sh, wd, &s.g[0][0]});
      } else if (match[0] == zero_top || match[1] == zero_top || match[2] == zero_top) {
        each_held_key<Row, NT, CH>(kw, dm, chunks,
                                   LaterDigit<Row, S::kLaterBins, true>{match[0], match[1], match[2], sh, wd, &s.g[0][0]});
      } else {
        each_held_key<Row, NT, CH>(kw, dm, chunks,
                                   LaterDigit<Row, S::kLaterBins, false>{match[0], match[1], match[2], sh, wd, &s.g[0][0]});
      }
      __syncthreads();
      const uint32_t padl = from_stage ? 0u : pads;
      auto adjust = [&](int i, int bin) -> uint32_t {
        uint32_t c = 0u;
        if (zero_top == prefix[i] && bin == static_cast<int>((Row::kZero >> sh) & dmask))
          c += zc[i];
        if (prefix[i] == 0u && bin == 0) c -= padl * (i != kAux);
        return c;
      };
      if constexpr (Row::kBits == 16) {
#pragma unroll
        for (int q = 0; q < kMaxSel; ++q)
          if (q == warp && q < p.nsel && radix[q]) {
            find_warp(
                q, need[q],
                [&](int i, int b) -> uint32_t { return s.g[i][b] + adjust(i, b); }, s.pick);
            s.g[q][lane] = 0u;
          }
        __syncthreads();
      } else {
        constexpr int kPer1 = kBins0 / NT;
        uint32_t c[kMaxSel][kPer1];
#pragma unroll
        for (int q = 0; q < kMaxSel; ++q) take_bins<kPer1>(s.g[q], c[q]);
        pick_bins<NT, kPer1>(
            p.nsel, radix, need,
            [&](int i, int b) -> uint32_t { return c[i][b] + adjust(i, tid * kPer1 + b); },
            s.wsum, s.pick);
      }
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i)
        if (radix[i]) {
          prefix[i] = (prefix[i] << wd) | s.pick[i][0];
          need[i] -= s.pick[i][1];
        }
    }

    if constexpr (kCand) {
      emit_candidates<Row, NT, CH>(p, row, kw, dm, chunks, radix, prefix, need, rng, n_dead,
                                   from_stage, seg, staged, s.wsum);
      continue;
    }

    // ---- thresholds by the edge rules, and the fired test's key
    uint32_t fk;
    if constexpr (Row::kFloat) {
      float tmain = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        if (i >= p.nsel || (i != 0 && tid != i)) continue;
        float vk;  // the k-th largest entry of the masked row
        if (radix[i])
          vk = Row::value(prefix[i]);
        else if (i == kAux && p.k[i] <= static_cast<uint32_t>(n))
          vk = -INFINITY;
        else
          vk = NAN;  // fewer than k entries: count >= k never holds
        const uint32_t lo_key = i == kAux ? rng.z : rng.x;
        float lo = lo_key == 0xFFFFFFFFu ? INFINITY : Row::value(lo_key);
        float hi = i == kAux ? (n_dead > 0 ? Row::value(rng.w) : -INFINITY) : Row::value(rng.y);
        for (int step = 0; step < p.iters; ++step) {
          const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
          if (mid <= vk)
            lo = mid;
          else
            hi = mid;
        }
        if (tid == i) p.t[i][row] = lo;
        if (i == 0) tmain = lo;
      }
      fk = max(Row::fire_key(tmain), Row::kZero + 1u);
    } else {
      uint32_t out[kMaxSel];
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        const uint32_t cand = i == kAux ? n_dead : static_cast<uint32_t>(n);
        const uint32_t bottom = i == kAux ? bottom_dead : bottom_all - pads;  // real keys 0
        const uint32_t smallest = bottom > 0 ? 0u : (i == kAux ? rng.z : rng.x);
        out[i] = radix[i] ? prefix[i] : (cand == 0 ? Row::kInf : smallest);
      }
      if (tid < p.nsel) {
#pragma unroll
        for (int i = 0; i < kMaxSel; ++i)
          if (i == tid) p.t[i][row] = Row::value(out[i]);
      }
      fk = max(out[0], Row::kZero + 1u);  // >= t_main and positive
    }

    // ---- fired: a chunk's selected columns into one word of the mask
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      uint32_t bits = 0u;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        bits |= static_cast<uint32_t>(key_at<Row, CH>(kw, i, e) >= fk) << e;
      if (bits) {
        const int col = (tid + i * NT) * kPer;
        atomicOr(&fmask[col >> 5], bits << (col & 31));
      }
    }
  }
  if constexpr (!kCand) {
    __syncthreads();
    for (int w = tid; w < nwords; w += NT)
      if (fmask[w]) atomicOr(&p.fired[w], fmask[w]);
  }
}

// ------------------------------------------------------------ host side

// Launch select_rows<Row, NT, CH, kCand> with the ring depth that lets the
// most CTAs share an SM, and as many CTAs as then fit on the card, at most
// one a row.
template <class Row, int NT, int CH, bool kCand>
int launch_rows(SelectParams p, bool aligned, cudaStream_t stream) {
  auto kern = select_rows<Row, NT, CH, kCand>;
  cudaFuncAttributes attr;
  int err = static_cast<int>(cudaFuncGetAttributes(&attr, kern));
  if (err) return err;
  const size_t row_bytes = static_cast<size_t>(p.n) * Row::kElem;
  // the fired mask (whole 16-byte pieces), then each warp's staged keys: an
  // eighth of the keys a warp holds; for candidates at least twice the
  // warp's share of the ranks (k_aux of a narrow shard stages more), and
  // at most all it holds
  const size_t keys_per_warp = static_cast<size_t>(CH) * Row::kPerChunk * 32;
  p.seg = static_cast<int>(keys_per_warp / 8);
  if constexpr (kCand) {
    const size_t want = 2 * (static_cast<size_t>(p.k[0]) + p.k[1]) / (NT / 32) + 32;
    p.seg = static_cast<int>(want < keys_per_warp / 8 ? keys_per_warp / 8
                                                      : (want < keys_per_warp ? want : keys_per_warp));
  }
  const size_t mask_bytes = 4 * static_cast<size_t>(((p.n + 31) / 32 + 3) & ~3) +
                            sizeof(typename Staged<Row>::Entry) * p.seg * (NT / 32);
  const size_t room = kBlockSmem - attr.sharedSizeBytes;
  err = hopper::allow_smem(kern, room);
  if (err) return err;
  // the ring depth (2, else 1) that lets the most CTAs share an SM; none
  // for an unaligned row or one that does not fit
  int per_sm = 0;
  p.slots = 0;
  for (int slots = aligned ? 2 : 0; slots >= 0; --slots) {
    const size_t dyn = slots * row_bytes + mask_bytes;
    if (dyn > room || (slots == 0 && p.slots > 0)) continue;
    int fits = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, kern, NT, dyn));
    if (err) return err;
    if (fits > per_sm) {
      per_sm = fits;
      p.slots = slots;
    }
  }
  const size_t dyn = p.slots * row_bytes + mask_bytes;
  if (dyn > room) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = hopper::sm_count(&sms);
  if (err) return err;
  const long long fit = static_cast<long long>(per_sm > 1 ? per_sm : 1) * sms;
  const long long grid = p.m < fit ? p.m : fit;
  kern<<<static_cast<unsigned>(grid), NT, dyn, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The widest row a Row's kernels take: 12 chunks a thread at 1024 threads;
// 13 for f32 candidates (a row of up to 53,248 columns, which loads
// straight from global memory: it does not fit a ring buffer).
template <class Row, bool kCand = false>
constexpr int max_n() {
  return (kCand && Row::kBits == 32 ? 13 : 12) * 1024 * Row::kPerChunk;
}

// Picks the kernel for the row's width: the fewest threads a row (256, 512,
// 1024) at which a thread holds at most 6 chunks, else 12 at 1024 (13 for
// f32 candidates). kCand: the candidates epilogue, else the thresholds.
template <class Row, bool kCand = false>
int launch_select(SelectParams p, cudaStream_t stream) {
  if (p.m == 0) return 0;
  if (p.n < 1 || p.n > max_n<Row, kCand>()) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (p.n + Row::kPerChunk - 1) / Row::kPerChunk;
  const bool aligned = reinterpret_cast<uintptr_t>(p.acts) % 16 == 0 &&
                       (static_cast<size_t>(p.n) * Row::kElem) % 16 == 0;
  const int per256 = (chunks + 255) / 256, per512 = (chunks + 511) / 512,
            per1024 = (chunks + 1023) / 1024;
#define TOPK_TRY(NT_, CH_, PER_) \
  if ((PER_) <= (CH_)) return launch_rows<Row, NT_, CH_, kCand>(p, aligned, stream);
  if constexpr (!Row::kFloat) {
    TOPK_TRY(256, 1, per256)
    TOPK_TRY(256, 2, per256)
    TOPK_TRY(256, 3, per256)
  } else {
    TOPK_TRY(256, 2, per256)
  }
  TOPK_TRY(256, 4, per256)
  TOPK_TRY(256, 6, per256)
  TOPK_TRY(512, 6, per512)
  TOPK_TRY(1024, 6, per1024)
  TOPK_TRY(1024, 12, per1024)
  if constexpr (kCand && Row::kBits == 32) {
    TOPK_TRY(1024, 13, per1024)
  }
#undef TOPK_TRY
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace topk
