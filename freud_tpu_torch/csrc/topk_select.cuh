// Per-row selection core shared by csrc/topk_threshold.cu (kernel #3),
// csrc/topk_fused.cu (kernel #4's select launch), csrc/topk_sharded.cu
// (the candidates launch of kernel #3 across dictionary shards) and
// csrc/topk_indexed.cu (the SAE encode's top-k): for every row of an (M, n)
// matrix, up to three k-th largest keys (k[0]; k[1] among the dead
// columns; k[2]), then one of three epilogues (the kernels' kCand, kIdx):
//   * thresholds: t_main, t_aux and t_multi by the edge rules below, and
//     the fired mask, the columns where any row holds a positive value >=
//     t_main;
//   * candidates: the row's keys above each k-th key and that key's ties,
//     and the header the combine reads (emit_candidates says what);
//   * indexed (select_indexed): the row's k largest elements and their
//     columns, in the order of torch.sort on the card, stable and
//     descending (emit_indexed says how).
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
constexpr int kCandidates = 1, kIndexed = 2;  // launch_rows' epilogues (0: thresholds)

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
  // the indexed epilogue's keys (torch.sort's order on the card): the
  // order key with -0 keyed as +0; raw() inverts every other key
  __device__ static uint32_t sort_key(uint32_t bits) { return key(bits == 0x8000u ? 0u : bits); }
  __device__ static uint32_t sort_word(uint32_t w) {
    return sort_key(w & 0xFFFFu) | (sort_key(w >> 16) << 16);
  }
  __device__ static uint32_t raw(uint32_t key) {
    return (key & 0x8000u) ? (key ^ 0x8000u) : (~key & 0xFFFFu);
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
  __device__ static uint32_t sort_key(uint32_t bits) { return word(bits == 0x80000000u ? 0u : bits); }
  __device__ static uint32_t sort_word(uint32_t w) { return sort_key(w); }
  __device__ static uint32_t raw(uint32_t key) {
    return (key & 0x80000000u) ? (key ^ 0x80000000u) : ~key;
  }
};

// The encode's prologue on one f32 product z (bits): relu(z + b) as
// torch.relu(z + b) computes it on the card (one f32 add; clamp_min's NaN
// rule, then fmaxf), bit for bit.
__device__ __forceinline__ uint32_t add_relu(uint32_t z, float b) {
  const float v = __fadd_rn(__uint_as_float(z), b);
  return __float_as_uint(isnan(v) ? v : fmaxf(v, 0.f));
}

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

// The indexed epilogue's operands ride in fields the other epilogues read,
// so the struct their kernels take is what it was: t[0] the bias (the
// whole row's (parts · n,) f32, added and ReLU-ed in the load; null for
// none), t[1] the values and t[2] the columns (m, k[0]) — the input's type
// and int64 where parts == 1, else raw words and int32 columns of the
// whole row — and width the segment count: rows are `parts` column
// segments of n each of a wider row (segment = row % parts).
__host__ __device__ __forceinline__ const float* idx_bias(const SelectParams& p) { return p.t[0]; }
__host__ __device__ __forceinline__ void* idx_vals(const SelectParams& p) { return p.t[1]; }
__host__ __device__ __forceinline__ void* idx_cols(const SelectParams& p) { return p.t[2]; }
__host__ __device__ __forceinline__ int idx_parts(const SelectParams& p) { return p.width; }

inline SelectParams indexed_params(const void* acts, const float* bias, int m, int n, int k,
                                   int parts, void* vals, void* cols) {
  SelectParams p{};
  p.acts = acts;
  p.k[0] = static_cast<uint32_t>(k);
  p.m = m;
  p.n = n;
  p.nsel = 1;
  p.t[0] = const_cast<float*>(bias);
  p.t[1] = static_cast<float*>(vals);
  p.t[2] = static_cast<float*>(cols);
  p.width = parts;
  return p;
}

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

// ------------------------------------------------------------ indexed

// The element the zero key stood for (+0 or -0): read again from row
// `row` of p.acts at column col, through the prologue where there is a
// bias.
template <class Row>
__device__ __forceinline__ uint32_t raw_at(const SelectParams& p, int row, uint32_t col,
                                           uint32_t col0) {
  const size_t at = static_cast<size_t>(row) * p.n + col;
  if constexpr (Row::kBits == 16) {
    return static_cast<const uint16_t*>(p.acts)[at];
  } else {
    const uint32_t z = static_cast<const uint32_t*>(p.acts)[at];
    return idx_bias(p) ? add_relu(z, idx_bias(p)[col0 + col]) : z;
  }
}

// The indexed epilogue: row `row`'s k = k[0] largest elements, in the
// order of a stable descending sort, and their columns. kth is the exact
// k-th sort key and need the count of its ties that belong to the top k;
// k − need keys lie above it. A thread counts the keys it holds above kth
// and tied with it, a block-wide prefix over the counts gives it slots in
// pairs (keys above first, any order); where the row holds more ties than
// need, the first need of them in column order take the last slots: the
// columns of chunk i, (tid + i·NT)·kPer + e, run over i, then the thread,
// then e, so one block-wide prefix a chunk index, from the first, until
// need are placed. Then thread j < k places pair j by counting the pairs
// before it (key descending, column ascending: the columns are distinct),
// and writes its element and column there.
template <class Row, int NT, int CH>
__device__ __forceinline__ void emit_indexed(const SelectParams& p, int row,
                                             const uint32_t (&kw)[CH][4], uint32_t kth,
                                             uint32_t need, uint32_t col0, uint4* wsum,
                                             uint2* pairs) {
  constexpr int kPer = Row::kPerChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t k = p.k[0], n = static_cast<uint32_t>(p.n);
  auto col_of = [&](int i, int e) { return static_cast<uint32_t>((tid + i * NT) * kPer + e); };
  // padding is key 0, never above kth; a tie only inside the row (key 0 is
  // also a NaN's: all bits set)
  auto tie = [&](int i, int e) { return key_at<Row, CH>(kw, i, e) == kth && col_of(i, e) < n; };
  uint32_t ca = 0u, ct = 0u;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      ca += key_at<Row, CH>(kw, i, e) > kth;
      ct += tie(i, e);
    }
  }
  uint32_t oa = ca, ot = ct;  // inclusive prefix over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t va = __shfl_up_sync(kFull, oa, off), vt = __shfl_up_sync(kFull, ot, off);
    if (lane >= off) {
      oa += va;
      ot += vt;
    }
  }
  if (lane == 31) wsum[warp] = make_uint4(oa, ot, 0u, 0u);
  __syncthreads();
  oa -= ca;
  ot -= ct;
  uint32_t ties = 0u;
  for (int w = 0; w < NT / 32; ++w) {
    const uint4 v = wsum[w];
    if (w < warp) {
      oa += v.x;
      ot += v.y;
    }
    ties += v.y;
  }
  const uint32_t above = k - need;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const uint32_t key = key_at<Row, CH>(kw, i, e);
      if (key > kth) pairs[oa++] = make_uint2(key, col_of(i, e));
      if (ties == need && tie(i, e)) pairs[above + ot++] = make_uint2(key, col_of(i, e));
    }
  }
  if (ties > need) {  // the first need ties in column order
    uint32_t base = 0u;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (base >= need) break;
      uint32_t t = 0u;
#pragma unroll
      for (int e = 0; e < kPer; ++e) t += tie(i, e);
      uint32_t o = t;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_up_sync(kFull, o, off);
        if (lane >= off) o += v;
      }
      if (lane == 31) wsum[warp].z = o;
      __syncthreads();
      o += base - t;
      for (int w = 0; w < NT / 32; ++w) {
        const uint32_t z = wsum[w].z;
        if (w < warp) o += z;
        base += z;
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (!tie(i, e)) continue;
        if (o < need) pairs[above + o] = make_uint2(kth, col_of(i, e));
        ++o;
      }
      __syncthreads();  // wsum's .z is the next chunk index's
    }
  }
  __syncthreads();
  if (tid < static_cast<int>(k)) {
    const uint2 me = pairs[tid];
    uint32_t at = 0u;
    for (uint32_t j = 0; j < k; ++j) {
      const uint2 o = pairs[j];
      at += o.x > me.x || (o.x == me.x && o.y < me.y);
    }
    const uint32_t raw = me.x == Row::kZero ? raw_at<Row>(p, row, me.y, col0) : Row::raw(me.x);
    const size_t o = static_cast<size_t>(row) * k + at;
    if (idx_parts(p) == 1) {
      if constexpr (Row::kBits == 16)
        static_cast<uint16_t*>(idx_vals(p))[o] = static_cast<uint16_t>(raw);
      else
        static_cast<uint32_t*>(idx_vals(p))[o] = raw;
      static_cast<int64_t*>(idx_cols(p))[o] = me.y;
    } else {
      static_cast<uint32_t*>(idx_vals(p))[o] = raw;
      static_cast<int32_t*>(idx_cols(p))[o] = static_cast<int32_t>(col0 + me.y);
    }
  }
}

// ------------------------------------------------------------ the kernels

template <class Row, int NT, int CH, bool kCand>
__global__ void __launch_bounds__(NT, (NT == 256 ? 3 : (NT == 512 ? 2 : 1)))
select_rows(const SelectParams p) {
  constexpr bool kIdx = false;
#include "topk_select_body.cuh"
}

// one CTA an SM may take up to 65536 / NT registers a thread (on an H100,
// 512 threads at 128 registers ran fastest on 20,480 f32 columns)
template <class Row, int NT, int CH>
__global__ void __launch_bounds__(NT, 1)
select_indexed(const SelectParams p) {
  constexpr bool kCand = false, kIdx = true;
#include "topk_select_body.cuh"
}

// ------------------------------------------------------------ host side

// Launch select_rows<Row, NT, CH, kEpi == kCandidates> (select_indexed
// for kIndexed) with the ring depth that lets the most CTAs share an SM,
// and as many CTAs as then fit on the card, at most one a row (for
// kIndexed a multiple of its segment count).
template <class Row, int NT, int CH, int kEpi>
int launch_rows(SelectParams p, bool aligned, cudaStream_t stream) {
  constexpr bool kCand = kEpi == kCandidates, kIdx = kEpi == kIndexed;
  auto kern = [] {
    if constexpr (kIdx)
      return select_indexed<Row, NT, CH>;
    else
      return select_rows<Row, NT, CH, kCand>;
  }();
  cudaFuncAttributes attr;
  int err = static_cast<int>(cudaFuncGetAttributes(&attr, kern));
  if (err) return err;
  const size_t row_bytes = static_cast<size_t>(p.n) * Row::kElem;
  // the fired mask (whole 16-byte pieces), then each warp's staged keys: an
  // eighth of the keys a warp holds; for candidates at least twice the
  // warp's share of the ranks (k_aux of a narrow shard stages more), and
  // at most all it holds; for indexed rows no mask, and the k pairs after
  // the stage
  const size_t keys_per_warp = static_cast<size_t>(CH) * Row::kPerChunk * 32;
  p.seg = static_cast<int>(keys_per_warp / 8);
  if constexpr (kCand) {
    const size_t want = 2 * (static_cast<size_t>(p.k[0]) + p.k[1]) / (NT / 32) + 32;
    p.seg = static_cast<int>(want < keys_per_warp / 8 ? keys_per_warp / 8
                                                      : (want < keys_per_warp ? want : keys_per_warp));
  }
  const size_t mask_bytes =
      (kIdx ? sizeof(uint2) * p.k[0] : 4 * static_cast<size_t>(((p.n + 31) / 32 + 3) & ~3)) +
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
  long long grid = p.m < fit ? p.m : fit;
  if constexpr (kIdx) grid -= grid % idx_parts(p);  // p.m is a multiple of parts
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
