// TopK thresholds across dictionary shards, for Hopper (sm_90a): kernel #3's
// selection (csrc/topk_threshold.cu) when each of P model ranks holds
// n_dict / P columns of every row of the (M, n_dict) latent.
//
// Replaces the Pallas TPU kernel freud_tpu/ops/topk_threshold.py
// (topk_thresholds_fired) on a dictionary split over the mesh's model axis,
// where XLA gathers the whole latent for it. Here the latent never moves;
// two launches and one all-gather of O(M · P · (k_sel + k_aux)) keys do:
//
//   * candidates (one CTA a row of the local (M, n_s) shard): the shard's
//     top min(k_sel, n_s) order keys (k_sel = max(k, k_multi)), its top
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
//   * combine (one CTA a row): t_main, t_aux and t_multi from the gathered
//     keys with kernel #3's rules, bit for bit, and this shard's fired bits.
//     Exact path (bf16 bits): the k-th key; fewer than k candidates in the
//     whole row: the smallest; none: +inf. Float path: the 26-step
//     bisection replayed on scalars from the GLOBAL lo and hi (the headers'
//     min and max), with v_k the gathered k-th key (csrc/topk_select.cuh
//     says why that equals the bisection). Candidates alone would give a
//     different lo and hi, hence a different threshold. Every count that
//     routes a selection (n_dict, the dead count) is the global one.
//
// The keys are csrc/topk_select.cuh's order keys (Bf16Bits, Bf16Value,
// F32Value), selected by an 8-bit radix select over shared memory: 2
// passes for 16-bit keys, 4 for 32-bit ones, each a histogram of the keys
// that match the prefix so far and a warp's suffix scan of its 256 bins.
//
// What bounds it on an H100: the candidates launch reads the shard once
// (M · n_s · 2 bytes in bf16) and writes M · width words; the combine reads
// the gathered P · M · width words and the shard again for the fired bits.
// The design keeps a row in shared memory and walks it once a radix pass:
// simple, not yet tuned (PERF.md has its times beside that bound).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_select.cuh"

namespace shard {

constexpr int kNT = 256;        // threads a CTA; a CTA works one row at a time
constexpr int kBins = 256;      // 8-bit digits
constexpr int kSel = 3;         // up to three selections a launch
constexpr int kHeader = 5;      // lo_all, hi_all, lo_dead, hi_dead, d_s
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr size_t kBlockSmem = 232448;

// One selection: the k-th largest of keys[j] over j < count (only where
// bit j of mask is set, when mask is given); k == 0 skips it.
struct Select {
  const uint32_t* keys;
  int count;
  uint32_t k;
  const uint32_t* mask;
};

// The k-th largest key of each selection (kth) and how many keys lie above
// it (gt), in every thread. hist enters and leaves zeroed.
template <int Bits>
__device__ void radix_kth(const Select (&sel)[kSel], uint32_t (*hist)[kBins],
                          uint32_t (*res)[2], uint32_t (&kth)[kSel], uint32_t (&gt)[kSel]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t need[kSel];
#pragma unroll
  for (int i = 0; i < kSel; ++i) {
    kth[i] = 0u;
    gt[i] = 0u;
    need[i] = sel[i].k;
  }
#pragma unroll 1
  for (int pass = 0; pass < Bits / 8; ++pass) {
    const int sh = Bits - 8 * (pass + 1);
#pragma unroll
    for (int i = 0; i < kSel; ++i) {
      if (sel[i].k == 0u) continue;
      for (int j = tid; j < sel[i].count; j += kNT) {
        if (sel[i].mask != nullptr && !((sel[i].mask[j >> 5] >> (j & 31)) & 1u)) continue;
        const uint32_t key = sel[i].keys[j];
        if ((static_cast<uint64_t>(key) >> (sh + 8)) != kth[i]) continue;
        atomicAdd(&hist[i][(key >> sh) & 0xFFu], 1u);
      }
    }
    __syncthreads();
    if (warp < kSel && sel[warp].k != 0u) {
      const int i = warp;
      uint32_t c[8], own = 0u;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = hist[i][lane * 8 + b];
        own += c[b];
      }
      const uint32_t suffix = topk::warp_suffix(own);
      if (suffix - own < need[i] && suffix >= need[i]) {
        uint32_t a = suffix - own;
#pragma unroll
        for (int b = 7; b >= 0; --b) {
          if (a + c[b] >= need[i]) {
            res[i][0] = lane * 8 + b;
            res[i][1] = a;
            break;
          }
          a += c[b];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSel; ++i) {
      if (sel[i].k == 0u) continue;
      kth[i] = (kth[i] << 8) | res[i][0];
      need[i] -= res[i][1];
      gt[i] += res[i][1];
    }
    for (int b = tid; b < kSel * kBins; b += kNT) (&hist[0][0])[b] = 0u;
    __syncthreads();
  }
}

// Element j of row `row` of an (m, n) matrix of Row's raw elements, as a key.
template <class Row>
__device__ __forceinline__ uint32_t load_key(const void* acts, size_t row, int n, int j) {
  if constexpr (Row::kBits == 16)
    return Row::key(static_cast<const uint16_t*>(acts)[row * n + j]);
  else
    return Row::key(static_cast<const uint32_t*>(acts)[row * n + j]);
}

template <class Row>
__device__ __forceinline__ bool finite_key(uint32_t key) {
  return key > Row::kNegInf && key < Row::kPosInf;
}

// ------------------------------------------------------------ candidates

template <class Row>
__global__ void __launch_bounds__(kNT)
candidates_kernel(const void* acts, const uint32_t* dead_g, int m, int n, uint32_t k_sel,
                  uint32_t k_aux, uint32_t* out, int width) {
  extern __shared__ __align__(16) uint32_t dyn[];
  uint32_t* keys = dyn;      // n
  uint32_t* dead = dyn + n;  // ceil(n / 32) words of dead bits
  __shared__ uint32_t hist[kSel][kBins];
  __shared__ uint32_t res[kSel][2];
  __shared__ uint32_t red[4];  // lo_all, hi_all, lo_dead, hi_dead
  __shared__ uint32_t cursor[2];
  __shared__ uint32_t n_dead;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nwords = (n + 31) >> 5;
  if (tid == 0) n_dead = 0u;
  for (int w = tid; w < nwords; w += kNT) dead[w] = dead_g[w];
  for (int b = tid; b < kSel * kBins; b += kNT) (&hist[0][0])[b] = 0u;
  __syncthreads();
  uint32_t nd = 0u;
  for (int w = tid; w < nwords; w += kNT) nd += __popc(dead[w]);
  nd = __reduce_add_sync(kFull, nd);
  if (lane == 0 && nd) atomicAdd(&n_dead, nd);
  __syncthreads();
  const uint32_t d_s = n_dead;
  const uint32_t un = static_cast<uint32_t>(n);
  const uint32_t c_main = min(k_sel, un);
  // a selection only where the shard holds more keys than it sends
  const Select sel[kSel] = {{keys, n, un > k_sel ? k_sel : 0u, nullptr},
                            {keys, n, d_s > k_aux ? k_aux : 0u, dead},
                            {nullptr, 0, 0u, nullptr}};

  for (int row = blockIdx.x; row < m; row += gridDim.x) {
    if (tid == 0) {
      red[0] = kNone;
      red[1] = 0u;
      red[2] = kNone;
      red[3] = 0u;
      cursor[0] = cursor[1] = 0u;
    }
    __syncthreads();
    uint32_t lo_a = kNone, hi_a = 0u, lo_d = kNone, hi_d = 0u;
    for (int j = tid; j < n; j += kNT) {
      const uint32_t key = load_key<Row>(acts, row, n, j);
      keys[j] = key;
      const uint32_t km = finite_key<Row>(key) ? key : kNone;
      lo_a = min(lo_a, km);
      hi_a = max(hi_a, key);
      if ((dead[j >> 5] >> (j & 31)) & 1u) {
        lo_d = min(lo_d, km);
        hi_d = max(hi_d, key);
      }
    }
    lo_a = __reduce_min_sync(kFull, lo_a);
    hi_a = __reduce_max_sync(kFull, hi_a);
    lo_d = __reduce_min_sync(kFull, lo_d);
    hi_d = __reduce_max_sync(kFull, hi_d);
    if (lane == 0) {
      atomicMin(&red[0], lo_a);
      atomicMax(&red[1], hi_a);
      atomicMin(&red[2], lo_d);
      atomicMax(&red[3], hi_d);
    }
    __syncthreads();
    uint32_t kth[kSel], gt[kSel];
    radix_kth<Row::kBits>(sel, hist, res, kth, gt);

    uint32_t* o = out + static_cast<size_t>(row) * width;
    uint32_t* oa = o + c_main;
    for (int j = tid; j < n; j += kNT) {
      const uint32_t key = keys[j];
      const bool is_dead = (dead[j >> 5] >> (j & 31)) & 1u;
      if (sel[0].k == 0u)
        o[j] = key;  // n <= k_sel: every key
      else if (key > kth[0])
        o[atomicAdd(&cursor[0], 1u)] = key;
      if (is_dead && (sel[1].k == 0u || key > kth[1])) oa[atomicAdd(&cursor[1], 1u)] = key;
    }
    // the k-th key's ties fill what is left of each region
    if (sel[0].k != 0u)
      for (uint32_t t = gt[0] + tid; t < k_sel; t += kNT) o[t] = kth[0];
    if (sel[1].k != 0u)
      for (uint32_t t = gt[1] + tid; t < k_aux; t += kNT) oa[t] = kth[1];
    else
      for (uint32_t t = d_s + tid; t < k_aux; t += kNT) oa[t] = 0u;
    if (tid < 4) o[c_main + k_aux + tid] = red[tid];
    if (tid == 4) o[c_main + k_aux + 4] = d_s;
    __syncthreads();  // the row's keys and counters are reused by the next row
  }
}

// -------------------------------------------------------------- combine

template <class Row>
__global__ void __launch_bounds__(kNT)
combine_kernel(const uint32_t* g, int p, int m, int width, int c_main, int k_aux,
               const void* acts, int n_local, int n_dict, uint32_t k_main, uint32_t k_multi,
               int iters, float* t_main, float* t_aux, float* t_multi, uint32_t* fired) {
  extern __shared__ __align__(16) uint32_t dyn[];
  uint32_t* cm = dyn;                 // p · c_main keys: every shard's top keys
  uint32_t* ca = cm + p * c_main;     // the shards' dead keys, packed
  uint32_t* fmask = ca + p * k_aux;   // ceil(n_local / 32) words
  __shared__ uint32_t hist[kSel][kBins];
  __shared__ uint32_t res[kSel][2];
  __shared__ uint32_t small[2];       // the smallest main and aux candidate
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwords = (n_local + 31) >> 5;
  for (int w = tid; w < nwords; w += kNT) fmask[w] = 0u;
  for (int b = tid; b < kSel * kBins; b += kNT) (&hist[0][0])[b] = 0u;
  __syncthreads();
  const int n_main = p * c_main;

  for (int row = blockIdx.x; row < m; row += gridDim.x) {
    // the headers: global range, dead count, each shard's aux count
    uint32_t lo_a = kNone, hi_a = 0u, lo_d = kNone, hi_d = 0u, dead_total = 0u;
    int n_aux = 0;
    for (int s = 0; s < p; ++s) {
      const uint32_t* h = g + (static_cast<size_t>(s) * m + row) * width + c_main + k_aux;
      lo_a = min(lo_a, h[0]);
      hi_a = max(hi_a, h[1]);
      lo_d = min(lo_d, h[2]);
      hi_d = max(hi_d, h[3]);
      dead_total += h[4];
      const int a_s = static_cast<int>(min(h[4], static_cast<uint32_t>(k_aux)));
      const uint32_t* src = g + (static_cast<size_t>(s) * m + row) * width + c_main;
      for (int j = tid; j < a_s; j += kNT) ca[n_aux + j] = src[j];
      n_aux += a_s;
    }
    for (int i = tid; i < n_main; i += kNT) {
      const int s = i / c_main, j = i - s * c_main;
      cm[i] = g[(static_cast<size_t>(s) * m + row) * width + j];
    }
    if (tid == 0) small[0] = small[1] = kNone;
    __syncthreads();
    {  // the smallest candidates (the exact path's rule for fewer than k)
      uint32_t s0 = kNone, s1 = kNone;
      for (int i = tid; i < n_main; i += kNT) s0 = min(s0, cm[i]);
      for (int i = tid; i < n_aux; i += kNT) s1 = min(s1, ca[i]);
      s0 = __reduce_min_sync(kFull, s0);
      s1 = __reduce_min_sync(kFull, s1);
      if (lane == 0) {
        atomicMin(&small[0], s0);
        atomicMin(&small[1], s1);
      }
    }
    const uint32_t un = static_cast<uint32_t>(n_dict);
    const uint32_t ks[kSel] = {k_main, static_cast<uint32_t>(k_aux), k_multi};
    const uint32_t cand[kSel] = {un, dead_total, un};
    const Select sel[kSel] = {{cm, n_main, cand[0] >= ks[0] ? ks[0] : 0u, nullptr},
                              {ca, n_aux, cand[1] >= ks[1] ? ks[1] : 0u, nullptr},
                              {cm, n_main, (ks[2] > 0u && cand[2] >= ks[2]) ? ks[2] : 0u, nullptr}};
    uint32_t kth[kSel], gt[kSel];
    radix_kth<Row::kBits>(sel, hist, res, kth, gt);  // its barriers publish `small`
    float* const t_out[kSel] = {t_main, t_aux, t_multi};
    const int nsel = k_multi > 0u ? 3 : 2;
    uint32_t fk;
    if constexpr (Row::kFloat) {
      float tmain = 0.f;
#pragma unroll
      for (int i = 0; i < kSel; ++i) {
        if (i >= nsel || (i != 0 && tid != i)) continue;
        float vk;  // the k-th largest entry of the (masked) row
        if (sel[i].k != 0u)
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
        if (tid == i) t_out[i][row] = lo;
        if (i == 0) tmain = lo;
      }
      fk = max(Row::fire_key(tmain), Row::kZero + 1u);
    } else {
      uint32_t o[kSel];
#pragma unroll
      for (int i = 0; i < kSel; ++i) {
        const uint32_t smallest = small[i == topk::kAux ? 1 : 0];
        o[i] = sel[i].k != 0u ? kth[i] : (cand[i] == 0u ? Row::kInf : smallest);
      }
      if (tid < nsel) {
#pragma unroll
        for (int i = 0; i < kSel; ++i)
          if (i == tid) t_out[i][row] = Row::value(o[i]);
      }
      fk = max(o[0], Row::kZero + 1u);  // >= t_main and positive
    }
    // this shard's fired columns: a warp tests 32 consecutive columns
    for (int base = warp * 32; base < n_local; base += kNT) {
      const int j = base + lane;
      const bool hit = j < n_local && load_key<Row>(acts, row, n_local, j) >= fk;
      const uint32_t word = __ballot_sync(kFull, hit);
      if (lane == 0 && word) atomicOr(&fmask[base >> 5], word);
    }
    __syncthreads();  // the candidates are reused by the next row
  }
  __syncthreads();
  for (int w = tid; w < nwords; w += kNT)
    if (fmask[w]) atomicOr(&fired[w], fmask[w]);
}

// ------------------------------------------------------------ host side

template <class K>
int launch_grid(K kern, size_t dyn, int m, cudaStream_t stream, int* grid) {
  int err = hopper::allow_smem(kern, dyn);
  if (err) return err;
  int per_sm = 0, sms = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kNT, dyn));
  if (err) return err;
  err = hopper::sm_count(&sms);
  if (err) return err;
  const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *grid = static_cast<int>(m < fit ? m : fit);
  return 0;
}

// the widest shard a candidates launch keeps in shared memory
inline int max_local() {
  return static_cast<int>((kBlockSmem - 16384) / (4 + 4.0 / 32));
}

template <class Row>
int candidates(const void* acts, const uint32_t* dead_bits, int m, int n, int k_sel, int k_aux,
               uint32_t* out, int width, cudaStream_t s) {
  if (m == 0) return 0;
  if (n < 1 || n > max_local()) return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = 4 * (static_cast<size_t>(n) + (n + 31) / 32);
  auto kern = candidates_kernel<Row>;
  int grid = 0;
  int err = launch_grid(kern, dyn, m, s, &grid);
  if (err) return err;
  kern<<<grid, kNT, dyn, s>>>(acts, dead_bits, m, n, k_sel, k_aux, out, width);
  return static_cast<int>(cudaGetLastError());
}

template <class Row>
int combine(const uint32_t* g, int p, int m, int width, int c_main, int k_aux, const void* acts,
            int n_local, int n_dict, int k_main, int k_multi, int iters, float* t_main,
            float* t_aux, float* t_multi, uint32_t* fired, cudaStream_t s) {
  if (m == 0) return 0;
  const size_t dyn = 4 * (static_cast<size_t>(p) * (c_main + k_aux) + (n_local + 31) / 32);
  if (dyn > kBlockSmem - 16384) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = combine_kernel<Row>;
  int grid = 0;
  int err = launch_grid(kern, dyn, m, s, &grid);
  if (err) return err;
  kern<<<grid, kNT, dyn, s>>>(g, p, m, width, c_main, k_aux, acts, n_local, n_dict,
                              static_cast<uint32_t>(k_main), static_cast<uint32_t>(k_multi),
                              iters, t_main, t_aux, t_multi, fired);
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
