// The SAE encode's top-k, for Hopper (sm_90a): for every row of an (M, n)
// latent, its k largest values in descending order, ties to the lower
// column, and their columns (int64): bit for bit what a stable descending
// torch.sort on the card followed by [..., :k] returns. Optionally the
// encode's prologue, relu(z + b_enc) over the f32 product z, formed in the
// load.
//
// Replaces no Pallas kernel: the JAX package leaves its lax.top_k to XLA
// (freud_tpu/models/sae/topk.py select_topk). The port's plain version
// sorted every latent of every row to keep k of them (cub's segmented
// radix sort over the f32 values and an int64 iota, ~60x one read of the
// latent at large_v1_audioset's collection shape).
//
// What bounds it on an H100: one read of the latent, M · n · 4 bytes in f32
// (48,000 × 20,480: 3.93 GB, 1.17 ms at 3.35 TB/s); the bias, k values and
// k columns a row are noise beside it. The design: the selection core of
// kernels #3 and #4 (csrc/topk_select.cuh) with its indexed epilogue. Rows
// stream by bulk copies into a ring in shared memory and sit in registers
// as order keys, the bias added and the ReLU applied as they move there
// (the bias read through the read-only cache, which keeps it: 80 KB at
// 20,480 columns); the radix passes find each row's exact k-th key from the
// keys staged above the last row's cutoffs, without a pass per digit over
// device memory; the epilogue takes the keys above the k-th key and the
// first of its ties in column order, and sorts those k pairs in shared
// memory. So the product is read once and nothing of (M, n) is written: no
// scratch of (M, n), no index iota, no host synchronisation.
//
// Order: the keys reproduce the comparisons of torch.sort on the card (cub's
// radix sort), which are IEEE order but for one pair: -0 and +0 tie (ReLU
// on the CPU leaves -0; a product or a bf16 cast can), so -0 is keyed as
// +0, and the column decides. A NaN sorts by its bits there: with the sign
// clear above +inf, with it set below -inf, two NaNs by their payloads
// (the CPU's sort puts every NaN on top instead; the plain version on the
// CPU is that sort). Ties go to the lower column. The output holds the
// elements themselves: the zero key stands for +0 and -0, so that element
// is read again at its column.
//
// Widths: a row wider than one kernel takes (max_n: 28,672 f32 columns,
// 57,344 bf16) is split into `parts` segments of n / parts columns, the
// (M, n) matrix read as (M · parts, n / parts). Each CTA walks rows of one
// segment (the grid is a multiple of parts); each
// segment's k pairs carry the whole row's columns, and a second launch
// merges parts · k pairs into k: a block a row, a thread a pair, whose
// place is its place in its own segment's sorted list plus a binary search
// into each other's. The segment count comes from n alone (the wrapper's
// rule, ops/topk_indexed.py segments).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_select.cuh"

namespace indexed {

constexpr int kMaxK = 256;
constexpr int kMaxItems = 1024;  // parts · k a merge block holds

// The widest row segment a launch takes: 7 chunks a thread at 1024 threads.
template <class Row>
constexpr int max_n() {
  return 7 * 1024 * Row::kPerChunk;
}

// Picks the kernel for the segment's width: 256 or 512 threads a row up to
// 10 chunks a thread (20,480 f32 columns), 1024 threads beyond (on an H100
// at 700 W: at 48,000 × 20,480 f32, 512 threads ran 4.82 ms, 1024 threads
// 6.02; at 28,672 columns 1024 threads ran faster than 512 with 14 chunks,
// whose registers spill).
template <class Row>
int launch(topk::SelectParams p, cudaStream_t stream) {
  const int chunks = (p.n + Row::kPerChunk - 1) / Row::kPerChunk;
  const bool aligned = reinterpret_cast<uintptr_t>(p.acts) % 16 == 0 &&
                       (static_cast<size_t>(p.n) * Row::kElem) % 16 == 0;
  const int per256 = (chunks + 255) / 256, per512 = (chunks + 511) / 512,
            per1024 = (chunks + 1023) / 1024;
#define TOPK_TRY(NT_, CH_, PER_) \
  if ((PER_) <= (CH_)) return topk::launch_rows<Row, NT_, CH_, topk::kIndexed>(p, aligned, stream);
  TOPK_TRY(256, 2, per256)
  TOPK_TRY(256, 4, per256)
  TOPK_TRY(512, 4, per512)
  TOPK_TRY(512, 6, per512)
  TOPK_TRY(512, 10, per512)
  TOPK_TRY(1024, 7, per1024)
#undef TOPK_TRY
  return static_cast<int>(cudaErrorInvalidValue);
}

// parts · k pairs of a row → its k: raw (m · parts, k) elements and idx
// their whole-row columns, each segment's list already in the sort's
// order; vals (m, k) in the input's type, out_idx (m, k) int64.
template <class Row>
__global__ void __launch_bounds__(kMaxItems)
topk_merge_kernel(const uint32_t* __restrict__ raw, const int32_t* __restrict__ idx, int parts, int k,
             void* __restrict__ vals, int64_t* __restrict__ out_idx) {
  __shared__ uint2 items[kMaxItems];  // (sort key, column)
  const int row = blockIdx.x, t = threadIdx.x, n_items = parts * k;
  const size_t at = static_cast<size_t>(row) * n_items + t;  // segment t / k, entry t % k
  uint32_t r = 0u;
  uint2 me = make_uint2(0u, 0u);
  if (t < n_items) {
    r = raw[at];
    me = make_uint2(Row::sort_key(r), static_cast<uint32_t>(idx[at]));
    items[t] = me;
  }
  __syncthreads();
  if (t >= n_items) return;
  const int own = t / k;
  uint32_t place = t - own * k;
  for (int q = 0; q < parts; ++q) {
    if (q == own) continue;
    int lo = 0, hi = k;  // the entries of list q before me
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const uint2 o = items[q * k + mid];
      if (o.x > me.x || (o.x == me.x && o.y < me.y))
        lo = mid + 1;
      else
        hi = mid;
    }
    place += lo;
  }
  if (place < static_cast<uint32_t>(k)) {
    const size_t o = static_cast<size_t>(row) * k + place;
    if constexpr (Row::kBits == 16)
      static_cast<uint16_t*>(vals)[o] = static_cast<uint16_t>(r);
    else
      static_cast<uint32_t*>(vals)[o] = r;
    out_idx[o] = me.y;
  }
}

template <class Row>
int run(const void* x, const float* bias, int m, int n, int k, int parts, void* vals,
        int64_t* idx, uint32_t* seg_raw, int32_t* seg_idx, cudaStream_t s) {
  if (m == 0) return 0;
  if (parts < 1 || n % parts != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_seg = n / parts;
  if (k < 1 || k > kMaxK || k > n_seg || n_seg > max_n<Row>() || parts * k > kMaxItems)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(m) * parts > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const topk::SelectParams p = topk::indexed_params(
      x, bias, m * parts, n_seg, k, parts, parts == 1 ? vals : static_cast<void*>(seg_raw),
      parts == 1 ? static_cast<void*>(idx) : static_cast<void*>(seg_idx));
  int err = launch<Row>(p, s);
  if (err || parts == 1) return err;
  const int threads = (parts * k + 31) / 32 * 32;
  topk_merge_kernel<Row><<<m, threads, 0, s>>>(seg_raw, seg_idx, parts, k, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace indexed

extern "C" {

// The widest segment of a row one launch takes, in columns.
int freud_topk_indexed_max_n(int bf16) {
  return bf16 ? indexed::max_n<topk::Bf16Value>() : indexed::max_n<topk::F32Value>();
}

// x (m, n) row-major, bf16 (bf16 = 1) or f32; bias (n,) f32 or null (f32
// only: relu(x + bias) is selected and returned); parts divides n. vals (m,
// k) in x's type, idx (m, k) int64; seg_raw, seg_idx (m · parts, k) words
// of scratch where parts > 1. Returns cudaError_t.
int freud_topk_indexed(const void* x, int bf16, const float* bias, int m, int n, int k, int parts,
                       void* vals, int64_t* idx, uint32_t* seg_raw, int32_t* seg_idx,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (bias) return static_cast<int>(cudaErrorInvalidValue);
    return indexed::run<topk::Bf16Value>(x, nullptr, m, n, k, parts, vals, idx, seg_raw, seg_idx, s);
  }
  return indexed::run<topk::F32Value>(x, bias, m, n, k, parts, vals, idx, seg_raw, seg_idx, s);
}

}  // extern "C"
