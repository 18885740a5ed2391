// The routed half of Uni-MoE-2.0-Omni's mixture-of-experts layer for Hopper
// (sm_90a): route, plan, permute, two grouped expert products and the
// combine, with no host synchronisation between them. The counts of rows
// each expert takes stay on the card; the grouped products read them, and
// their offsets, from device memory.
//
// It replaces no TPU kernel: the JAX package has no such model. The plain
// PyTorch versions of every launch are in ops/moe.py, which states the
// numbers each one computes; the layer is models/omni/model.py::MoE.
//
//   route_kernel    one warp a token: the router's five logits as f32 dot
//                   products of the bf16 input with the f32 router weights,
//                   the softmax, then the top-p rule: the largest p always,
//                   the second (ties to the lower index) while the sum of
//                   those before it is below top_p and top_k allows.
//                   → probs (T, n_all) f32, sel (T, top_k) int32 (-1 where
//                   none), wsel (T, top_k) f32 (p of the selected entry).
//   plan_kernel     one block: the counts of each entry (null included)
//                   and, for the n_dyn dynamic experts, their offsets in an
//                   expert-major buffer, and each slot's row there (-1 for
//                   an empty or null slot), in token order within an
//                   expert. No atomics: one launch repeats the next bit for
//                   bit.
//   permute_kernel  one block a token: its input row to each of its rows.
//   gateup_kernel   H = silu(A·W_gateᵀ) ⊙ (A·W_upᵀ) per expert, on its rows
//                   of A. 128 × 256 output tiles over K = d: 128 rows of the
//                   gate and the same 128 rows of up form one 256-row B tile
//                   (two TMA loads), so a thread holds a gate product and its
//                   up product in the same registers, and the epilogue writes
//                   a 128-wide tile of H: bf16(silu(bf16(g))) · bf16(u),
//                   rounded to bf16, as eager bf16 PyTorch rounds it.
//   down_kernel     Y = H·W_downᵀ per expert, 128 × 256 tiles over K = I.
//   combine_kernel  out = bf16(h + fixed + Σ_k wsel_k · Y[row_k]) in f32, in
//                   slot order, each operation rounded on its own (no FMA),
//                   so it equals the plain version bit for bit.
//
// The grouped products: a row tile belongs to one expert. The grid holds
// enough row tiles for the worst case, ceil(T·top_k / 128) + n_dyn; a block
// walks the counts to find its expert and tile, and one past the last
// expert's tiles exits at once. A tile's rows start at the expert's offset,
// anywhere in A: TMA loads rows past the expert's end (the next expert's,
// or zeros past the buffer), whose products are not stored. The pipeline
// is csrc/topk_fused.cu's encode: a producer warp streams 64-wide K slices
// of both operands by TMA through kStages stages; two consumer warpgroups
// of 64 rows issue m64n256k16 from shared memory. Row tiles are walked
// kGroup at a time across all column tiles, so an expert's weight tiles
// are reused from L2 by kGroup row tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxAll = 8;                     // router outputs a warp takes
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kBK = 64;                        // one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kGroup = 16;                     // row tiles walked together
constexpr int kBM = 128, kBN = 256;            // output tile of the products
constexpr int kPlanThreads = 1024;

// ------------------------------------------------------------------ route
__global__ void __launch_bounds__(256)
route_kernel(const bf16* __restrict__ u, const float* __restrict__ w, int t_rows, int d,
             int n_all, float top_p, int top_k, float* __restrict__ probs,
             int* __restrict__ sel, float* __restrict__ wsel) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= t_rows) return;
  const bf16* row = u + static_cast<long long>(warp) * d;
  float logit[kMaxAll];
#pragma unroll
  for (int e = 0; e < kMaxAll; ++e) logit[e] = 0.f;
  for (int c = 8 * lane; c < d; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    float xf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xf[i] = __bfloat162float(x[i]);
#pragma unroll
    for (int e = 0; e < kMaxAll; ++e) {
      if (e < n_all) {
        const float* wr = w + static_cast<long long>(e) * d + c;
        const float4 a = *reinterpret_cast<const float4*>(wr);
        const float4 b = *reinterpret_cast<const float4*>(wr + 4);
        logit[e] += xf[0] * a.x + xf[1] * a.y + xf[2] * a.z + xf[3] * a.w + xf[4] * b.x +
                    xf[5] * b.y + xf[6] * b.z + xf[7] * b.w;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kMaxAll; ++e)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) logit[e] += __shfl_xor_sync(0xffffffffu, logit[e], o);
  if (lane != 0) return;
  float m = logit[0];
  for (int e = 1; e < n_all; ++e) m = fmaxf(m, logit[e]);
  float p[kMaxAll], s = 0.f;
  for (int e = 0; e < n_all; ++e) {
    p[e] = expf(logit[e] - m);
    s += p[e];
  }
  for (int e = 0; e < n_all; ++e) {
    p[e] = p[e] / s;
    probs[static_cast<long long>(warp) * n_all + e] = p[e];
  }
  // the top entries in order, ties to the lower index
  unsigned taken = 0;
  float before = 0.f;
  for (int j = 0; j < top_k; ++j) {
    int best = -1;
    for (int e = 0; e < n_all; ++e)
      if (!(taken >> e & 1u) && (best < 0 || p[e] > p[best])) best = e;
    const bool take = j == 0 || before < top_p;
    sel[static_cast<long long>(warp) * top_k + j] = take ? best : -1;
    wsel[static_cast<long long>(warp) * top_k + j] = take ? p[best] : 0.f;
    if (take) {
      taken |= 1u << best;
      before = before + p[best];
    }
  }
}

// ------------------------------------------------------------------- plan
// One block. Slot s = t·top_k + j. Each thread takes a contiguous run of
// slots, counts its dynamic experts' slots, and a block-wide exclusive scan
// of those counts (expert by expert) gives each run's first row.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ sel, int slots, int n_all, int n_dyn,
            int* __restrict__ counts, int* __restrict__ offsets, int* __restrict__ pos) {
  __shared__ int scan[kMaxAll][kPlanThreads];
  __shared__ int total[kMaxAll];
  const int tid = threadIdx.x;
  const int per = (slots + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(slots, tid * per), hi = min(slots, lo + per);
  int mine[kMaxAll];
#pragma unroll
  for (int e = 0; e < kMaxAll; ++e) mine[e] = 0;
  for (int s = lo; s < hi; ++s) {
    const int e = sel[s];
#pragma unroll
    for (int f = 0; f < kMaxAll; ++f) mine[f] += e == f;
  }
#pragma unroll
  for (int e = 0; e < kMaxAll; ++e) scan[e][tid] = mine[e];
  __syncthreads();
  // Hillis-Steele inclusive scan over the threads, each expert's row
  for (int o = 1; o < kPlanThreads; o <<= 1) {
    int v[kMaxAll];
#pragma unroll
    for (int e = 0; e < kMaxAll; ++e) v[e] = tid >= o ? scan[e][tid - o] : 0;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kMaxAll; ++e) scan[e][tid] += v[e];
    __syncthreads();
  }
  if (tid == 0) {
    int off = 0;
    for (int e = 0; e < n_all; ++e) {
      total[e] = scan[e][kPlanThreads - 1];
      counts[e] = total[e];
      if (e < n_dyn) {
        offsets[e] = off;
        off += total[e];
      }
    }
  }
  __syncthreads();
  int next[kMaxAll];
  int off = 0;
#pragma unroll
  for (int e = 0; e < kMaxAll; ++e) {
    next[e] = off + scan[e][tid] - mine[e];
    if (e < n_dyn) off += total[e];
  }
  for (int s = lo; s < hi; ++s) {
    const int e = sel[s];
    int row = -1;
#pragma unroll
    for (int f = 0; f < kMaxAll; ++f)
      if (e == f && f < n_dyn) row = next[f]++;
    pos[s] = row;
  }
}

// ---------------------------------------------------------------- permute
__global__ void __launch_bounds__(256)
permute_kernel(const bf16* __restrict__ u, const int* __restrict__ pos, int top_k, int d,
               bf16* __restrict__ a) {
  const int t = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(u + static_cast<long long>(t) * d);
  for (int j = 0; j < top_k; ++j) {
    const int r = pos[t * top_k + j];
    if (r < 0) continue;
    uint4* dst = reinterpret_cast<uint4*>(a + static_cast<long long>(r) * d);
    for (int c = threadIdx.x; c < d / 8; c += blockDim.x) dst[c] = src[c];
  }
}

// ---------------------------------------------------------------- combine
__global__ void __launch_bounds__(256)
combine_kernel(const bf16* __restrict__ h, const bf16* __restrict__ fixed,
               const bf16* __restrict__ y, const int* __restrict__ pos,
               const float* __restrict__ wsel, int top_k, int d, bf16* __restrict__ out) {
  const int t = blockIdx.x;
  const long long base = static_cast<long long>(t) * d;
  for (int c = 2 * threadIdx.x; c < d; c += 2 * blockDim.x) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + base + c));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(fixed + base + c));
    float x0 = __fadd_rn(a.x, b.x), x1 = __fadd_rn(a.y, b.y);
    for (int j = 0; j < top_k; ++j) {
      const int r = pos[t * top_k + j];
      if (r < 0) continue;
      const float w = wsel[t * top_k + j];
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(y + static_cast<long long>(r) * d + c));
      x0 = __fadd_rn(x0, __fmul_rn(w, v.x));
      x1 = __fadd_rn(x1, __fmul_rn(w, v.y));
    }
    *reinterpret_cast<__nv_bfloat162*>(out + base + c) = __floats2bfloat162_rn(x0, x1);
  }
}

// ------------------------------------------------------- grouped products
struct Smem {  // every tile 1024-byte aligned (the swizzle atom)
  bf16 a[kStages][kBM * kBK];
  bf16 b[kStages][kBN * kBK];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmem = sizeof(Smem) + 1024;

// The expert and first row of row tile `tm` of the grid, from the counts
// and offsets on the card; false past the last expert's tiles.
__device__ __forceinline__ bool find_tile(int tm, const int* __restrict__ counts,
                                          const int* __restrict__ offsets, int n_dyn,
                                          int& expert, int& row0, int& rows) {
  for (int e = 0; e < n_dyn; ++e) {
    const int c = counts[e];
    const int tiles = (c + kBM - 1) / kBM;
    if (tm < tiles) {
      expert = e;
      row0 = offsets[e] + tm * kBM;
      rows = min(kBM, c - tm * kBM);
      return true;
    }
    tm -= tiles;
  }
  return false;
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// kGateUp: B is gate rows [n0, n0 + 128) over up's same rows (two maps),
// the output tile 128 wide (H); else B is one 256-row map (W_down), the
// output tile 256 wide (Y). w_rows: rows of one expert in the B maps.
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 1)
grouped_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap b0map,
               const __grid_constant__ CUtensorMap b1map, const int* __restrict__ counts,
               const int* __restrict__ offsets, int n_dyn, int tiles_m, int tiles_n,
               int w_rows, int k, int n_out, bf16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hopper::align1024(smem_raw));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int tm, tn;
  hopper::grouped_tile(blockIdx.x, tiles_m, tiles_n, kGroup, tm, tn);
  int expert, row0, rows;
  if (!find_tile(tm, counts, offsets, n_dyn, expert, row0, rows)) return;
  const int k_tiles = k / kBK;

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
      const int w0 = expert * w_rows + tn * (kGateUp ? kBN / 2 : kBN);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) hopper::mbar_wait(&sm.empty[st], ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&sm.full[st], (kBM + kBN) * kBK * 2);
        hopper::tma_load_2d(sm.a[st], &amap, &sm.full[st], kt * kBK, row0);
        if (kGateUp) {
          hopper::tma_load_2d(sm.b[st], &b0map, &sm.full[st], kt * kBK, w0);
          hopper::tma_load_2d(sm.b[st] + (kBN / 2) * kBK, &b1map, &sm.full[st], kt * kBK, w0);
        } else {
          hopper::tma_load_2d(sm.b[st], &b0map, &sm.full[st], kt * kBK, w0);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
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

  // Epilogue from the registers: thread `lane` of warp w holds acc[i] at
  // row 16·w + lane/4 + 8·((i/2) % 2) of its warpgroup's 64, column
  // 8·(i/4) + 2·(lane % 4) + i % 2 (csrc/hopper.cuh).
  const int g = lane / 4;
  const int t = lane % 4;
  const int rbase = wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int j = 0; j < (kGateUp ? kBN / 16 : kBN / 8); ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rbase + 8 * hh;
      if (r >= rows) continue;
      const int i = 4 * j + 2 * hh;
      float v0, v1;
      if (kGateUp) {  // acc[i + 64] is the up product of acc[i]'s column
        v0 = round_bf16(silu(round_bf16(acc[i]))) * round_bf16(acc[i + kBN / 4]);
        v1 = round_bf16(silu(round_bf16(acc[i + 1]))) * round_bf16(acc[i + 1 + kBN / 4]);
      } else {
        v0 = acc[i];
        v1 = acc[i + 1];
      }
      const int col = tn * (kGateUp ? kBN / 2 : kBN) + c;
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row0 + r) * n_out +
                                         col) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

int launch_grouped(bool gate_up, const void* a, int rows_max, int k, const void* w0,
                   const void* w1, int n_dyn, int w_rows, int n_out, const int* counts,
                   const int* offsets, void* out, cudaStream_t s) {
  CUtensorMap amap, b0map, b1map;
  const int box_b = gate_up ? kBN / 2 : kBN;
  int err = hopper::matrix_map(&amap, a, rows_max, k, kBK, kBM);
  if (!err) err = hopper::matrix_map(&b0map, w0, n_dyn * w_rows, k, kBK, box_b);
  if (!err) err = hopper::matrix_map(&b1map, gate_up ? w1 : w0, n_dyn * w_rows, k, kBK, box_b);
  if (err) return err;
  const int tiles_m = (rows_max + kBM - 1) / kBM + n_dyn;
  const int tiles_n = n_out / (gate_up ? kBN / 2 : kBN);
  const int blocks = tiles_m * tiles_n;
  if (gate_up) {
    err = hopper::allow_smem(grouped_kernel<true>, kSmem);
    if (err) return err;
    grouped_kernel<true><<<blocks, kThreads, kSmem, s>>>(
        amap, b0map, b1map, counts, offsets, n_dyn, tiles_m, tiles_n, w_rows, k, n_out,
        static_cast<bf16*>(out));
  } else {
    err = hopper::allow_smem(grouped_kernel<false>, kSmem);
    if (err) return err;
    grouped_kernel<false><<<blocks, kThreads, kSmem, s>>>(
        amap, b0map, b1map, counts, offsets, n_dyn, tiles_m, tiles_n, w_rows, k, n_out,
        static_cast<bf16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int freud_moe_max_all() { return kMaxAll; }

// u (t, d) bf16; w (n_all, d) f32 → probs (t, n_all) f32, sel (t, top_k)
// int32, wsel (t, top_k) f32. d % 8 == 0, n_all <= kMaxAll, top_k <= n_all.
int freud_moe_route(const void* u, const float* w, int t, int d, int n_all, float top_p,
                    int top_k, float* probs, int* sel, float* wsel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 0) return 0;
  const long long threads = 32ll * t;
  route_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(u), w, t, d, n_all, top_p, top_k, probs, sel, wsel);
  return static_cast<int>(cudaGetLastError());
}

// sel (slots,) int32 → counts (n_all,), offsets (n_dyn,), pos (slots,) int32.
int freud_moe_plan(const int* sel, int slots, int n_all, int n_dyn, int* counts,
                   int* offsets, int* pos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  plan_kernel<<<1, kPlanThreads, 0, s>>>(sel, slots, n_all, n_dyn, counts, offsets, pos);
  return static_cast<int>(cudaGetLastError());
}

// u (t, d) bf16, pos (t, top_k) → rows of a (rows_max, d) bf16. d % 8 == 0.
int freud_moe_permute(const void* u, const int* pos, int t, int top_k, int d, void* a,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 0) return 0;
  permute_kernel<<<t, 256, 0, s>>>(static_cast<const bf16*>(u), pos, top_k, d,
                                   static_cast<bf16*>(a));
  return static_cast<int>(cudaGetLastError());
}

// a (rows_max, d) bf16; w_gate, w_up (n_dyn·i, d) bf16 → h (rows_max, i)
// bf16 on each expert's rows. d % 64 == 0, i % 128 == 0.
int freud_moe_gateup(const void* a, int rows_max, int d, const void* w_gate,
                     const void* w_up, int n_dyn, int i, const int* counts,
                     const int* offsets, void* h, void* stream) {
  return launch_grouped(true, a, rows_max, d, w_gate, w_up, n_dyn, i, i, counts, offsets, h,
                        static_cast<cudaStream_t>(stream));
}

// h (rows_max, i) bf16; w_down (n_dyn·d, i) bf16 → y (rows_max, d) bf16 on
// each expert's rows. i % 64 == 0, d % 256 == 0.
int freud_moe_down(const void* h, int rows_max, int i, const void* w_down, int n_dyn, int d,
                   const int* counts, const int* offsets, void* y, void* stream) {
  return launch_grouped(false, h, rows_max, i, w_down, nullptr, n_dyn, d, d, counts, offsets,
                        y, static_cast<cudaStream_t>(stream));
}

// h, fixed (t, d) bf16; y (rows_max, d) bf16; pos (t, top_k); wsel (t,
// top_k) f32 → out (t, d) bf16. d % 2 == 0.
int freud_moe_combine(const void* h, const void* fixed, const void* y, const int* pos,
                      const float* wsel, int t, int top_k, int d, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 0) return 0;
  combine_kernel<<<t, 256, 0, s>>>(static_cast<const bf16*>(h), static_cast<const bf16*>(fixed),
                                   static_cast<const bf16*>(y), pos, wsel, top_k, d,
                                   static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
