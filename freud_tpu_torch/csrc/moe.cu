// The routed half of a mixture-of-experts layer for Hopper (sm_90a): the
// router's selection, the plan, the permute, two grouped expert products
// and the combine, with no host synchronisation between them. The counts of
// rows each expert takes stay on the card; the grouped products read them,
// and their offsets, from device memory. Two models run them:
// Uni-MoE-2.0-Omni (models/omni/model.py::MoE: route, a top-p rule over 5
// entries, every expert held) and LongCat-Flash-Omni (models/longcat/
// model.py::MoE: route_topk, a biased top-12 over 768 entries, 16 experts
// of 512 held and 256 identity entries).
//
// It replaces no TPU kernel: the JAX package has no such model. The plain
// PyTorch versions of every launch are in ops/moe.py, which states the
// numbers each one computes.
//
//   route_kernel       one warp a token: the router's five logits as f32 dot
//                      products of the bf16 input with the f32 router
//                      weights, the softmax, then the top-p rule: the largest
//                      p always, the second (ties to the lower index) while
//                      the sum of those before it is below top_p and top_k
//                      allows. → probs (T, n_all) f32, sel (T, top_k) int32
//                      (-1 where none), wsel (T, top_k) f32.
//   route_topk_kernel  one warp a token over f32 logits the caller computed
//                      (up to 1024 entries, 32 a lane): the softmax (the sum
//                      in the order ops/moe.py's plain version repeats), then
//                      top_k rounds of a warp arg-max of p + bias (ties to the
//                      lower index). → probs, sel, wsel = scale · p of the
//                      chosen entry (the bias chooses, it does not weigh), and
//                      each slot's class: 0 held, 1 identity, 2 absent.
//   plan_kernel        one block a held expert [lo, lo + n_held): its offset
//                      in an expert-major buffer and its slots' rows there in
//                      slot order; block 0 also the counts of every router
//                      entry (a shared histogram) and -1 for each slot of no
//                      held expert. The counts are sums of integers and the
//                      rows an order: one launch repeats the next bit for bit.
//   permute_kernel     one block a token: its input row to each of its rows.
//   gateup_kernel      H = silu(A·W_gateᵀ) ⊙ (A·W_upᵀ) per expert, on its rows
//                      of A. 128 × 256 output tiles over K = d: 128 rows of the
//                      gate and the same 128 rows of up form one 256-row B tile
//                      (two TMA loads), so a thread holds a gate product and
//                      its up product in the same registers, and the epilogue
//                      writes a 128-wide tile of H: bf16(silu(bf16(g))) ·
//                      bf16(u), rounded to bf16, as eager bf16 PyTorch rounds.
//   down_kernel        Y = H·W_downᵀ per expert, 128 × 256 tiles over K = I.
//   combine_kernel     out = bf16(h + fixed + Σ_k w_k · v_k) in f32, in slot
//                      order, v_k = Y[row_k] for a held slot and u (the layer's
//                      MoE input) for an identity slot, nothing for another,
//                      each operation rounded on its own (no FMA), so it
//                      equals the plain version bit for bit.
//
// The grouped products: a row tile belongs to one expert. The grid is
// persistent, one block an SM (at most as many as the worst case's tiles):
// a block reads the counts, finds how many row tiles the held rows make, and
// takes tile after tile from a counter in device memory (zeroed before the
// launch) until none is left, so rows the router sent elsewhere launch
// nothing and the tiles in flight stay consecutive, as the hardware's own
// block order keeps them. A tile's rows start at the expert's offset,
// anywhere in A: TMA loads rows past the expert's end (the next expert's, or
// zeros past the buffer), whose products are not stored. The pipeline is csrc/
// topk_fused.cu's encode: a producer warp streams 64-wide K slices of both
// operands by TMA through kStages stages, running on into the block's next
// tile while the consumers write the last one out; two consumer warpgroups
// of 64 rows issue m64n256k16 from shared memory. Tiles are numbered kGroup
// row tiles at a time across all column tiles, so an expert's weight tiles
// are reused from L2 by kGroup row tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRouteMaxAll = 8;                // router outputs route_kernel takes
constexpr int kLanePer = 32;                   // route_topk_kernel: entries a lane holds
constexpr int kMaxAll = 32 * kLanePer;         // router entries route_topk and plan take
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
  float logit[kRouteMaxAll];
#pragma unroll
  for (int e = 0; e < kRouteMaxAll; ++e) logit[e] = 0.f;
  for (int c = 8 * lane; c < d; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    float xf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xf[i] = __bfloat162float(x[i]);
#pragma unroll
    for (int e = 0; e < kRouteMaxAll; ++e) {
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
  for (int e = 0; e < kRouteMaxAll; ++e)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) logit[e] += __shfl_xor_sync(0xffffffffu, logit[e], o);
  if (lane != 0) return;
  float m = logit[0];
  for (int e = 1; e < n_all; ++e) m = fmaxf(m, logit[e]);
  float p[kRouteMaxAll], s = 0.f;
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

// ------------------------------------------------------------- route_topk
__global__ void __launch_bounds__(256)
route_topk_kernel(const float* __restrict__ logits, const float* __restrict__ bias,
                  int t_rows, int n_all, int top_k, float scale, int held_lo, int held_hi,
                  int id_lo, int id_hi, float* __restrict__ probs, int* __restrict__ sel,
                  float* __restrict__ wsel, int8_t* __restrict__ cls) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= t_rows) return;
  const long long base = static_cast<long long>(warp) * n_all;
  float p[kLanePer];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kLanePer; ++i) {
    const int c = lane + 32 * i;
    p[i] = c < n_all ? logits[base + c] : -INFINITY;
    m = fmaxf(m, p[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  // each lane sums its entries in order, then the butterfly: every lane
  // ends with the same sum (ops/moe.py's route_topk_plain repeats it)
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLanePer; ++i) {
    if (lane + 32 * i < n_all) {
      p[i] = expf(p[i] - m);
      s = __fadd_rn(s, p[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  float score[kLanePer];
#pragma unroll
  for (int i = 0; i < kLanePer; ++i) {
    const int c = lane + 32 * i;
    if (c < n_all) {
      p[i] = __fdiv_rn(p[i], s);
      probs[base + c] = p[i];
      score[i] = __fadd_rn(p[i], bias[c]);
    } else {
      score[i] = -INFINITY;
    }
  }
  unsigned taken = 0;  // bit i: entry lane + 32·i chosen
  for (int j = 0; j < top_k; ++j) {
    float bv = -INFINITY, bp = 0.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < kLanePer; ++i) {
      const int c = lane + 32 * i;
      if (c < n_all && !(taken >> i & 1u) && (score[i] > bv || (score[i] == bv && c < bi))) {
        bv = score[i];
        bi = c;
        bp = p[i];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const float op = __shfl_xor_sync(0xffffffffu, bp, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (lane == bi % 32) taken |= 1u << (bi / 32);
    if (lane == 0) {
      const long long slot = static_cast<long long>(warp) * top_k + j;
      sel[slot] = bi;
      wsel[slot] = __fmul_rn(scale, bp);
      cls[slot] = bi >= held_lo && bi < held_hi ? 0 : (bi >= id_lo && bi < id_hi ? 1 : 2);
    }
  }
}

// ------------------------------------------------------------------- plan
// One block a held expert. Slot s = t·top_k + j. Block 0 counts every entry
// (a shared histogram) and writes -1 for the slots of no held expert; each
// other block g counts the slots of the held experts before its own (its
// offset; block 0's is 0). Then each block walks every slot in order, 4
// consecutive slots a thread, to give its own expert's slots their rows (a
// warp scan of the threads' matches, a scan of the warps' totals, a running
// total over the tiles).
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ sel, int slots, int n_all, int lo, int n_held,
            int* __restrict__ counts, int* __restrict__ offsets, int* __restrict__ pos) {
  __shared__ int hist[kMaxAll];
  __shared__ int warp_sum[kPlanThreads / 32];
  __shared__ int tile_total;
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int own = lo + g;
  if (g == 0) {
    for (int c = tid; c < n_all; c += kPlanThreads) hist[c] = 0;
    __syncthreads();
    for (int s = tid; s < slots; s += kPlanThreads) {
      const int e = sel[s];
      if (e >= 0 && e < n_all) atomicAdd(&hist[e], 1);
      if (e < lo || e >= lo + n_held) pos[s] = -1;
    }
    __syncthreads();
    for (int c = tid; c < n_all; c += kPlanThreads) counts[c] = hist[c];
    if (tid == 0) {
      offsets[0] = 0;
      tile_total = 0;
    }
  } else {
    int before = 0;  // slots of the held experts before this block's
    for (int s = tid; s < slots; s += kPlanThreads) {
      const int e = sel[s];
      before += e >= lo && e < own;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
    if (lane == 0) warp_sum[warp] = before;
    __syncthreads();
    if (warp == 0) {
      int v = warp_sum[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) {
        offsets[g] = v;
        tile_total = v;
      }
    }
  }
  __syncthreads();
  int run = tile_total;
  __syncthreads();
  for (int base = 0; base < slots; base += 4 * kPlanThreads) {
    const int s0 = base + 4 * tid;
    bool m[4];
    int c = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = s0 + i < slots && sel[s0 + i] == own;
      c += m[i];
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // the warps' totals → the rows before each warp
      const int v = warp_sum[lane];
      int w = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sum[lane] = w - v;
      if (lane == 31) tile_total = w;
    }
    __syncthreads();
    int row = run + warp_sum[warp] + incl - c;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m[i]) pos[s0 + i] = row++;
    run += tile_total;
    __syncthreads();
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
               const float* __restrict__ wsel, const bf16* __restrict__ u,
               const int* __restrict__ sel, int top_k, int d, int id_lo, int id_hi,
               bf16* __restrict__ out) {
  const int t = blockIdx.x;
  const long long base = static_cast<long long>(t) * d;
  for (int c = 2 * threadIdx.x; c < d; c += 2 * blockDim.x) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + base + c));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(fixed + base + c));
    float x0 = __fadd_rn(a.x, b.x), x1 = __fadd_rn(a.y, b.y);
    for (int j = 0; j < top_k; ++j) {
      const int r = pos[t * top_k + j];
      const bf16* src;
      if (r >= 0) {
        src = y + static_cast<long long>(r) * d;
      } else {
        const int e = sel[t * top_k + j];
        if (e < id_lo || e >= id_hi) continue;
        src = u + base;  // an identity entry: its weight times the input
      }
      const float w = wsel[t * top_k + j];
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c));
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
  uint64_t tile_full[2];   // the producer has fetched the next tile's number
  uint64_t tile_empty[2];  // the consumers have read it
  int tile[2];             // that number, or -1 when none is left
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
               const int* __restrict__ offsets, int* __restrict__ next, int n_dyn,
               int tiles_n, int w_rows, int k, int n_out, bf16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hopper::align1024(smem_raw));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int tiles_m = 0;  // the row tiles the held rows make
  for (int e = 0; e < n_dyn; ++e) tiles_m += (counts[e] + kBM - 1) / kBM;
  const int tiles = tiles_m * tiles_n;
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int k_tiles = k / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_init(&sm.empty[st], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&sm.tile_full[i], 1);
      hopper::mbar_init(&sm.tile_empty[i], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ------------------------------ producer
    if (lane == 0) {
      int it = 0;  // K slices issued by this block, over all its tiles
      for (int j = 0;; ++j) {  // the block's j-th tile, the next the grid has left
        const int slot = j & 1;
        if (j >= 2) hopper::mbar_wait(&sm.tile_empty[slot], ((j / 2) & 1) ^ 1);
        const int tile = atomicAdd(next, 1);
        sm.tile[slot] = tile < tiles ? tile : -1;
        hopper::mbar_arrive(&sm.tile_full[slot]);
        if (tile >= tiles) break;
        int tm, tn, expert, row0, rows;
        hopper::grouped_tile(tile, tiles_m, tiles_n, kGroup, tm, tn);
        find_tile(tm, counts, offsets, n_dyn, expert, row0, rows);
        const int w0 = expert * w_rows + tn * (kGateUp ? kBN / 2 : kBN);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int st = it % kStages;
          if (it >= kStages) hopper::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          hopper::mbar_expect_tx(&sm.full[st], (kBM + kBN) * kBK * 2);
          hopper::tma_load_2d(sm.a[st], &amap, &sm.full[st], kt * kBK, row0);
          if (kGateUp) {
            hopper::tma_load_2d(sm.b[st], &b0map, &sm.full[st], kt * kBK, w0);
            hopper::tma_load_2d(sm.b[st] + (kBN / 2) * kBK, &b1map, &sm.full[st], kt * kBK,
                                w0);
          } else {
            hopper::tma_load_2d(sm.b[st], &b0map, &sm.full[st], kt * kBK, w0);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rbase = wg * 64 + (warp % 4) * 16 + g;
  int it = 0;  // K slices consumed, over all the block's tiles
  for (int j = 0;; ++j) {
    const int slot = j & 1;
    hopper::mbar_wait(&sm.tile_full[slot], (j / 2) & 1);
    const int tile = sm.tile[slot];
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.tile_empty[slot]);
    if (tile < 0) break;
    int tm, tn, expert, row0, rows;
    hopper::grouped_tile(tile, tiles_m, tiles_n, kGroup, tm, tn);
    find_tile(tm, counts, offsets, n_dyn, expert, row0, rows);
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(&sm.full[st], (it / kStages) & 1);
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
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&sm.empty[(it - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&sm.empty[(it - 1) % kStages]);

    // Epilogue from the registers: thread `lane` of warp w holds acc[i] at
    // row 16·w + lane/4 + 8·((i/2) % 2) of its warpgroup's 64, column
    // 8·(i/4) + 2·(lane % 4) + i % 2 (csrc/hopper.cuh).
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
}

int sm_count() {
  static int n = 0;  // read once: the launch must not query the device each time
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

int launch_grouped(bool gate_up, const void* a, int rows_max, int k, const void* w0,
                   const void* w1, int n_dyn, int w_rows, int n_out, const int* counts,
                   const int* offsets, int* next, void* out, cudaStream_t s) {
  CUtensorMap amap, b0map, b1map;
  const int box_b = gate_up ? kBN / 2 : kBN;
  int err = hopper::matrix_map(&amap, a, rows_max, k, kBK, kBM);
  if (!err) err = hopper::matrix_map(&b0map, w0, n_dyn * w_rows, k, kBK, box_b);
  if (!err) err = hopper::matrix_map(&b1map, gate_up ? w1 : w0, n_dyn * w_rows, k, kBK, box_b);
  if (err) return err;
  const int tiles_n = n_out / (gate_up ? kBN / 2 : kBN);
  // the worst case's tiles: every row held, each expert's last tile partial
  const long long worst = static_cast<long long>((rows_max + kBM - 1) / kBM + n_dyn) * tiles_n;
  const int blocks = static_cast<int>(worst < sm_count() ? worst : sm_count());
  err = static_cast<int>(cudaMemsetAsync(next, 0, sizeof(int), s));  // the tile dispenser
  if (err) return err;
  if (gate_up) {
    err = hopper::allow_smem(grouped_kernel<true>, kSmem);
    if (err) return err;
    grouped_kernel<true><<<blocks, kThreads, kSmem, s>>>(
        amap, b0map, b1map, counts, offsets, next, n_dyn, tiles_n, w_rows, k, n_out,
        static_cast<bf16*>(out));
  } else {
    err = hopper::allow_smem(grouped_kernel<false>, kSmem);
    if (err) return err;
    grouped_kernel<false><<<blocks, kThreads, kSmem, s>>>(
        amap, b0map, b1map, counts, offsets, next, n_dyn, tiles_n, w_rows, k, n_out,
        static_cast<bf16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// which 0: the router outputs route takes; else the entries route_topk
// and plan take.
int freud_moe_max_all(int which) { return which == 0 ? kRouteMaxAll : kMaxAll; }

// u (t, d) bf16; w (n_all, d) f32 → probs (t, n_all) f32, sel (t, top_k)
// int32, wsel (t, top_k) f32. d % 8 == 0, n_all <= kRouteMaxAll, top_k <= n_all.
int freud_moe_route(const void* u, const float* w, int t, int d, int n_all, float top_p,
                    int top_k, float* probs, int* sel, float* wsel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 0) return 0;
  const long long threads = 32ll * t;
  route_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(u), w, t, d, n_all, top_p, top_k, probs, sel, wsel);
  return static_cast<int>(cudaGetLastError());
}

// logits (t, n_all) f32, bias (n_all,) f32 → probs (t, n_all) f32, sel (t,
// top_k) int32, wsel (t, top_k) f32, cls (t, top_k) int8. n_all <= kMaxAll,
// top_k <= n_all.
int freud_moe_route_topk(const float* logits, const float* bias, int t, int n_all, int top_k,
                         float scale, int held_lo, int held_hi, int id_lo, int id_hi,
                         float* probs, int* sel, float* wsel, void* cls, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 0) return 0;
  const long long threads = 32ll * t;
  route_topk_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      logits, bias, t, n_all, top_k, scale, held_lo, held_hi, id_lo, id_hi, probs, sel, wsel,
      static_cast<int8_t*>(cls));
  return static_cast<int>(cudaGetLastError());
}

// sel (slots,) int32 → counts (n_all,), offsets (n_held,) of the held
// experts [lo, lo + n_held), pos (slots,) int32. n_all <= kMaxAll, n_held >= 1.
int freud_moe_plan(const int* sel, int slots, int n_all, int lo, int n_held, int* counts,
                   int* offsets, int* pos, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  plan_kernel<<<n_held, kPlanThreads, 0, s>>>(sel, slots, n_all, lo, n_held, counts, offsets,
                                              pos);
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
// bf16 on each expert's rows; counts (n_dyn,) and offsets (n_dyn,) of the
// held experts; next: one int of scratch. d % 64 == 0, i % 128 == 0.
int freud_moe_gateup(const void* a, int rows_max, int d, const void* w_gate,
                     const void* w_up, int n_dyn, int i, const int* counts,
                     const int* offsets, int* next, void* h, void* stream) {
  return launch_grouped(true, a, rows_max, d, w_gate, w_up, n_dyn, i, i, counts, offsets, next,
                        h, static_cast<cudaStream_t>(stream));
}

// h (rows_max, i) bf16; w_down (n_dyn·d, i) bf16 → y (rows_max, d) bf16 on
// each expert's rows. i % 64 == 0, d % 256 == 0.
int freud_moe_down(const void* h, int rows_max, int i, const void* w_down, int n_dyn, int d,
                   const int* counts, const int* offsets, int* next, void* y, void* stream) {
  return launch_grouped(false, h, rows_max, i, w_down, nullptr, n_dyn, d, d, counts, offsets,
                        next, y, static_cast<cudaStream_t>(stream));
}

// h, fixed (t, d) bf16; y (rows_max, d) bf16; pos (t, top_k); wsel (t,
// top_k) f32; u (t, d) bf16 and sel (t, top_k), read for a slot of an
// identity entry [id_lo, id_hi) only → out (t, d) bf16. d % 2 == 0.
int freud_moe_combine(const void* h, const void* fixed, const void* y, const int* pos,
                      const float* wsel, const void* u, const int* sel, int t, int top_k,
                      int d, int id_lo, int id_hi, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 0) return 0;
  combine_kernel<<<t, 256, 0, s>>>(static_cast<const bf16*>(h), static_cast<const bf16*>(fixed),
                                   static_cast<const bf16*>(y), pos, wsel,
                                   static_cast<const bf16*>(u), sel, top_k, d, id_lo, id_hi,
                                   static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
