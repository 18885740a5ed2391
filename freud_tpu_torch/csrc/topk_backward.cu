// The TopK SAE backward's two passes over the (M, n_dict) latent around its
// matrix products, for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX's hand-written VJP (freud_tpu/models/sae/
// topk.py:409-470) leaves its masks and selects to XLA, which fuses them
// into the products' operands and epilogues. Eager PyTorch ran them as
// about eleven passes (compares, broadcasts, `&`, `where`, an add, a column
// sum), writing boolean masks and `where` temporaries to device memory.
// A fused backward kernel lost on the TPU (topk.py:418-420), so the five
// products stay plain large GEMMs (torch.mm); only the passes around them
// are folded here:
//
//   (a) masked pair, before the dW_dec product: per entry of acts,
//         dense_main = a · [a ≥ t_main]
//         dense_aux  = a · [a ≥ t_aux ∧ dead]
//       written as the two halves of one (2M, n) buffer in acts' type, so
//       dW_dec is one product [dense_main; dense_aux]ᵀ · [g_main; g_aux] of
//       depth 2M.
//   (b) route, after the product [d1; d2] = [g_main; g_aux] · W_decᵀ:
//         d_acts = ct(f32(d1)·[keep_main ∧ live] + f32(d2)·[keep_aux ∧ live])
//       with live = a > 0, bit for bit what ATen's two `where`s and add give
//       (the add in f32, rounded once to the cotangent type), plus each row
//       group's f32 column sums of the rounded d_acts; (c) sums those
//       partial sums in group order into db_enc. No atomics: two launches
//       on the same input agree bit for bit, so a replayed CUDA graph equals
//       the same steps run eagerly.
//
// Every mask is recomputed in registers from acts, the per-row thresholds
// and the dead flags; the comparisons are ATen's: acts converted to f32
// against the f32 thresholds, ties kept (≥). A row with no dead latent has
// t_aux = +inf and a silent row t_main = 0; neither needs a case of its own.
//
// What bounds it on an H100: bytes. (a) reads acts once and writes two
// copies (6 bytes an entry in bf16), (b) reads d1, d2 and acts and writes
// d_acts (8 bytes): 5.9 + 7.9 GB at 48,000 × 20,480, 1.8 + 2.4 ms at
// 3.35 TB/s. Each thread owns 16 bytes of columns (8 bf16 or 4 f32) and
// walks a group of rows, two rows' loads in flight before any store; a
// warp reads 512 contiguous bytes a row. The dead flags are read once a
// thread, the thresholds once a row (one address a warp). A width that is
// not a multiple of 16 bytes, or an unaligned base, takes the same kernels
// one element a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // rows whose loads are in flight together
// Three blocks an SM: the bf16 route fits in 80 registers a thread. At four
// rows in flight it took 149, one block an SM, and ran 30% slower.
constexpr int kMinBlocks = 3;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// (a): pair rows [0, m) dense_main, [m, 2m) dense_aux.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    topk_bwd_pair_kernel(const T* __restrict__ acts, const float* __restrict__ t_main,
                         const float* __restrict__ t_aux, const float* __restrict__ dead,
                         int m, int n, int group_rows, T* __restrict__ pair) {
  using P = Pack<T, V>;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (col >= n) return;
  bool is_dead[V];
#pragma unroll
  for (int j = 0; j < V; ++j) is_dead[j] = dead[col + j] > 0.f;
  const T zero = from_f32<T>(0.f);
  const size_t half = (size_t)m * n;
  const int r0 = blockIdx.x * group_rows;
  const int r1 = min(m, r0 + group_rows);
  for (int r = r0; r < r1; r += kUnroll) {
    P a[kUnroll];
    float tm[kUnroll], ta[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u < r1) {
        a[u] = *reinterpret_cast<const P*>(acts + (size_t)(r + u) * n + col);
        tm[u] = t_main[r + u];
        ta[u] = t_aux[r + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u < r1) {
        P main, aux;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f32(a[u].v[j]);
          main.v[j] = f >= tm[u] ? a[u].v[j] : zero;
          aux.v[j] = (f >= ta[u] && is_dead[j]) ? a[u].v[j] : zero;
        }
        const size_t at = (size_t)(r + u) * n + col;
        *reinterpret_cast<P*>(pair + at) = main;
        *reinterpret_cast<P*>(pair + half + at) = aux;
      }
    }
  }
}

// (b): d rows [0, m) d1, [m, 2m) d2 → d_acts; partials (groups, n) f32,
// row group g's column sums of the rounded d_acts.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    topk_bwd_route_kernel(const T* __restrict__ d, const T* __restrict__ acts,
                          const float* __restrict__ t_main, const float* __restrict__ t_aux,
                          const float* __restrict__ dead, int m, int n, int group_rows,
                          T* __restrict__ d_acts, float* __restrict__ partials) {
  using P = Pack<T, V>;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (col >= n) return;
  bool is_dead[V];
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    is_dead[j] = dead[col + j] > 0.f;
    acc[j] = 0.f;
  }
  const size_t half = (size_t)m * n;
  const int r0 = blockIdx.x * group_rows;
  const int r1 = min(m, r0 + group_rows);
  for (int r = r0; r < r1; r += kUnroll) {
    P a[kUnroll], d1[kUnroll], d2[kUnroll];
    float tm[kUnroll], ta[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u < r1) {
        const size_t at = (size_t)(r + u) * n + col;
        a[u] = *reinterpret_cast<const P*>(acts + at);
        d1[u] = *reinterpret_cast<const P*>(d + at);
        d2[u] = *reinterpret_cast<const P*>(d + half + at);
        tm[u] = t_main[r + u];
        ta[u] = t_aux[r + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u < r1) {
        P out;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f32(a[u].v[j]);
          const bool live = f > 0.f;
          const bool keep_main = f >= tm[u] && live;
          const bool keep_aux = f >= ta[u] && is_dead[j] && live;
          const float s = __fadd_rn(keep_main ? to_f32(d1[u].v[j]) : 0.f,
                                    keep_aux ? to_f32(d2[u].v[j]) : 0.f);
          out.v[j] = from_f32<T>(s);
          acc[j] += to_f32(out.v[j]);
        }
        *reinterpret_cast<P*>(d_acts + (size_t)(r + u) * n + col) = out;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) partials[(size_t)blockIdx.x * n + col + j] = acc[j];
}

// (c): db_enc[col] = the row groups' partial sums, added in group order.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    topk_bwd_colsum_kernel(const float* __restrict__ partials, int groups, int n,
                           float* __restrict__ out) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g) s += partials[(size_t)g * n + col];
  out[col] = s;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int groups_of(int m, int group_rows) { return (m + group_rows - 1) / group_rows; }

// 16-byte packs when the width and every base allow them, else one element
// a thread.
template <typename T>
int launch_pair(const void* acts, const float* t_main, const float* t_aux, const float* dead,
                int m, int n, int group_rows, void* pair, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool packed = n % V == 0 && aligned16(acts) && aligned16(pair);
  const int per_block = kThreads * (packed ? V : 1);
  const dim3 grid(groups_of(m, group_rows), (n + per_block - 1) / per_block);
  const T* a = static_cast<const T*>(acts);
  T* out = static_cast<T*>(pair);
  if (packed)
    topk_bwd_pair_kernel<T, V><<<grid, kThreads, 0, s>>>(a, t_main, t_aux, dead, m, n,
                                                         group_rows, out);
  else
    topk_bwd_pair_kernel<T, 1><<<grid, kThreads, 0, s>>>(a, t_main, t_aux, dead, m, n,
                                                         group_rows, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_route(const void* d, const void* acts, const float* t_main, const float* t_aux,
                 const float* dead, int m, int n, int group_rows, void* d_acts,
                 float* partials, float* db_enc, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool packed = n % V == 0 && aligned16(d) && aligned16(acts) && aligned16(d_acts);
  const int per_block = kThreads * (packed ? V : 1);
  const int groups = groups_of(m, group_rows);
  const dim3 grid(groups, (n + per_block - 1) / per_block);
  const T* dd = static_cast<const T*>(d);
  const T* a = static_cast<const T*>(acts);
  T* out = static_cast<T*>(d_acts);
  if (m > 0) {  // no rows: no partial sums, db_enc all zero
    if (packed)
      topk_bwd_route_kernel<T, V><<<grid, kThreads, 0, s>>>(dd, a, t_main, t_aux, dead, m, n,
                                                            group_rows, out, partials);
    else
      topk_bwd_route_kernel<T, 1><<<grid, kThreads, 0, s>>>(dd, a, t_main, t_aux, dead, m, n,
                                                            group_rows, out, partials);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  topk_bwd_colsum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(partials, groups,
                                                                           n, db_enc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acts (m, n) row-major, f32 (acts_f32 = 1) or bf16; t_main, t_aux (m,)
// f32; dead (n,) f32, a latent dead where > 0 → pair (2m, n) in acts' type.
// Returns cudaError_t.
int freud_topk_bwd_pair(const void* acts, int acts_f32, const float* t_main,
                        const float* t_aux, const float* dead, int m, int n, int group_rows,
                        void* pair, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0 || n == 0) return 0;
  if (acts_f32) return launch_pair<float>(acts, t_main, t_aux, dead, m, n, group_rows, pair, s);
  return launch_pair<__nv_bfloat16>(acts, t_main, t_aux, dead, m, n, group_rows, pair, s);
}

// d (2m, n) = [d1; d2] in acts' type; acts, t_main, t_aux, dead as above →
// d_acts (m, n) in acts' type, db_enc (n,) f32. Scratch: partials
// (ceil(m / group_rows), n) f32. Returns cudaError_t.
int freud_topk_bwd_route(const void* d, const void* acts, int acts_f32, const float* t_main,
                         const float* t_aux, const float* dead, int m, int n, int group_rows,
                         void* d_acts, float* partials, float* db_enc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (acts_f32)
    return launch_route<float>(d, acts, t_main, t_aux, dead, m, n, group_rows, d_acts,
                               partials, db_enc, s);
  return launch_route<__nv_bfloat16>(d, acts, t_main, t_aux, dead, m, n, group_rows, d_acts,
                                     partials, db_enc, s);
}

}  // extern "C"
