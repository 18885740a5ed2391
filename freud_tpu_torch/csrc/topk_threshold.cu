// Per-row TopK thresholds and the fired mask over an (M, n_dict) latent, for
// Hopper (sm_90a): one block per row, the row staged in shared memory.
//
// Replaces the Pallas TPU kernel freud_tpu/ops/topk_threshold.py
// (topk_thresholds_fired → _thresholds_impl → _kernel). Per row: t_main, the
// k-th largest value; t_aux, the k_aux-th largest among dead columns;
// optionally t_multi, the k_multi-th largest; and fired[j] = any row with
// a[j] >= t_main and a[j] > 0 (a silent row's threshold is 0, and its zeros
// must not mark the whole dictionary fired).
//
// Two paths, chosen by the wrapper with the JAX kernel's rule
// (topk_threshold.py:54-55):
//   * exact: bf16 input, signed=False, n_dict < 2^15 — radix select on the
//     16-bit keys (csrc/topk_select.cuh); thresholds are exact bf16 values;
//   * float: f32 or signed input — the JAX kernel's 26-iteration float
//     bisection (topk_threshold.py:28-41), reproduced operation for
//     operation (lo from the finite minimum, hi the maximum, mid =
//     (lo + hi) * 0.5f, count(>= mid) >= k), so thresholds equal JAX's bit for
//     bit, not merely the selected sets.
//
// What bounds it on an H100: one read of the latent (0.9 GB bf16 at
// M 75,000, n_dict 6144) against shared-memory passes per row: 2 histogram
// passes shared by the exact thresholds (the dead mask packed to bits once
// a launch), 26 counting passes per float threshold. The
// float path is bound by those passes; the row sits in shared memory so they
// never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_select.cuh"

namespace {

using topk::kSelectThreads;
using topk::kWarps;
using topk::Scratch;

__global__ void __launch_bounds__(kSelectThreads)
exact_kernel(const uint16_t* __restrict__ acts, const uint32_t* __restrict__ dead_bits,
             int n, int k_main, int k_aux, int k_multi, float* __restrict__ t_main,
             float* __restrict__ t_aux, float* __restrict__ t_multi,
             int* __restrict__ fired) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch s;
  const uint32_t k[topk::kMaxSel] = {(uint32_t)k_main, (uint32_t)k_aux, (uint32_t)k_multi};
  float* const t[topk::kMaxSel] = {t_main, t_aux, t_multi};
  topk::select_row(acts, dead_bits, n, k_multi > 0 ? 3 : 2, k, t, fired, smem, s);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ float block_reduce_f(float v, bool is_min, Scratch& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(topk::kFull, v, off);
    v = is_min ? fminf(v, o) : fmaxf(v, o);
  }
  if ((threadIdx.x & 31) == 0) s.warp_f[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = s.warp_f[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out = is_min ? fminf(out, s.warp_f[w]) : fmaxf(out, s.warp_f[w]);
  __syncthreads();
  return out;
}

__device__ uint32_t block_count_ge(const float* vals, const uint8_t* dead,
                                   bool only_dead, int n, float t, Scratch& s) {
  uint32_t c = 0;
  for (int j = threadIdx.x; j < n; j += kSelectThreads) {
    const float v = (!only_dead || dead[j]) ? vals[j] : -INFINITY;
    c += v >= t;
  }
  c = __reduce_add_sync(topk::kFull, c);
  if ((threadIdx.x & 31) == 0) s.warp[threadIdx.x >> 5] = c;
  __syncthreads();
  uint32_t out = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) out += s.warp[w];
  __syncthreads();
  return out;
}

// JAX's _bisect on masked = dead ? a : -inf (only_dead) or a.
__device__ float bisect(const float* vals, const uint8_t* dead, bool only_dead,
                        int n, int k, int iters, Scratch& s) {
  float lo = INFINITY, hi = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kSelectThreads) {
    const float v = (!only_dead || dead[j]) ? vals[j] : -INFINITY;
    if (isfinite(v)) lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  lo = block_reduce_f(lo, true, s);
  hi = block_reduce_f(hi, false, s);
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    const bool ok = block_count_ge(vals, dead, only_dead, n, mid, s) >= (uint32_t)k;
    if (ok) lo = mid; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
float_kernel(const T* __restrict__ acts, const uint8_t* __restrict__ dead_g, int n,
             int k_main, int k_aux, int k_multi, int iters, float* __restrict__ t_main,
             float* __restrict__ t_aux, float* __restrict__ t_multi,
             int* __restrict__ fired) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* vals = reinterpret_cast<float*>(smem);
  uint8_t* dead = smem + 4 * (size_t)n;
  __shared__ Scratch s;
  const size_t row = blockIdx.x;
  for (int j = threadIdx.x; j < n; j += kSelectThreads) {
    vals[j] = load_f32(acts + row * n + j);
    dead[j] = dead_g[j] != 0;
  }
  __syncthreads();
  const float tm = bisect(vals, dead, false, n, k_main, iters, s);
  const float ta = bisect(vals, dead, true, n, k_aux, iters, s);
  if (threadIdx.x == 0) {
    t_main[row] = tm;
    t_aux[row] = ta;
  }
  if (k_multi > 0) {
    const float tu = bisect(vals, dead, false, n, k_multi, iters, s);
    if (threadIdx.x == 0) t_multi[row] = tu;
  }
  for (int j = threadIdx.x; j < n; j += kSelectThreads) {
    const float v = vals[j];
    if (v >= tm && v > 0.f) fired[j] = 1;
  }
}

template <typename K>
int prepare(K kernel, size_t smem_bytes) {
  if (smem_bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes));
  return 0;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a row takes: the exact path's keys and
// dead bits, or the float path's values and dead mask.
size_t freud_topk_thresholds_smem(int n, int exact) {
  return exact ? topk::row_smem_bytes(n) : 5 * (size_t)n;
}

// acts (m, n) row-major: bf16 (dtype 1) or f32 (dtype 0); dead (n,) uint8;
// exact = 1 takes the radix path (bf16 only), with dead_bits scratch of
// ceil(n / 32) words. t_main, t_aux (m,) f32 and t_multi (m,) when
// k_multi > 0; fired (n,) int32, zeroed by the caller. Returns cudaError_t.
int freud_topk_thresholds(const void* acts, int acts_bf16, int exact,
                          const uint8_t* dead, uint32_t* dead_bits, int m, int n,
                          int k_main, int k_aux, int k_multi, int iters, float* t_main,
                          float* t_aux, float* t_multi, int* fired, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (exact) {
    const size_t smem = freud_topk_thresholds_smem(n, 1);
    int err = prepare(exact_kernel, smem);
    if (err) return err;
    topk::dead_bits_kernel<<<(n + kSelectThreads - 1) / kSelectThreads, kSelectThreads, 0,
                             s>>>(dead, n, dead_bits);
    exact_kernel<<<m, kSelectThreads, smem, s>>>(
        static_cast<const uint16_t*>(acts), dead_bits, n, k_main, k_aux, k_multi, t_main,
        t_aux, t_multi, fired);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = freud_topk_thresholds_smem(n, 0);
  if (acts_bf16) {
    int err = prepare(float_kernel<__nv_bfloat16>, smem);
    if (err) return err;
    float_kernel<__nv_bfloat16><<<m, kSelectThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(acts), dead, n, k_main, k_aux, k_multi,
        iters, t_main, t_aux, t_multi, fired);
  } else {
    int err = prepare(float_kernel<float>, smem);
    if (err) return err;
    float_kernel<float><<<m, kSelectThreads, smem, s>>>(
        static_cast<const float*>(acts), dead, n, k_main, k_aux, k_multi, iters,
        t_main, t_aux, t_multi, fired);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
