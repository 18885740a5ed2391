// Per-row TopK thresholds and the fired mask over an (M, n_dict) latent, for
// Hopper (sm_90a).
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
//   * exact: bf16 input, signed=False, n_dict < 2^15 — the k-th largest of
//     the bf16 bits read as int16, exact bf16 thresholds;
//   * float: f32 input, or bf16 that is signed or n_dict >= 2^15 — the JAX
//     kernel's 26-iteration float bisection (topk_threshold.py:28-41),
//     equal to it bit for bit: one exact select of each row's k-th largest
//     value, then the bisection replayed on scalars (topk_select.cuh says
//     why that is the same). bf16 input stays 16-bit keys.
//
// What bounds it on an H100: one read of the latent, 0.92 GB in bf16 at M
// 75,000 × n_dict 6144 (0.275 ms at 3.35 TB/s), 1.84 GB in f32; in practice
// the histograms' shared-memory atomics (csrc/topk_select.cuh says how its
// design cuts them).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_select.cuh"

extern "C" {

// The widest n_dict a path takes (its rows live in registers).
int freud_topk_thresholds_max_n(int acts_bf16, int exact) {
  if (exact) return topk::max_n<topk::Bf16Bits>();
  return acts_bf16 ? topk::max_n<topk::Bf16Value>() : topk::max_n<topk::F32Value>();
}

// acts (m, n) row-major: bf16 (acts_bf16 = 1) or f32; dead (n,) uint8;
// exact = 1 takes the exact path (bf16 only), else the float path with
// `iters` bisection steps. dead_bits: ceil(n / 32) words of scratch.
// t_main, t_aux (m,) f32 and t_multi (m,) when k_multi > 0; fired: ceil(n /
// 32) words of bits, zeroed by the caller. Returns cudaError_t.
int freud_topk_thresholds(const void* acts, int acts_bf16, int exact,
                          const uint8_t* dead, uint32_t* dead_bits, int m, int n,
                          int k_main, int k_aux, int k_multi, int iters, float* t_main,
                          float* t_aux, float* t_multi, uint32_t* fired, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  topk::dead_bits_kernel<<<(n + topk::kBitsThreads - 1) / topk::kBitsThreads,
                           topk::kBitsThreads, 0, s>>>(dead, n, dead_bits);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  topk::SelectParams p{};
  p.acts = acts;
  p.dead = dead_bits;
  p.fired = fired;
  p.t[0] = t_main;
  p.t[1] = t_aux;
  p.t[2] = t_multi;
  p.k[0] = static_cast<uint32_t>(k_main);
  p.k[1] = static_cast<uint32_t>(k_aux);
  p.k[2] = static_cast<uint32_t>(k_multi);
  p.m = m;
  p.n = n;
  p.nsel = k_multi > 0 ? 3 : 2;
  p.iters = iters;
  if (exact) return topk::launch_select<topk::Bf16Bits>(p, s);
  if (acts_bf16) return topk::launch_select<topk::Bf16Value>(p, s);
  return topk::launch_select<topk::F32Value>(p, s);
}

}  // extern "C"
