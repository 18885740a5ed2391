// TopK-SAE training forward for Hopper (sm_90a): encode GEMM, then per-row
// exact thresholds, fired mask and both masked decodes.
//
// Replaces the Pallas TPU kernel freud_tpu/ops/topk_fused.py
// (topk_sae_forward → _forward_impl → _kernel):
//   acts   = relu(bf16(bf16(x − b_dec) · W_encᵀ) + bf16(b_enc))   (M, n_dict) bf16
//   t_main = the k-th largest of each acts row; t_aux = the k_aux-th largest
//            among dead columns (edge rules in csrc/topk_select.cuh)
//   y_main = Σ_{acts ≥ t_main} acts · W_dec,  y_aux = Σ_{dead, acts ≥ t_aux}
//            acts · W_dec   (M, d_in) f32, b_dec excluded
//   fired  = any valid row with acts ≥ t_main and acts > 0
//
// What bounds it on an H100: at tiny_topk (M 75,000, d_in 384, n_dict 6144)
// the encode is 354 GFLOP of bf16 tensor-core work and writes 0.92 GB of
// acts; the selection reads them back once; the decode is a gather of the
// selected W_dec rows (at most (k + k_aux) · d_in MACs per row, ~13 GFLOP)
// from the 4.7 MB bf16 W_dec, which sits in L2. The TPU kernel decoded with
// two dense (M, n_dict) · (n_dict, d_in) products (708 GFLOP) because its MXU
// wants dense operands; gathering is 50× less work here.
//
// Design (the simple form; wgmma/TMA and a pipelined encode are later work):
//   (a) encode_kernel: 128 × 128 output tiles, 8 warps of 64 × 32, bf16
//       mma.sync m16n8k16 with f32 accumulation over the full d_in. The
//       prologue rounds x − b_dec to bf16 as it stages the A tile; the
//       epilogue rounds to bf16, adds the bf16 bias with bf16 rounding and
//       applies ReLU — the TPU kernel's rounding order
//       (topk_fused.py:298-302).
//   (b) select_decode_kernel: one block per row. The row's keys and the dead
//       mask go to shared memory; radix select finds both exact thresholds;
//       one ordered pass (warp ballots + a block scan) sets fired and
//       compacts the selected positive columns into one index list with two
//       flag bits (main, aux); threads then own column pairs of the output
//       and walk the list, accumulating both decodes in f32 in list order
//       (deterministic). The list holds up to n_dict entries: ties, a row
//       whose t_main is 0, or "select all dead" never overflow it.

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

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kBKPad = kBK + 8;  // 80-byte rows: conflict-free fragment loads

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// relu(bf16(bf16(z) + b)), b already bf16
__device__ __forceinline__ __nv_bfloat16 act_of(float z, float b) {
  const float zb = __bfloat162float(__float2bfloat16_rn(z));
  const float s = __bfloat162float(__float2bfloat16_rn(zb + b));
  return __float2bfloat16_rn(s > 0.f ? s : 0.f);
}

// ---------------------------------------------------------------- phase (a)
// x (m, d) f32, b_dec (d,) f32, w (n, d) bf16 (the encoder weight, torch
// Linear layout), b_enc (n,) bf16 → acts (m, n) bf16. d % 32 == 0, n even.
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, const float* __restrict__ b_dec,
              const __nv_bfloat16* __restrict__ w,
              const __nv_bfloat16* __restrict__ b_enc,
              __nv_bfloat16* __restrict__ acts, int m_rows, int n, int d) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kBKPad];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN][kBKPad];  // [col][k]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / 4;  // 2 warp rows of 64
  const int wn = warp % 4;  // 4 warp columns of 32
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // A: 128 × 32 f32 → bf16(x − b_dec), four float4 per thread
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = (tid + it * kThreads) * 4;
      const int r = idx / kBK;
      const int c = idx % kBK;
      const int m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < m_rows) {
        const float4 xv = *reinterpret_cast<const float4*>(x + (size_t)m * d + k0 + c);
        const float4 bv = *reinterpret_cast<const float4*>(b_dec + k0 + c);
        v = make_float4(xv.x - bv.x, xv.y - bv.y, xv.z - bv.z, xv.w - bv.w);
      }
      *reinterpret_cast<__nv_bfloat162*>(&As[r][c]) = __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162*>(&As[r][c + 2]) = __floats2bfloat162_rn(v.z, v.w);
    }
    // B: 128 rows of W_enc × 32 k, two 16-byte loads per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = (tid + it * kThreads) * 8;
      const int r = idx / kBK;
      const int c = idx % kBK;
      const int nn = n0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (nn < n) v = *reinterpret_cast<const uint4*>(w + (size_t)nn * d + k0 + c);
      *reinterpret_cast<uint4*>(&Bs[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        a[mt][0] = load_pair(&As[r][ks + 2 * t]);
        a[mt][1] = load_pair(&As[r + 8][ks + 2 * t]);
        a[mt][2] = load_pair(&As[r][ks + 2 * t + 8]);
        a[mt][3] = load_pair(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        uint32_t b[2];
        b[0] = load_pair(&Bs[c][ks + 2 * t]);
        b[1] = load_pair(&Bs[c][ks + 2 * t + 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_16816(acc[mt][nt], a[mt], b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * t;
    if (col >= n) continue;
    const float b0 = __bfloat162float(b_enc[col]);
    const float b1 = __bfloat162float(b_enc[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (row >= m_rows) continue;
        __nv_bfloat162 out;
        out.x = act_of(acc[mt][nt][2 * h], b0);
        out.y = act_of(acc[mt][nt][2 * h + 1], b1);
        *reinterpret_cast<__nv_bfloat162*>(acts + (size_t)row * n + col) = out;
      }
    }
  }
}

// ---------------------------------------------------------------- phase (b)
// One block per row of acts (m, n) bf16; w_dec (n, d) bf16; dead (n,) uint8.
// → y_main, y_aux (m, d) f32; t_main, t_aux (m,) f32; fired (n,) int32
// (zeroed by the caller). d even.
__global__ void __launch_bounds__(kSelectThreads)
select_decode_kernel(const uint16_t* __restrict__ acts,
                     const __nv_bfloat16* __restrict__ w_dec,
                     const uint8_t* __restrict__ dead_g, int n, int d, int k,
                     int k_aux, float* __restrict__ y_main, float* __restrict__ y_aux,
                     float* __restrict__ t_main, float* __restrict__ t_aux,
                     int* __restrict__ fired) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* list = reinterpret_cast<uint32_t*>(smem);      // n entries
  uint16_t* keys = reinterpret_cast<uint16_t*>(list + n);  // n keys
  uint8_t* dead = reinterpret_cast<uint8_t*>(keys) + ((2 * (size_t)n + 15) & ~(size_t)15);
  __shared__ Scratch s;
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const uint32_t n_dead = topk::load_row(acts + row * n, dead_g, n, keys, dead, s);
  __syncthreads();
  const uint32_t ks[2] = {(uint32_t)k, (uint32_t)k_aux};
  const bool only_dead[2] = {false, true};
  uint32_t t[2];
  topk::select_many(keys, dead, n, 2, ks, only_dead, n_dead, t, s);
  const uint32_t km = t[0], ka = t[1];
  if (tid == 0) {
    t_main[row] = topk::key_to_float(km);
    t_aux[row] = topk::key_to_float(ka);
  }

  // ordered compaction of the selected positive columns: j | flags << 30
  // (zeros are left out: they add nothing to either decode)
  uint32_t total = 0;
  for (int base = 0; base < n; base += kSelectThreads) {
    const int j = base + tid;
    uint32_t flags = 0;
    if (j < n) {
      const uint32_t key = keys[j];
      if (topk::key_positive(key)) {
        flags = (key >= km ? 1u : 0u) | (dead[j] && key >= ka ? 2u : 0u);
        if (flags & 1u) fired[j] = 1;  // OR into the mask: every writer stores 1
      }
    }
    const uint32_t ballot = __ballot_sync(topk::kFull, flags != 0);
    if (lane == 0) s.warp[warp] = __popc(ballot);
    __syncthreads();
    uint32_t before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s.warp[w] : 0u;
      chunk += s.warp[w];
    }
    if (flags)
      list[total + before + __popc(ballot & ((1u << lane) - 1u))] = (uint32_t)j | (flags << 30);
    total += chunk;
    __syncthreads();
  }

  // gather decode: thread owns output columns 2p, 2p + 1
  const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(w_dec);
  const int pairs = d / 2;
  for (int p = tid; p < pairs; p += kSelectThreads) {
    float m0 = 0.f, m1 = 0.f, a0 = 0.f, a1 = 0.f;
    for (uint32_t i = 0; i < total; ++i) {
      const uint32_t e = list[i];
      const uint32_t j = e & 0x3FFFFFFFu;
      const float a = topk::key_to_float(keys[j]);
      const float2 wf = __bfloat1622float2(w2[(size_t)j * pairs + p]);
      const float am = (e >> 30) & 1u ? a : 0.f;
      const float aa = (e >> 31) ? a : 0.f;
      m0 = fmaf(am, wf.x, m0);
      m1 = fmaf(am, wf.y, m1);
      a0 = fmaf(aa, wf.x, a0);
      a1 = fmaf(aa, wf.y, a1);
    }
    *reinterpret_cast<float2*>(y_main + row * d + 2 * p) = make_float2(m0, m1);
    *reinterpret_cast<float2*>(y_aux + row * d + 2 * p) = make_float2(a0, a1);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the select/decode phase needs for n_dict n.
size_t freud_topk_fused_smem(int n) {
  return 4 * (size_t)n + ((2 * (size_t)n + 15) & ~(size_t)15) + n;
}

// x (m, d) f32; b_dec (d,) f32; w_enc (n, d) bf16; b_enc (n,) bf16;
// w_dec (n, d) bf16; dead (n,) uint8 → acts (m, n) bf16; y_main, y_aux (m, d)
// f32; t_main, t_aux (m,) f32; fired (n,) int32 zeroed by the caller.
// d % 32 == 0, n even. Returns cudaError_t.
int freud_topk_sae_forward(const float* x, const float* b_dec, const void* w_enc,
                           const void* b_enc, const void* w_dec, const uint8_t* dead,
                           int m, int n, int d, int k, int k_aux, void* acts,
                           float* y_main, float* y_aux, float* t_main, float* t_aux,
                           int* fired, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  encode_kernel<<<grid, kThreads, 0, s>>>(
      x, b_dec, static_cast<const __nv_bfloat16*>(w_enc),
      static_cast<const __nv_bfloat16*>(b_enc), static_cast<__nv_bfloat16*>(acts), m, n,
      d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = freud_topk_fused_smem(n);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(select_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_decode_kernel<<<m, kSelectThreads, smem, s>>>(
      static_cast<const uint16_t*>(acts), static_cast<const __nv_bfloat16*>(w_dec), dead,
      n, d, k, k_aux, y_main, y_aux, t_main, t_aux, fired);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
