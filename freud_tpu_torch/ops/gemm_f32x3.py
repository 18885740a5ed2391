"""f32-grade ``y = x · Wᵀ (+ b)`` on the tensor cores in three TF32
products (``csrc/gemm_f32x3.cu``), for the f32 linears of the Whisper
encoder and the SAE encode's product.

It replaces no TPU kernel: the JAX package leaves these products to XLA,
and the port ran them on cuBLAS's f32 SIMT kernel. One TF32 product keeps
10 bits of each operand; three keep f32's precision. Each operand is split
into two TF32 limbs, ``hi = rna_tf32(v)`` and ``lo = rna_tf32(v − hi)``
(``split_limbs``: round to nearest, ties away from zero, by bit masking),
and the product sums ``x_lo·W_hiᵀ + x_hi·W_loᵀ + x_hi·W_hiᵀ``: the dropped
``x_lo·W_loᵀ`` and the rounding of ``lo`` are ≤ ~2⁻²¹ of a product, the
size of f32's own rounding. The kernel sums each 32-wide K slice (``K_SLICE``)
apart, its two correction products first, and promotes the slice's sum
into the f32 result with a round-to-nearest add, since the tensor cores'
own accumulator rounds toward zero. ``gemm_f32x3_plain`` is that recipe in
plain PyTorch; its matmuls sum each product in their own order, so it
shares the kernel's error bound, not its bits.

W's limbs are split on every call, by an elementwise pass the launcher
runs just before the product into scratch the wrapper allocates: nothing
is kept between calls, so a weight changed in any way (in place, inside a
CUDA graph's replay, which moves no version counter) is read as it is. x's
limbs are built inside the kernel from its staged f32 tile.

``linear`` routes by what it sees: CUDA f32 operands with no autograd graph
to record (collection, serving and search run under ``inference_mode`` or
``no_grad``), K a multiple of 4 (TMA's 16-byte strides) and at least one
row tile (``ROW_TILE``) take the kernel; everything else (bf16, the CPU, the
trainer's autograd products, the decoder's few-row steps, where the
split's passes over W would outweigh the product) takes ``F.linear``.
``gemm_f32x3.launches`` counts launches
(``.captured`` under CUDA graph capture; ``_native.counted``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .._native import Kernel, counted

ROW_TILE = 128  # the kernel's output tile is ROW_TILE × 128
K_SLICE = 32  # the K depth of one promoted partial sum


def _round_tf32_(v: torch.Tensor) -> torch.Tensor:
    """``v`` (contiguous f32) rounded to TF32 in place: half an ulp added to
    the magnitude's bits, the low 13 bits cleared (the card's
    ``cvt.rna.tf32.f32``: to nearest, ties away from zero)."""
    v.view(torch.int32).add_(0x1000).bitwise_and_(-0x2000)
    return v


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, kept as f32."""
    return _round_tf32_(v.clone(memory_format=torch.contiguous_format))


def split_limbs(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both contiguous: ``hi = tf32(v)``, ``lo = tf32(v − hi)``
    (``v − hi`` is exact); no temporary beyond the two limbs."""
    v = v.contiguous()
    hi = tf32_round(v)
    return hi, _round_tf32_(v - hi)


def gemm_f32x3_plain(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the recipe: the three limb products summed
    a ``K_SLICE`` at a time, corrections first, each slice's sum promoted
    into the f32 result; x (…, K), w (N, K) → (…, N) f32."""
    k = x.shape[-1]
    xh, xl = split_limbs(x.reshape(-1, k).float())
    wh, wl = split_limbs(w.float())
    y = torch.zeros((xh.shape[0], w.shape[0]), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, K_SLICE):
        s = slice(k0, k0 + K_SLICE)
        part = xl[:, s] @ wh[:, s].T + xh[:, s] @ wl[:, s].T
        y += part + xh[:, s] @ wh[:, s].T
    if bias is not None:
        y = y + bias
    return y.reshape(*x.shape[:-1], w.shape[0])


def takes_kernel(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> bool:
    """The routing rule: whether ``linear(x, w, bias)`` launches the kernel."""
    ops = (x, w) if bias is None else (x, w, bias)
    if not all(t.is_cuda and t.dtype == torch.float32 for t in ops):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return False
    k = x.shape[-1]
    return (x.ndim >= 2 and w.ndim == 2 and w.shape[1] == k and k % 4 == 0
            and x.numel() // max(k, 1) >= ROW_TILE)


def linear(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, bias)``, on the kernel where ``takes_kernel``."""
    if takes_kernel(x, w, bias):
        return gemm_f32x3(x, w, bias)
    return F.linear(x, w, bias)


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """``v`` contiguous and 16-byte aligned (TMA's and the split's float4
    loads), copied only where it is not."""
    v = v.contiguous()
    return v.clone() if v.data_ptr() % 16 else v


_GEMM = Kernel("gemm_f32x3", "freud_gemm_f32x3", "3xTF32 gemm kernel")


@counted(_GEMM)
def gemm_f32x3(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (…, K) f32 · w (N, K) f32ᵀ (+ bias (N,)) → (…, N) f32."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"x and w must be float32, got {x.dtype} and {w.dtype}")
    k = x.shape[-1]
    if w.ndim != 2 or w.shape[1] != k:
        raise ValueError(f"w must be (N, {k}), got {tuple(w.shape)}")
    n = w.shape[0]
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise ValueError(f"bias must be float32 ({n},), got {bias.dtype} {tuple(bias.shape)}")
    if not x.is_cuda:
        return gemm_f32x3_plain(x, w, bias)
    if k % 4:
        raise ValueError(f"K {k} is not a multiple of 4 (TMA's 16-byte row stride)")
    lead = x.shape[:-1]
    x2, w2 = _aligned(x.reshape(-1, k)), _aligned(w)
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y.reshape(*lead, n)
    hi, lo = torch.empty_like(w2), torch.empty_like(w2)  # the split's scratch
    if bias is not None:
        bias = bias.contiguous()
    _GEMM(x2, w2, hi, lo, bias, y, m, n, k)
    return y.reshape(*lead, n)
