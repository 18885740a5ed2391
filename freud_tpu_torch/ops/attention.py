"""Whisper encoder self-attention as hand-written CUDA kernels
(``csrc/attention.cu``), in two entry points that share one attention phase:

* ``fused_qkv_attention(x, wq, bq, wk, wv, bv, heads)`` replaces the Pallas
  TPU kernel ``fused_qkv_attention`` / ``_qkv_attn_kernel`` of
  ``freud_tpu/ops/attention.py``: the q/k/v projections fused in, weights in
  the JAX (d_in, d_out) layout; the caller applies the output projection.
  The encoders with d ≤ 768 take it.
* ``whisper_attention(q, k, v, matmul_dtype=None, block_q=512, stable=True)``
  replaces the Pallas TPU kernel ``whisper_attention`` / ``_kernel``:
  softmax(q·kᵀ·dh^-½)·v over (b, h, s, dh) q/k/v that were projected
  outside. The medium and large encoders (d > 768) take it.

On an H100 the work is bf16 tensor-core products (``wgmma``) with f32
accumulation and f32 softmax statistics, and the design keeps the (s × s)
scores out of device memory (header of ``csrc/attention.cu``): one block per
128 query rows, a producer warp streaming 128-key K/V tiles by TMA through a
ring of shared-memory stages, two consumer warpgroups with an online max and
sum, one normalisation of the output at the end. The fused entry first packs
the three weights to one bf16 matrix (and rounds f32 x to bf16) and runs the
q/k/v projection as a ``wgmma`` GEMM fed by TMA into bf16 scratch; the
whisper entry first rounds f32 input to bf16 scratch (TMA copies bytes as
they are).

Precision: the kernels' matmuls take bf16 operands for BOTH input dtypes,
as the TPU kernels did on the TPU (``freud_tpu/models/whisper/model.py:194-205``,
``freud_tpu/ops/attention.py:87-88``), so on CUDA the f32 collection path
runs attention at bf16 precision (~0.4% relative, bounded by 2e-2 of the
output's max in the tests). The plain versions are f32 math throughout by
default, like the JAX CPU paths, and the CPU path runs them so; with
``matmul_dtype=torch.bfloat16`` they round where the kernels do (the tests
and ``chip_smoke.py`` hold the kernels to that too).

Each wrapper dispatches on the device: a CUDA tensor launches the kernel
(head_dim 64 — every Whisper size), a CPU tensor takes the plain version.
``fused_qkv_attention.launches`` and ``whisper_attention.launches`` count
kernel launches (``_native.counted``).
"""

from __future__ import annotations

import torch

from .._native import Kernel, counted

HEAD_DIM = 64  # the kernel's head_dim (csrc/attention.cu kHeadDim)
FUSED_MAX_D = 768  # the fused kernel's widest d (csrc/attention.cu kMaxFusedD)
_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y and .z (heads, clips)

# The fused kernel against fused_qkv_attention_plain(..., matmul_dtype=bf16),
# max |Δ| / max |ref|, by x's dtype: the two differ by the order of f32 sums,
# which flips a few bf16 roundings of q, k, v and P (measured up to 1.8e-3
# for f32 x on an H100); bf16 x also rounds the output to bf16, up to 2^-8
# of max on top (measured up to 3.0e-3). The card tests and chip_smoke.py
# hold the kernel to it.
ATTN_BF16_GATE = {torch.float32: 3e-3, torch.bfloat16: 6e-3}


def fused_qkv_attention_plain(x, wq, bq, wk, wv, bv, heads: int,
                              matmul_dtype=None) -> torch.Tensor:
    """Per head softmax(q·kᵀ·dh^-½)·v, heads concatenated; f32 sums.

    ``matmul_dtype`` None is f32 throughout. ``torch.bfloat16`` rounds
    exactly where the kernels' contract does: x and the weights before the
    projections, q = bf16((x·Wq + bq)·dh^-½), k = bf16(x·Wk), v = bf16(x·Wv
    + bv) after them, and the probabilities before P·V (the attention part
    is ``whisper_attention_plain``'s)."""
    b, s, d = x.shape
    f32 = torch.float32

    def rounded(t):
        t = t.to(f32)
        return t if matmul_dtype is None else t.to(matmul_dtype).to(f32)

    xf = rounded(x)
    q = xf @ rounded(wq) + bq.to(f32)
    k = xf @ rounded(wk)
    v = xf @ rounded(wv) + bv.to(f32)

    def split(t):
        return t.reshape(b, s, heads, d // heads).transpose(1, 2)

    out = whisper_attention_plain(split(q), split(k), split(v), matmul_dtype)
    return out.transpose(1, 2).reshape(b, s, d).to(x.dtype)


_QKV = Kernel("attention", "freud_qkv_attention", "fused qkv attention kernel")
_WHISPER = Kernel("attention", "freud_whisper_attention", "whisper attention kernel")


@counted(_QKV)
def fused_qkv_attention(
    x: torch.Tensor,    # (b, s, d) — post-LN block input
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    heads: int,
) -> torch.Tensor:
    """(b, s, d) → (b, s, d) in x's dtype: multi-head self-attention with the
    projections fused in (k has no bias). Weights are (d_in, d_out)."""
    if not x.is_cuda:
        return fused_qkv_attention_plain(x, wq, bq, wk, wv, bv, heads)
    if x.ndim != 3:
        raise ValueError(f"expected x (b, s, d), got {tuple(x.shape)}")
    b, s, d = x.shape
    if d != heads * HEAD_DIM or d > FUSED_MAX_D:
        raise ValueError(f"the CUDA kernel needs head_dim {HEAD_DIM} and d ≤ "
                         f"{FUSED_MAX_D}: d {d}, heads {heads}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        if w.shape != (d, d):
            raise ValueError(f"{name} must be ({d}, {d}), got {tuple(w.shape)}")
    for name, bias in (("bq", bq), ("bv", bv)):
        if bias.shape != (d,):
            raise ValueError(f"{name} must be ({d},), got {tuple(bias.shape)}")
    for t in (wq, bq, wk, wv, bv):
        if t.device != x.device:
            raise ValueError(f"parameters must be on {x.device}, got {t.device}")
    if x.data_ptr() % 16:
        raise ValueError("x is not 16-byte aligned")
    if -(-b * s // 128) * heads >= 2 ** 31:
        raise ValueError(f"b·s {b * s} at {heads} heads exceeds the projection "
                         "kernel's grid (2³¹ − 1 tiles of 128 rows × 192 "
                         "columns); split the batch")
    # the weights as f32 (d_in, d_out) views in any layout: the kernel packs
    # [Wq | Wk | Wv] to bf16 itself, on every call
    ws = [w.to(torch.float32) for w in (wq, wk, wv)]
    bq32 = bq.to(torch.float32).contiguous()
    bv32 = bv.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if b * s == 0:
        return out
    # q, k, v planes (3, b, s, d), the packed weight (3d, d), bf16 x (f32 x)
    planes = 3 if x.dtype == torch.bfloat16 else 4
    scratch = torch.empty((planes * b * s * d + 3 * d * d,), dtype=torch.bfloat16,
                          device=x.device)
    _QKV(x, int(x.dtype == torch.bfloat16), *ws, [st for w in ws for st in w.stride()],
         bq32, bv32, scratch, out, b, s, d, heads, float(HEAD_DIM ** -0.5))
    return out


def whisper_attention_plain(q, k, v, matmul_dtype=None, stable: bool = True) -> torch.Tensor:
    """softmax(q·kᵀ·dh^-½)·v over (b, h, s, dh), in f32, output in q's dtype.

    ``matmul_dtype`` (e.g. bf16) rounds the operands of the two products as
    the TPU kernel does — q·dh^-½ after the scale in f32, k, v, and the
    probabilities before p·v — with f32 sums; ``None`` is f32 throughout.
    ``stable=False`` drops the max-subtraction (valid when |scores| is
    known bounded)."""
    f32 = torch.float32
    scale = q.shape[-1] ** -0.5

    def rounded(t):
        return t if matmul_dtype is None else t.to(matmul_dtype).to(f32)

    qs = rounded(q.to(f32) * scale)
    scores = qs @ rounded(k.to(f32)).transpose(-1, -2)
    if stable:
        scores = scores - scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores)
    out = (rounded(p) @ rounded(v.to(f32))) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def _check_head_view(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.shape != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    # TMA (bf16) and the f32 rounding pass read 16-byte chunks of 8
    # elements: head_dim contiguous, strides in multiples of 8, a 16-byte
    # aligned base; row offsets are 32-bit
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]):
        raise ValueError(f"{name} needs head_dim contiguous and strides in "
                         f"multiples of 8, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
    if t.shape[2] * t.stride(2) >= 2 ** 31:
        raise ValueError(f"{name}: s {t.shape[2]} × row stride {t.stride(2)} "
                         "exceeds the kernel's 32-bit offsets")


@counted(_WHISPER)
def whisper_attention(
    q: torch.Tensor,   # (b, h, s, dh) — any strides with dh contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    matmul_dtype=None,
    block_q: int = 512,
    stable: bool = True,
) -> torch.Tensor:
    """(b, h, s, dh) q/k/v → (b, h, s, dh) in q's dtype:
    softmax((q·kᵀ)·dh^-½)·v, with JAX's signature.

    A CUDA tensor launches the kernel, whose products are bf16 with f32 sums
    (``matmul_dtype`` None or bfloat16; any other raises ``ValueError``, the
    kernel being bf16-only). Its output is a (b, h, s, dh) view of a
    (b, s, h, dh) buffer, so merging the heads back to (b, s, h·dh) is free.
    A CPU tensor takes the plain version, with the products in
    ``matmul_dtype`` or, when it is None, in the input dtype — JAX's default
    off the TPU. ``block_q`` is accepted for the signature: the CUDA kernel's
    tiles are its own (128 query rows, 128-key K/V tiles). ``stable=False``
    drops the softmax max-subtraction (valid when |scores| is known
    bounded)."""
    if not q.is_cuda:
        mm = q.dtype if matmul_dtype is None else matmul_dtype
        return whisper_attention_plain(q, k, v, None if mm == torch.float32 else mm,
                                       stable)
    if matmul_dtype not in (None, torch.bfloat16):
        raise ValueError(f"the CUDA kernel computes its products in bfloat16, "
                         f"not {matmul_dtype}")
    if q.ndim != 4:
        raise ValueError(f"expected q (b, h, s, dh), got {tuple(q.shape)}")
    b, h, s, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"the CUDA kernel needs head_dim {HEAD_DIM}, got {dh}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_head_view(name, t, q.shape, q.dtype, q.device)
    if b > _MAX_GRID_Y or h > _MAX_GRID_Y:
        raise ValueError(f"b {b}, heads {h} exceed the kernel's grid "
                         f"({_MAX_GRID_Y} clips, {_MAX_GRID_Y} heads); split "
                         "the batch")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if b * h * s == 0:
        return out
    # f32 input is rounded to bf16 (b, h, s, dh) scratch before the TMA loads
    scratch = (None if q.dtype == torch.bfloat16 else
               torch.empty((3, b, h, s, dh), dtype=torch.bfloat16, device=q.device))
    _WHISPER(q, k, v, out, int(q.dtype == torch.bfloat16), b, h, s,
             [st for t in (q, k, v, out) for st in t.stride()[:3]], float(dh ** -0.5),
             int(stable), scratch)
    return out
