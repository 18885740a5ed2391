"""The SAE encode's top-k: each row's k largest values in descending order,
ties to the lower column, and their columns as int64 (``csrc/topk_indexed.cu``).

``topk_indexed(latents, k)`` on a CUDA tensor is bit for bit
``topk_indexed_plain`` on it, a stable descending ``torch.sort`` cut to k,
which is what the port's ``models/sae/topk.py::select_topk`` computed
before this kernel (the JAX package's ``lax.top_k`` order). With ``bias``
both select from ``relu(latents + bias)``: the encode passes its product
``(x − b_dec) · W_encᵀ`` and ``encoder_bias``, and the kernel forms the sum
and the ReLU in its load, rounded as the separate add and ``torch.relu``
round them on the card.

The comparisons of ``torch.sort`` on the card, which the kernel's keys
reproduce: IEEE order, except that ``-0.0`` and ``+0.0`` are equal (their
columns decide); a NaN sorts by its bits (sign clear: above ``+inf``; sign
set: below ``-inf``). The CPU's sort differs on NaN alone (every NaN on
top, NaNs tied): a CPU tensor takes that sort. The values returned are the
row's own elements, ``-0.0`` and each NaN's bits included.

A row wider than the kernel's widest segment (``MAX_N``) is split into
``segments(n, dtype)`` equal column segments, each selected apart, and the
segments' k pairs merged by a second launch: one algorithm whose segment
count comes from the width alone.

The wrapper dispatches on the device: a CUDA tensor launches the kernel (or
raises on a shape or type it does not take), a CPU tensor takes the plain
version. ``topk_indexed.launches`` counts calls that launched
(``.captured`` under CUDA graph capture; ``_native.counted``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._native import Kernel, counted

K_MAX = 256  # the largest k the kernel takes
# the widest segment a launch takes, in columns (csrc/topk_indexed.cu
# max_n: 7 chunks of 16 bytes a thread at 1024 threads)
MAX_N = {torch.float32: 28_672, torch.bfloat16: 57_344}
MAX_ITEMS = 1024  # segments · k that one merge block holds


def segments(n: int, dtype: torch.dtype) -> int:
    """How many equal column segments a row of n columns is selected in:
    the fewest that divide n with each at most ``MAX_N[dtype]`` wide."""
    widest = MAX_N[dtype]
    for parts in range(1, MAX_ITEMS + 1):
        if n % parts == 0 and n // parts <= widest:
            return parts
    raise ValueError(f"a row of {n} columns has no split into equal segments of at most "
                     f"{widest} ({dtype})")


def _check(latents: torch.Tensor, k: int, bias: Optional[torch.Tensor]) -> None:
    if latents.ndim < 1:
        raise ValueError("latents need a last (latent) axis, got a 0-dim tensor")
    if latents.dtype not in MAX_N:
        raise TypeError(f"latents must be float32 or bfloat16, got {latents.dtype}")
    n = latents.shape[-1]
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k {k} outside [1, {K_MAX}]")
    if k > n:
        raise ValueError(f"k {k} above the row's {n} columns")
    if bias is not None:
        if latents.dtype != torch.float32 or bias.dtype != torch.float32:
            raise TypeError("the fused bias and ReLU take float32 latents and bias, got "
                            f"{latents.dtype} and {bias.dtype}")
        if bias.shape != (n,):
            raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")


def topk_indexed_plain(latents: torch.Tensor, k: int, bias: Optional[torch.Tensor] = None):
    """Plain PyTorch version: → (values (…, k), indices (…, k) int64)."""
    if bias is not None:
        latents = torch.relu(latents + bias)
    vals, idx = torch.sort(latents, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


_INDEXED = Kernel("topk_indexed", "freud_topk_indexed", "indexed topk kernel")


@counted(_INDEXED)
def topk_indexed(latents: torch.Tensor, k: int, bias: Optional[torch.Tensor] = None):
    """(values (…, k) in latents' type, indices (…, k) int64) of each row of
    ``latents`` (…, n) f32 or bf16, or of ``relu(latents + bias)`` with a
    ``bias`` (n,) (f32 only)."""
    _check(latents, k, bias)
    if not latents.is_cuda:
        return topk_indexed_plain(latents, k, bias)
    n = latents.shape[-1]
    lead = latents.shape[:-1]
    x = latents.reshape(-1, n).contiguous()
    m = x.shape[0]
    if m == 0:
        return topk_indexed_plain(latents, k, bias)
    parts = segments(n, x.dtype)
    if parts * k > MAX_ITEMS:
        raise ValueError(f"{parts} segments of k {k} exceed the merge's {MAX_ITEMS} pairs")
    dev = x.device
    vals = torch.empty((m, k), dtype=x.dtype, device=dev)
    idx = torch.empty((m, k), dtype=torch.int64, device=dev)
    seg_raw = seg_idx = None
    if parts > 1:
        seg_raw = torch.empty((m * parts, k), dtype=torch.int32, device=dev)
        seg_idx = torch.empty((m * parts, k), dtype=torch.int32, device=dev)
    if bias is not None:
        bias = bias.to(dev).contiguous()
    _INDEXED(x, int(x.dtype == torch.bfloat16), bias, m, n, k, parts, vals, idx, seg_raw,
             seg_idx)
    return vals.reshape(*lead, k), idx.reshape(*lead, k)
