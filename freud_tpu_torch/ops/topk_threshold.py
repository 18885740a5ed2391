"""Per-row TopK thresholds and the fired mask, as a hand-written CUDA kernel
(``csrc/topk_threshold.cu``).

Replaces the Pallas TPU kernel ``freud_tpu/ops/topk_threshold.py``
(``topk_thresholds_fired`` → ``_thresholds_impl``). Per row of an (M, n_dict)
latent: ``t_main``, the k-th largest value; ``t_aux``, the k_aux-th largest
among dead columns; optionally ``t_multi``, the k_multi-th largest; and
``fired[j]``, whether any row has ``a[j] >= t_main`` and ``a[j] > 0``.

Two paths, with the JAX kernel's routing rule: bfloat16 input with
``signed=False`` and n_dict < 2¹⁵ takes the exact path (thresholds are the
exact bf16 k-th values, ordered as the bit patterns read as int16, which for
the non-negative latents it serves is value order; the kernel radix-selects,
the plain version uses ``torch.topk``); everything else takes the 26-iteration
float bisection, with thresholds equal to JAX's bit for bit. Edge rules of
the exact path: fewer than k candidates → the smallest candidate (select
all); no candidate → +inf (select nothing).

The kernel does not run the bisection's 26 counting passes: count(a ≥ mid)
≥ k holds exactly when mid ≤ v_k, the row's k-th largest entry, so it
selects v_k once (a radix select on ``order_key``) and replays the
bisection on scalars. ``replay_kth`` and ``order_key`` are those two steps
in PyTorch; the tests hold them to ``bisect_kth`` and to the kernel's key
order.

``topk_thresholds_fired`` dispatches on the device: a CUDA tensor launches
the kernel, a CPU tensor takes ``topk_thresholds_fired_plain``.
``topk_thresholds_fired.launches`` counts kernel launches; a launch captured into a
CUDA graph counts in ``.captured``, and each replay adds it to ``.launches``
(``_native.counted``, ``train/graph.py``).
"""

from __future__ import annotations

import torch

from .._native import Kernel, counted, limit

ITERS = 26  # the JAX kernel's float bisection count (topk_threshold.py:25)


def exact_path(acts: torch.Tensor, signed: bool) -> bool:
    """The JAX kernel's routing rule (topk_threshold.py:54-55)."""
    return not signed and acts.dtype == torch.bfloat16 and acts.shape[-1] < 2 ** 15


_BF16_INF_BITS = 0x7F80  # +inf: selects nothing


def _kth_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """(M, c) int32 bf16 patterns → (M, 1): the k-th largest per row; the
    smallest when c < k; +inf's pattern when c == 0."""
    m, c = bits.shape
    if c == 0:
        return torch.full((m, 1), _BF16_INF_BITS, dtype=torch.int32, device=bits.device)
    if c < k:
        return bits.amin(dim=-1, keepdim=True)
    return torch.topk(bits, k, dim=-1).values[:, -1:]


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)


def bisect_kth(masked: torch.Tensor, k: int, iters: int = ITERS) -> torch.Tensor:
    """JAX's ``_bisect`` (and ``models/sae/topk.kth_threshold``): the largest
    t found by ``iters`` halvings with count(masked ≥ t) ≥ k, in masked's
    dtype; +inf when nothing is finite."""
    inf = torch.tensor(float("inf"), dtype=masked.dtype, device=masked.device)
    lo = torch.where(torch.isfinite(masked), masked, inf).amin(dim=-1, keepdim=True)
    hi = masked.amax(dim=-1, keepdim=True)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        ok = (masked >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order key of float32 or bfloat16 values, as int64: the
    bit pattern with every bit flipped when the sign is set, else with the
    sign bit set. Keys order as the values for every non-NaN value, -0.0
    just below +0.0."""
    if x.dtype == torch.bfloat16:
        bits = x.view(torch.int16).to(torch.int64) & 0xFFFF
        sign, full = 0x8000, 0xFFFF
    elif x.dtype == torch.float32:
        bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        sign, full = 0x80000000, 0xFFFFFFFF
    else:
        raise TypeError(f"order keys are for float32 or bfloat16, got {x.dtype}")
    return torch.where((bits & sign) != 0, bits ^ full, bits | sign)


def key_value(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``order_key``'s inverse: int64 keys → values of ``dtype``."""
    sign, full = (0x8000, 0xFFFF) if dtype == torch.bfloat16 else (0x80000000, 0xFFFFFFFF)
    bits = torch.where((key & sign) != 0, key ^ sign, key ^ full)
    if dtype == torch.bfloat16:
        return bits.to(torch.int16).view(torch.bfloat16)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def replay_kth(masked: torch.Tensor, k: int, iters: int = ITERS) -> torch.Tensor:
    """``bisect_kth`` without a pass over the row per step: the k-th largest
    entry v_k (with multiplicity; none when a row has fewer than k entries)
    decides every step, since count(masked ≥ mid) ≥ k ⇔ mid ≤ v_k; lo and
    hi start as the bisection's. Bit-equal to ``bisect_kth``."""
    inf = torch.tensor(float("inf"), dtype=masked.dtype, device=masked.device)
    lo = torch.where(torch.isfinite(masked), masked, inf).amin(dim=-1, keepdim=True)
    hi = masked.amax(dim=-1, keepdim=True)
    if k <= masked.shape[-1]:
        vk = torch.topk(masked, k, dim=-1).values[..., -1:]
    else:  # count ≥ k never holds: NaN fails every comparison
        vk = torch.full_like(lo, float("nan"))
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        ok = mid <= vk
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def fired_from_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(n / 32),) int32 words, bit j % 32 of word j / 32 for column j
    → (n,) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words.unsqueeze(1) >> shifts) & 1).reshape(-1)[:n].bool()


def topk_thresholds_fired_plain(acts, dead_mask, k_main: int, k_aux: int,
                                iters: int = ITERS, k_multi: int = 0,
                                signed: bool = False):
    """Plain PyTorch version: → (t_main (M, 1) f32, t_aux (M, 1) f32,
    t_multi (M, 1) f32 or None, fired (n_dict,) bool)."""
    dead = dead_mask.to(device=acts.device, dtype=torch.bool)
    if exact_path(acts, signed):
        # the bit patterns read as int16, as JAX's integer path and the
        # kernel order them; for non-negative values that is value order
        bits = acts.view(torch.int16).to(torch.int32)
        t_main = _kth_bits(bits, k_main)
        fired = ((bits >= t_main) & (bits > 0)).any(dim=0)
        return (_bits_to_f32(t_main), _bits_to_f32(_kth_bits(bits[:, dead], k_aux)),
                _bits_to_f32(_kth_bits(bits, k_multi)) if k_multi else None, fired)
    a = acts.to(torch.float32)
    t_main = bisect_kth(a, k_main, iters)
    neg_inf = torch.tensor(float("-inf"), device=a.device)
    t_aux = bisect_kth(torch.where(dead, a, neg_inf), k_aux, iters)
    t_multi = bisect_kth(a, k_multi, iters) if k_multi else None
    fired = ((a >= t_main) & (a > 0)).any(dim=0)
    return t_main, t_aux, t_multi, fired


_THRESHOLDS = Kernel("topk_threshold", "freud_topk_thresholds", "topk thresholds kernel")


@counted(_THRESHOLDS)
def topk_thresholds_fired(acts: torch.Tensor, dead_mask: torch.Tensor,
                          k_main: int, k_aux: int, iters: int = ITERS,
                          k_multi: int = 0, signed: bool = False):
    """→ (t_main (M, 1) f32, t_aux (M, 1) f32, t_multi (M, 1) f32 or None,
    fired (n_dict,) bool) for acts (M, n_dict) bf16 or f32 and dead_mask
    (n_dict,) bool. ``k_multi`` (multi_topk's 4k) adds a third threshold in
    the same pass. The exact path assumes non-negative input (post-ReLU
    latents); pass ``signed=True`` for signed data."""
    if not acts.is_cuda:
        return topk_thresholds_fired_plain(acts, dead_mask, k_main, k_aux,
                                           iters, k_multi, signed)
    if acts.ndim != 2:
        raise ValueError(f"expected acts (M, n_dict), got {tuple(acts.shape)}")
    if acts.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"acts must be float32 or bfloat16, got {acts.dtype}")
    m, n = acts.shape
    if dead_mask.shape != (n,):
        raise ValueError(f"dead_mask must be ({n},), got {tuple(dead_mask.shape)}")
    if min(k_main, k_aux) < 1 or k_multi < 0:
        raise ValueError(f"k_main {k_main}, k_aux {k_aux} must be >= 1, k_multi >= 0")
    exact = exact_path(acts, signed)
    bf16 = acts.dtype == torch.bfloat16
    max_n = limit("topk_threshold", "freud_topk_thresholds_max_n", int(bf16), int(exact))
    if n > max_n:
        raise ValueError(f"n_dict {n} is wider than the kernel's rows ({max_n} "
                         f"for {acts.dtype})")
    acts = acts.contiguous()
    dead = dead_mask.to(device=acts.device, dtype=torch.uint8).contiguous()
    t_main = torch.empty((m, 1), dtype=torch.float32, device=acts.device)
    t_aux = torch.empty_like(t_main)
    t_multi = torch.empty_like(t_main) if k_multi else None
    words = -(-n // 32)
    fired = torch.zeros((words,), dtype=torch.int32, device=acts.device)
    dead_bits = torch.empty((words,), dtype=torch.int32, device=acts.device)
    _THRESHOLDS(acts, int(bf16), int(exact), dead, dead_bits, m, n, k_main, k_aux, k_multi,
                iters, t_main, t_aux, t_multi, fired)
    return t_main, t_aux, t_multi, fired_from_bits(fired, n)
