"""Per-row TopK thresholds across dictionary shards: kernel #3's selection
when each model rank holds ``n_dict / P`` columns of the latent
(``csrc/topk_sharded.cu``).

Replaces, on a dictionary split over the mesh's model axis, the Pallas TPU
kernel ``freud_tpu/ops/topk_threshold.py`` (``topk_thresholds_fired``), for
which XLA gathers the whole ``(M, n_dict)`` latent. Here the latent stays
where it is and ``sharded_thresholds_fired`` runs three steps:

1. ``shard_candidates`` (one launch of kernel #3's selection core,
   ``csrc/topk_select.cuh``, with its candidates epilogue) on this rank's
   ``(M, n_s)`` shard: a row of ``min(k_sel, n_s)`` top order keys
   (``k_sel`` = max(k, k_multi)), ``k_aux`` slots for the top
   ``min(k_aux, d_s)`` keys among the shard's ``d_s`` dead columns, and a
   header: the smallest finite and the largest key, of all columns and of
   the dead ones, and ``d_s`` (``candidate_width``). The keys are
   ``order_key``'s on the float path and the bf16 bits read as int16
   (offset to unsigned) on the exact path; within a region their order is
   the kernel's own (the combine reads multisets);
2. one all-gather of those rows over the model group
   (``parallel.mesh.model_all_gather``, bit-exact): O(M · P · (k_sel +
   k_aux)) words, not O(M · n_dict);
3. ``combine_shard_thresholds`` (one launch, one warp a row) on the
   gathered keys: t_main, t_aux and t_multi with ``topk_thresholds_fired``'s
   rules, bit for bit, and ``fired`` for this rank's columns. Every model
   rank computes the same thresholds from the same bytes.

The traps: the float path replays the 26-step bisection from the row's
GLOBAL finite min and max (the headers'), never from the candidates alone;
the route (exact or float) and the edge rules read the GLOBAL ``n_dict``
and dead count, never a shard's; a shard may have no dead column, and the
whole row fewer dead ones than ``k_aux``; a silent row's threshold is 0
and its zeros never fire; tied keys are values, so however ties split over
shards the k-th value is the same.

Each wrapper dispatches on the device: a CUDA tensor launches its kernel,
a CPU tensor takes its ``*_plain`` version (``torch.topk`` on the keys, then
``replay_kth``'s scalar replay). ``shard_candidates.launches`` and
``combine_shard_thresholds.launches`` count kernel launches (``.captured``
under CUDA graph capture, as ``train/graph.py`` reads them; ``_native.counted``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._native import Kernel, counted, limit
from ..parallel import mesh as mesh_lib
from .topk_threshold import ITERS, fired_from_bits, key_value, order_key

HEADER = 5  # lo_all, hi_all, lo_dead, hi_dead, d_s
_NONE = 0xFFFFFFFF  # "no finite key" (a min over nothing)
# key kinds: the exact path's bf16 bits, bf16 values, f32 values
EXACT, BF16, F32 = 0, 1, 2
# the kinds' finite keys lie strictly between these (topk_select.cuh)
_FINITE = {EXACT: (0, 0x10000), BF16: (0x007F, 0xFF80), F32: (0x007FFFFF, 0xFF800000)}
_INF_KEY = 0xFF80  # the exact path's +inf: selects nothing


def key_kind(acts: torch.Tensor, n_dict: int, signed: bool = False) -> int:
    """The route, by the GLOBAL ``n_dict``: kernel #3's rule
    (``topk_threshold.exact_path``) read on the whole row, not the shard."""
    if acts.dtype == torch.bfloat16:
        return EXACT if (not signed and n_dict < 2 ** 15) else BF16
    if acts.dtype == torch.float32:
        return F32
    raise TypeError(f"acts must be float32 or bfloat16, got {acts.dtype}")


def candidate_width(n_local: int, k_sel: int, k_aux: int) -> int:
    """Words a candidates row holds."""
    return min(k_sel, n_local) + k_aux + HEADER


def keys_of(acts: torch.Tensor, kind: int) -> torch.Tensor:
    """Order keys as int64 in [0, 2³²)."""
    if kind == EXACT:
        return (acts.view(torch.int16).to(torch.int64) & 0xFFFF) ^ 0x8000
    return order_key(acts)


def values_of(keys: torch.Tensor, kind: int) -> torch.Tensor:
    """Keys (int64) → the f32 values they stand for."""
    if kind == EXACT:
        bits = (keys ^ 0x8000) & 0xFFFF
        return bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)
    return key_value(keys, torch.bfloat16 if kind == BF16 else torch.float32).to(torch.float32)


def _as_words(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2³²) → int32 words of the same bits."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)


def _from_words(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & 0xFFFFFFFF


def shard_candidates_plain(acts: torch.Tensor, dead: torch.Tensor, k_sel: int, k_aux: int,
                           kind: int) -> torch.Tensor:
    """Plain PyTorch version: → (M, ``candidate_width``) int32."""
    keys = keys_of(acts, kind)
    m, n = keys.shape
    dead = dead.to(device=acts.device, dtype=torch.bool)
    c_main = min(k_sel, n)
    main = torch.topk(keys, c_main, dim=-1).values
    dk = keys[:, dead]
    d_s = dk.shape[1]
    aux = keys.new_zeros((m, k_aux))
    a = min(k_aux, d_s)
    if a:
        aux[:, :a] = torch.topk(dk, a, dim=-1).values
    lo, hi = _FINITE[kind]
    none = torch.full((m,), _NONE, dtype=torch.int64, device=keys.device)

    def lo_of(k):
        if k.shape[1] == 0:
            return none
        return torch.where((k > lo) & (k < hi), k, _NONE).amin(dim=-1)

    hi_dead = dk.amax(dim=-1) if d_s else torch.zeros_like(none)
    header = torch.stack([lo_of(keys), keys.amax(dim=-1), lo_of(dk), hi_dead,
                          torch.full_like(none, d_s)], dim=-1)
    return _as_words(torch.cat([main, aux, header], dim=-1))


_CANDIDATES = Kernel("topk_sharded", "freud_shard_candidates",
                     "sharded topk candidates kernel")
_COMBINE = Kernel("topk_sharded", "freud_shard_combine", "sharded topk combine kernel")


@counted(_CANDIDATES)
def shard_candidates(acts: torch.Tensor, dead: torch.Tensor, k_sel: int, k_aux: int,
                     kind: int) -> torch.Tensor:
    """Launch (a): → (M, ``candidate_width(n_s, k_sel, k_aux)``) int32 for
    acts (M, n_s) bf16 or f32 and dead (n_s,) bool."""
    if not acts.is_cuda:
        return shard_candidates_plain(acts, dead, k_sel, k_aux, kind)
    if acts.ndim != 2:
        raise ValueError(f"expected acts (M, n_s), got {tuple(acts.shape)}")
    m, n = acts.shape
    if dead.shape != (n,):
        raise ValueError(f"dead must be ({n},), got {tuple(dead.shape)}")
    if min(k_sel, k_aux) < 1:
        raise ValueError(f"k_sel {k_sel}, k_aux {k_aux} must be >= 1")
    want = torch.float32 if kind == F32 else torch.bfloat16
    if acts.dtype != want:
        raise TypeError(f"key kind {kind} takes {want}, got {acts.dtype}")
    widest = limit("topk_sharded", "freud_shard_max_local")
    if n > widest:
        raise ValueError(f"a shard of {n} columns is wider than the candidates "
                         f"kernel's rows ({widest})")
    acts = acts.contiguous()
    width = candidate_width(n, k_sel, k_aux)
    out = torch.empty((m, width), dtype=torch.int32, device=acts.device)
    dead8 = dead.to(device=acts.device, dtype=torch.uint8).contiguous()
    dead_bits = torch.empty((-(-n // 32),), dtype=torch.int32, device=acts.device)
    _CANDIDATES(acts, kind, dead8, dead_bits, m, n, k_sel, k_aux, out, width)
    return out


def _kth(keys: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(keys, k, dim=-1).values[:, -1]


def combine_shard_thresholds_plain(gathered: torch.Tensor, acts: torch.Tensor, n_dict: int,
                                   k_main: int, k_aux: int, k_multi: int, kind: int,
                                   iters: int = ITERS):
    """Plain PyTorch version: → (t_main (M, 1) f32, t_aux (M, 1) f32,
    t_multi (M, 1) f32 or None, fired (n_s,) bool)."""
    p, m, width = gathered.shape
    c_main = width - k_aux - HEADER
    g = _from_words(gathered)
    main = g[:, :, :c_main].permute(1, 0, 2).reshape(m, p * c_main)
    header = g[:, :, c_main + k_aux:]
    d_s = header[:, 0, 4]
    valid = (torch.arange(k_aux, device=g.device)[None, :]
             < torch.clamp(d_s, max=k_aux)[:, None])  # (P, k_aux)
    aux = g[:, :, c_main:c_main + k_aux].permute(1, 0, 2)  # (M, P, k_aux)
    aux_hi = torch.where(valid, aux, -1).reshape(m, -1)  # padding below every key
    aux_lo = torch.where(valid, aux, 2 ** 32).reshape(m, -1)  # … above every key
    dead_total = int(d_s.sum())
    lo_a, hi_a = header[:, :, 0].amin(dim=0), header[:, :, 1].amax(dim=0)
    lo_d, hi_d = header[:, :, 2].amin(dim=0), header[:, :, 3].amax(dim=0)
    sels = [(main, main, k_main, n_dict), (aux_hi, aux_lo, k_aux, dead_total)]
    if k_multi:
        sels.append((main, main, k_multi, n_dict))
    out = []
    if kind == EXACT:
        for hi_keys, lo_keys, k, cand in sels:
            if cand >= k:
                key = _kth(hi_keys, k)
            elif cand == 0:
                key = torch.full((m,), _INF_KEY, dtype=torch.int64, device=g.device)
            else:
                key = lo_keys.amin(dim=-1)  # the smallest candidate
            out.append(key)
        t_key = out[0]
        ts = [values_of(key, kind)[:, None] for key in out]
        bits = acts.view(torch.int16).to(torch.int64)
        t_bits = (t_key - 0x8000)[:, None]
        fired = ((bits >= t_bits) & (bits > 0)).any(dim=0)
    else:
        f32 = torch.float32
        for i, (hi_keys, _, k, cand) in enumerate(sels):
            aux_sel = i == 1
            if cand >= k:
                vk = values_of(_kth(hi_keys, k), kind)
            elif aux_sel and k <= n_dict:
                vk = torch.full((m,), float("-inf"), dtype=f32, device=g.device)
            else:  # fewer than k entries: count >= k never holds
                vk = torch.full((m,), float("nan"), dtype=f32, device=g.device)
            lo_key = lo_d if aux_sel else lo_a
            lo = torch.where(lo_key == _NONE, float("inf"), values_of(lo_key, kind))
            if aux_sel:
                hi = (values_of(hi_d, kind) if dead_total > 0
                      else torch.full((m,), float("-inf"), dtype=f32, device=g.device))
            else:
                hi = values_of(hi_a, kind)
            for _ in range(iters):
                mid = (lo + hi) * 0.5
                ok = mid <= vk
                lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
            out.append(lo[:, None])
        ts = out
        a = acts.to(f32)
        fired = ((a >= ts[0]) & (a > 0)).any(dim=0)
    return ts[0], ts[1], ts[2] if k_multi else None, fired


@counted(_COMBINE)
def combine_shard_thresholds(gathered: torch.Tensor, acts: torch.Tensor, n_dict: int,
                             k_main: int, k_aux: int, k_multi: int, kind: int,
                             iters: int = ITERS):
    """Launch (c): the global thresholds from every model rank's candidates
    ``gathered`` (P, M, width) int32, and ``fired`` for this rank's shard
    ``acts`` (M, n_s). → (t_main (M, 1) f32, t_aux (M, 1) f32, t_multi
    (M, 1) f32 or None, fired (n_s,) bool)."""
    if not acts.is_cuda:
        return combine_shard_thresholds_plain(gathered, acts, n_dict, k_main, k_aux,
                                              k_multi, kind, iters)
    p, m, width = gathered.shape
    n_local = acts.shape[1]
    c_main = width - k_aux - HEADER
    if acts.shape[0] != m or c_main < 1:
        raise ValueError(f"gathered {tuple(gathered.shape)} does not match acts "
                         f"{tuple(acts.shape)} and k_aux {k_aux}")
    gathered = gathered.contiguous()
    acts = acts.contiguous()
    dev = acts.device
    t_main = torch.empty((m, 1), dtype=torch.float32, device=dev)
    t_aux = torch.empty_like(t_main)
    t_multi = torch.empty_like(t_main) if k_multi else None
    fired = torch.zeros((-(-n_local // 32),), dtype=torch.int32, device=dev)
    _COMBINE(gathered, p, m, width, c_main, k_aux, acts, kind, n_local, n_dict, k_main,
             k_multi, iters, t_main, t_aux, t_multi, fired)
    return t_main, t_aux, t_multi, fired_from_bits(fired, n_local)


def sharded_thresholds_fired(acts: torch.Tensor, dead: torch.Tensor, k_main: int,
                             k_aux: int, mesh, n_dict: Optional[int] = None,
                             iters: int = ITERS, k_multi: int = 0, signed: bool = False):
    """``topk_thresholds_fired`` on the (M, n_dict) latent whose columns the
    model group holds, ``acts`` (M, n_s) being this rank's and ``dead``
    (n_s,) its dead mask: → (t_main, t_aux, t_multi or None, fired (n_s,)),
    the thresholds equal on every model rank and bit-equal to the whole
    latent's. ``n_dict``: the global width (default n_s · P)."""
    p = 1 if mesh is None else mesh.model_size
    n_dict = acts.shape[1] * p if n_dict is None else n_dict
    kind = key_kind(acts, n_dict, signed)
    cand = shard_candidates(acts, dead, max(k_main, k_multi), k_aux, kind)
    gathered = mesh_lib.model_all_gather(mesh, cand)
    return combine_shard_thresholds(gathered, acts, n_dict, k_main, k_aux, k_multi, kind,
                                    iters)
