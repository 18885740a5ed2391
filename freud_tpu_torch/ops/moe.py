"""The routed experts of a mixture-of-experts layer as hand-written CUDA
kernels (``csrc/moe.cu``) beside their plain PyTorch versions. Two models
call them: Uni-MoE-2.0-Omni (a top-p rule with a null expert, every expert
held; ``models/omni/model.py::MoE``) and LongCat-Flash-Omni (a biased top-k
over routed and identity entries, a share of the routed experts held;
``models/longcat/model.py::MoE``).

They replace no TPU kernel: the JAX package has no such model. A layer
calls, in order:

  route(u, w_router, top_p, top_k) → (probs (T, n_all) f32, sel (T, top_k)
      int32, wsel (T, top_k) f32): logits = u·w_routerᵀ in f32 (the router
      in fp32 whatever u's dtype), p = softmax; entries in order of p, ties
      to the lower index; entry j is taken while j < top_k and the sum of
      the p before it is below top_p (the first always). sel holds the
      taken entries (-1 where none), wsel their p, not renormalised.
  or route_topk(logits, bias, top_k, scale, held, identity) → (probs, sel,
      wsel, cls): from f32 logits (T, n_all), p = softmax (its sum in the
      order the kernel takes, ``_lane_sum``); sel the top_k entries of p +
      bias (ties to the lower index; the bias only chooses), wsel = scale ·
      p of each, cls each slot's class: 0 a held expert (``held``, a range
      [lo, hi)), 1 an identity entry (``identity``), 2 absent (an expert
      another card holds).
  plan(sel, n_dyn, counts, lo=0) → (offsets (n_dyn,), pos (T, top_k) int32):
      counts (n_all,) int32 of every entry (null, identity and absent ones
      included), written into ``counts``; the held experts [lo, lo + n_dyn)
      laid expert by expert, in slot order within one; pos is each slot's
      row (-1 for an empty slot or one of any other entry).
  permute(u, pos, rows_max) → a (rows_max, d): u's row at each of its rows
      (rows past the routed ones hold whatever was there).
  gateup(a, counts, offsets, w_gate, w_up, lo=0) → h (rows_max, I):
      silu(a·w_gate[e]ᵀ) ⊙ (a·w_up[e]ᵀ) on held expert e's rows (its count
      counts[lo + e]), each product, the silu and the ⊙ rounded to a's dtype
      as eager PyTorch rounds them.
  down(h, counts, offsets, w_down, lo=0) → y (rows_max, d): h·w_down[e]ᵀ.
  combine(x, fixed, y, pos, wsel, u=None, sel=None, identity=(0, 0)) → x +
      fixed + Σ_j wsel_j · v_j in f32, in slot order, rounded once to x's
      dtype: v_j = y[pos_j] for a held slot, u for a slot of an identity
      entry, nothing for another.

No token is dropped: rows_max = T·top_k holds every slot. On the card
nothing here synchronises with the host: the counts and offsets stay on the
card, and the grouped products read them there (their grid is one block an
SM, taking only the tiles the held rows make from a counter on the card). A
CUDA tensor launches the kernels, which take contiguous bf16 operands
(route_topk f32 logits) and raise on any other; a CPU tensor takes the
``*_plain`` version (which reads the counts on the host). ``.launches``
counts a wrapper's calls on the card (``_native.counted``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._native import Kernel, counted, limit

# ------------------------------------------------------------ plain versions


def select(probs, top_p: float, top_k: int):
    """The top-p rule on (T, n_all) probabilities → (sel, wsel)."""
    ps, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    before = torch.cat([torch.zeros_like(ps[:, :1]), torch.cumsum(ps, dim=-1)[:, :-1]], dim=1)
    take = before[:, :top_k] < top_p
    take[:, 0] = True
    sel = torch.where(take, idx[:, :top_k], -1).to(torch.int32)
    wsel = torch.where(take, ps[:, :top_k], 0.0)
    return sel, wsel


def route_plain(u, w_router, top_p: float, top_k: int):
    """Plain PyTorch version of ``route``."""
    probs = torch.softmax(u.float() @ w_router.float().T, dim=-1)
    return (probs, *select(probs, top_p, top_k))


def _lane_sum(e):
    """The kernel's sum of each row of ``e`` (T, n): lane l of a warp adds
    entries l, l + 32, … in order, then five butterfly steps add the lanes'
    sums (every lane ends with the same value)."""
    t, n = e.shape
    lanes = e.new_zeros((t, -(-n // 32) * 32))
    lanes[:, :n] = e
    lanes = lanes.reshape(t, -1, 32)
    s = lanes[:, 0]
    for i in range(1, lanes.shape[1]):
        s = s + lanes[:, i]
    idx = torch.arange(32, device=e.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    return s[:, :1]


def select_topk(probs, bias, top_k: int, scale: float, held: tuple, identity: tuple):
    """The biased top-k rule on (T, n_all) probabilities → (sel, wsel,
    cls): the top_k entries of probs + bias (ties to the lower index),
    scale · p of each, and each slot's class (0 held, 1 identity, 2 absent)."""
    order = torch.sort(probs + bias, dim=-1, descending=True, stable=True).indices
    sel = order[:, :top_k]
    wsel = scale * probs.gather(1, sel)
    cls = torch.full_like(sel, 2)
    cls = torch.where((sel >= identity[0]) & (sel < identity[1]), 1, cls)
    cls = torch.where((sel >= held[0]) & (sel < held[1]), 0, cls)
    return sel.to(torch.int32), wsel, cls.to(torch.int8)


def route_topk_plain(logits, bias, top_k: int, scale: float, held: tuple, identity: tuple):
    """Plain PyTorch version of ``route_topk``."""
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    probs = e / _lane_sum(e)
    return (probs, *select_topk(probs, bias, top_k, scale, held, identity))


def plan_plain(sel, n_dyn: int, counts, lo: int = 0):
    """Plain PyTorch version of ``plan``."""
    t, k = sel.shape
    flat = sel.reshape(-1).to(torch.int64)
    n_all = counts.numel()
    counts.copy_(torch.bincount(flat[flat >= 0], minlength=n_all)[:n_all].to(counts.dtype))
    dyn = (flat >= lo) & (flat < lo + n_dyn)
    key = torch.where(dyn, flat - lo, n_dyn)
    order = torch.sort(key, stable=True).indices
    rows = torch.arange(flat.numel(), device=sel.device)
    pos = torch.empty_like(flat)
    pos[order] = torch.where(dyn[order], rows, -1)
    dyn_counts = counts[lo:lo + n_dyn].to(torch.int64)
    offsets = torch.cumsum(dyn_counts, 0) - dyn_counts
    return offsets.to(torch.int32), pos.reshape(t, k).to(torch.int32)


def permute_plain(u, pos, rows_max: int):
    """Plain PyTorch version of ``permute`` (unrouted rows are zeros)."""
    k = pos.shape[1]
    a = u.new_zeros((rows_max + 1, u.shape[1]))
    dst = torch.where(pos >= 0, pos, rows_max).reshape(-1).to(torch.int64)
    a.index_copy_(0, dst, u.repeat_interleave(k, dim=0))
    return a[:rows_max]


def _expert_rows(counts, offsets, n_dyn: int, lo: int):
    c, o = counts[lo:lo + n_dyn].tolist(), offsets.tolist()
    return [(e, o[e], o[e] + c[e]) for e in range(n_dyn) if c[e]]


def gateup_plain(a, counts, offsets, w_gate, w_up, lo: int = 0):
    """Plain PyTorch version of ``gateup`` (unrouted rows are zeros)."""
    h = a.new_zeros((a.shape[0], w_gate.shape[1]))
    for e, r0, r1 in _expert_rows(counts, offsets, w_gate.shape[0], lo):
        x = a[r0:r1]
        h[r0:r1] = F.silu(x @ w_gate[e].T) * (x @ w_up[e].T)
    return h


def down_plain(h, counts, offsets, w_down, lo: int = 0):
    """Plain PyTorch version of ``down`` (unrouted rows are zeros)."""
    y = h.new_zeros((h.shape[0], w_down.shape[1]))
    for e, r0, r1 in _expert_rows(counts, offsets, w_down.shape[0], lo):
        y[r0:r1] = h[r0:r1] @ w_down[e].T
    return y


def combine_plain(x, fixed, y, pos, wsel, u=None, sel=None, identity=(0, 0)):
    """Plain PyTorch version of ``combine``."""
    acc = x.float() + fixed.float()
    for j in range(pos.shape[1]):
        p = pos[:, j].to(torch.int64)
        rows = y.index_select(0, p.clamp(min=0)).float()
        acc = acc + torch.where((p >= 0)[:, None], wsel[:, j:j + 1] * rows, 0.0)
        if identity[1] > identity[0]:
            e = sel[:, j]
            ident = (p < 0) & (e >= identity[0]) & (e < identity[1])
            acc = acc + torch.where(ident[:, None], wsel[:, j:j + 1] * u.float(), 0.0)
    return acc.to(x.dtype)


# -------------------------------------------------------------- the kernels


_ROUTE = Kernel("moe", "freud_moe_route", "moe route kernel")
_ROUTE_TOPK = Kernel("moe", "freud_moe_route_topk", "moe top-k route kernel")
_PLAN = Kernel("moe", "freud_moe_plan", "moe plan kernel")
_PERMUTE = Kernel("moe", "freud_moe_permute", "moe permute kernel")
_GATEUP = Kernel("moe", "freud_moe_gateup", "moe gate/up kernel")
_DOWN = Kernel("moe", "freud_moe_down", "moe down kernel")
_COMBINE = Kernel("moe", "freud_moe_combine", "moe combine kernel")


def _on_card(what: str, *tensors) -> bool:
    """Whether the call takes the kernels: it does when its first tensor is
    on the card, and then every tensor must be contiguous bf16 (raises
    otherwise); on the CPU it takes the plain version."""
    if not tensors[0].is_cuda:
        return False
    for t in tensors:
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{what}: the kernels take contiguous bf16 tensors, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return True


@counted(_ROUTE)
def route(u: torch.Tensor, w_router: torch.Tensor, top_p: float, top_k: int):
    """u (T, d), w_router (n_all, d) → (probs, sel, wsel) (module docstring)."""
    if not _on_card("moe route", u):
        return route_plain(u, w_router, top_p, top_k)
    t, d = u.shape
    n_all = w_router.shape[0]
    if n_all > limit("moe", "freud_moe_max_all", 0) or top_k > n_all or d % 8:
        raise ValueError(f"moe route: {n_all} router outputs, top_k {top_k}, d {d}")
    w = w_router.float().contiguous()
    probs = torch.empty((t, n_all), dtype=torch.float32, device=u.device)
    sel = torch.empty((t, top_k), dtype=torch.int32, device=u.device)
    wsel = torch.empty((t, top_k), dtype=torch.float32, device=u.device)
    _ROUTE(u, w, t, d, n_all, float(top_p), top_k, probs, sel, wsel)
    return probs, sel, wsel


@counted(_ROUTE_TOPK)
def route_topk(logits: torch.Tensor, bias: torch.Tensor, top_k: int, scale: float,
               held: tuple, identity: tuple):
    """logits (T, n_all) f32, bias (n_all,) f32 → (probs, sel, wsel, cls)
    (module docstring)."""
    if not logits.is_cuda:
        return route_topk_plain(logits, bias, top_k, scale, held, identity)
    t, n_all = logits.shape
    for v in (logits, bias):
        if v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"moe route_topk: the kernel takes contiguous f32 logits and "
                             f"bias, got {v.dtype} {tuple(v.shape)}")
    if n_all > limit("moe", "freud_moe_max_all", 1) or not 0 < top_k <= n_all or \
            bias.shape != (n_all,):
        raise ValueError(f"moe route_topk: {n_all} router outputs, top_k {top_k}, bias "
                         f"{tuple(bias.shape)}")
    dev = logits.device
    probs = torch.empty((t, n_all), dtype=torch.float32, device=dev)
    sel = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    wsel = torch.empty((t, top_k), dtype=torch.float32, device=dev)
    cls = torch.empty((t, top_k), dtype=torch.int8, device=dev)
    _ROUTE_TOPK(logits, bias, t, n_all, top_k, float(scale), held[0], held[1], identity[0],
                identity[1], probs, sel, wsel, cls)
    return probs, sel, wsel, cls


@counted(_PLAN)
def plan(sel: torch.Tensor, n_dyn: int, counts: torch.Tensor, lo: int = 0):
    """sel (T, top_k) int32; counts (n_all,) int32, written; the held
    experts [lo, lo + n_dyn) → (offsets, pos) (module docstring)."""
    if not sel.is_cuda:
        return plan_plain(sel, n_dyn, counts, lo)
    sel = sel.contiguous()
    offsets = torch.empty((n_dyn,), dtype=torch.int32, device=sel.device)
    pos = torch.empty(sel.shape, dtype=torch.int32, device=sel.device)
    if counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError("moe plan: counts must be a contiguous int32 tensor")
    if counts.numel() > limit("moe", "freud_moe_max_all", 1) or n_dyn < 1 or \
            lo + n_dyn > counts.numel():
        raise ValueError(f"moe plan: {counts.numel()} entries, held [{lo}, {lo + n_dyn})")
    _PLAN(sel, sel.numel(), counts.numel(), lo, n_dyn, counts, offsets, pos)
    return offsets, pos


@counted(_PERMUTE)
def permute(u: torch.Tensor, pos: torch.Tensor, rows_max: int) -> torch.Tensor:
    """u (T, d), pos (T, top_k) → a (rows_max, d) (module docstring)."""
    if not _on_card("moe permute", u):
        return permute_plain(u, pos, rows_max)
    t, d = u.shape
    a = torch.empty((rows_max, d), dtype=u.dtype, device=u.device)
    _PERMUTE(u, pos.contiguous(), t, pos.shape[1], d, a)
    return a


@counted(_GATEUP)
def gateup(a, counts, offsets, w_gate, w_up, lo: int = 0) -> torch.Tensor:
    """a (rows_max, d); w_gate, w_up (n_dyn, I, d) of the held experts
    [lo, lo + n_dyn) → h (rows_max, I)."""
    if not _on_card("moe gateup", a, w_gate, w_up):
        return gateup_plain(a, counts, offsets, w_gate, w_up, lo)
    n_dyn, i, d = w_gate.shape
    if d % 64 or i % 128:
        raise ValueError(f"moe gateup: d {d} must divide by 64 and I {i} by 128")
    h = torch.empty((a.shape[0], i), dtype=a.dtype, device=a.device)
    tiles = torch.empty((1,), dtype=torch.int32, device=a.device)  # the kernel's tile counter
    _GATEUP(a, a.shape[0], d, w_gate, w_up, n_dyn, i, counts[lo:], offsets, tiles, h)
    return h


@counted(_DOWN)
def down(h, counts, offsets, w_down, lo: int = 0) -> torch.Tensor:
    """h (rows_max, I); w_down (n_dyn, d, I) of the held experts → y
    (rows_max, d)."""
    if not _on_card("moe down", h, w_down):
        return down_plain(h, counts, offsets, w_down, lo)
    n_dyn, d, i = w_down.shape
    if i % 64 or d % 256:
        raise ValueError(f"moe down: I {i} must divide by 64 and d {d} by 256")
    y = torch.empty((h.shape[0], d), dtype=h.dtype, device=h.device)
    tiles = torch.empty((1,), dtype=torch.int32, device=h.device)  # the kernel's tile counter
    _DOWN(h, h.shape[0], i, w_down, n_dyn, d, counts[lo:], offsets, tiles, y)
    return y


@counted(_COMBINE)
def combine(x, fixed, y, pos, wsel, u=None, sel=None, identity=(0, 0)) -> torch.Tensor:
    """x, fixed (T, d); y (rows_max, d); pos, wsel (T, top_k); with an
    identity range, u (T, d) and sel (T, top_k) → (T, d)."""
    ident = identity[1] > identity[0]
    if not _on_card("moe combine", x, fixed, y, *((u,) if ident else ())):
        return combine_plain(x, fixed, y, pos, wsel, u, sel, identity)
    t, d = x.shape
    out = torch.empty_like(x)
    _COMBINE(x, fixed, y, pos.contiguous(), wsel.contiguous(), u if ident else x,
             sel.contiguous() if ident else pos, t, pos.shape[1], d, identity[0], identity[1],
             out)
    return out
