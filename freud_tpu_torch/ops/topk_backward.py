"""The TopK SAE training backward's passes over the (M, n_dict) latent, as
hand-written CUDA kernels (``csrc/topk_backward.cu``).

They replace no TPU kernel: JAX's hand-written VJP
(``freud_tpu/models/sae/topk.py:409-470``) leaves its masks to XLA, which
fuses them into the products around them. ``models/sae/topk.py::
_FusedLosses.backward`` keeps the five products as plain matrix products
and calls two passes between them, each recomputing the masks from acts,
the per-row thresholds and the dead flags:

  topk_masked_pair(acts, t_main, t_aux, dead_f) → (2M, n) in acts' dtype:
      [acts·[acts ≥ t_main]; acts·[acts ≥ t_aux ∧ dead]]
  topk_route(d, acts, t_main, t_aux, dead_f) → (d_acts (M, n) in d's
      dtype, db_enc (n,) f32), for d = [d1; d2] (2M, n):
      d_acts = where(keep_main ∧ live, d1, 0) + where(keep_aux ∧ live, d2, 0)
      db_enc = Σ over rows of d_acts, in f32

with live = acts > 0 and every comparison ATen's (acts against the f32
thresholds, ties kept). On the card ``dense_*`` and ``d_acts`` equal the
plain versions bit for bit; ``db_enc`` sums each group of ``GROUP_ROWS``
rows, then the groups in order (no atomics, so two launches agree bit for
bit), within f32 rounding of ``torch.sum``.

Each wrapper dispatches on the device: a CUDA tensor launches the kernels
(f32 or bf16, picked from acts' dtype), a CPU tensor takes its ``*_plain``
version, the expressions the backward ran before the kernels. ``.launches``
counts a wrapper's calls on the card; a call captured into a CUDA graph
counts in ``.captured``, and each replay adds it to ``.launches``
(``_native.counted``, ``train/graph.py``).
"""

from __future__ import annotations

import torch

from .._native import Kernel, counted

GROUP_ROWS = 128  # rows a block walks; topk_route's partial sums are per group


def _masks(acts, t_main, t_aux, dead_f):
    keep_main = acts >= t_main
    keep_aux = (acts >= t_aux) & (dead_f > 0)
    return keep_main, keep_aux


def topk_masked_pair_plain(acts, t_main, t_aux, dead_f):
    """Plain PyTorch version: the two ``where``s, stacked."""
    zero = torch.zeros((), dtype=acts.dtype, device=acts.device)
    keep_main, keep_aux = _masks(acts, t_main, t_aux, dead_f)
    return torch.cat([torch.where(keep_main, acts, zero), torch.where(keep_aux, acts, zero)])


def topk_route_plain(d, acts, t_main, t_aux, dead_f):
    """Plain PyTorch version: the masked cotangents and their column sum."""
    m = acts.shape[0]
    zct = torch.zeros((), dtype=d.dtype, device=d.device)
    keep_main, keep_aux = _masks(acts, t_main, t_aux, dead_f)
    live = acts > 0
    d_acts = (torch.where(keep_main & live, d[:m], zct)
              + torch.where(keep_aux & live, d[m:], zct))
    return d_acts, torch.sum(d_acts, dim=0, dtype=torch.float32)


_PAIR = Kernel("topk_backward", "freud_topk_bwd_pair", "topk backward masked pair kernel")
_ROUTE = Kernel("topk_backward", "freud_topk_bwd_route", "topk backward route kernel")


def _operands(acts, t_main, t_aux, dead_f):
    """The checked row and column operands as the kernels read them: → (m,
    n, acts, t_main (m,) f32, t_aux (m,) f32, dead_f (n,) f32)."""
    if acts.ndim != 2 or acts.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"acts must be (M, n_dict) float32 or bfloat16, got "
                         f"{tuple(acts.shape)} {acts.dtype}")
    m, n = acts.shape
    if t_main.numel() != m or t_aux.numel() != m or dead_f.shape != (n,):
        raise ValueError(f"t_main {tuple(t_main.shape)}, t_aux {tuple(t_aux.shape)}, "
                         f"dead_f {tuple(dead_f.shape)} do not match acts {(m, n)}")
    for t in (t_main, t_aux, dead_f):
        if t.device != acts.device:
            raise ValueError(f"operands must be on {acts.device}, got {t.device}")
    f32 = torch.float32
    return (m, n, acts.contiguous(), t_main.reshape(m).to(f32).contiguous(),
            t_aux.reshape(m).to(f32).contiguous(), dead_f.to(f32).contiguous())


@counted(_PAIR)
def topk_masked_pair(acts: torch.Tensor, t_main: torch.Tensor, t_aux: torch.Tensor,
                     dead_f: torch.Tensor) -> torch.Tensor:
    """acts (M, n_dict) f32 or bf16, t_main and t_aux (M, 1) f32, dead_f
    (n_dict,) f32 (dead where > 0) → [dense_main; dense_aux] (2M, n_dict) in
    acts' dtype."""
    if not acts.is_cuda:
        return topk_masked_pair_plain(acts, t_main, t_aux, dead_f)
    m, n, acts, t_main, t_aux, dead_f = _operands(acts, t_main, t_aux, dead_f)
    pair = torch.empty((2 * m, n), dtype=acts.dtype, device=acts.device)
    _PAIR(acts, int(acts.dtype == torch.float32), t_main, t_aux, dead_f, m, n, GROUP_ROWS, pair)
    return pair


@counted(_ROUTE)
def topk_route(d: torch.Tensor, acts: torch.Tensor, t_main: torch.Tensor,
               t_aux: torch.Tensor, dead_f: torch.Tensor):
    """d (2M, n_dict) = [d1; d2] in acts' dtype; acts, t_main, t_aux, dead_f
    as ``topk_masked_pair``'s → (d_acts (M, n_dict) in acts' dtype, db_enc
    (n_dict,) f32)."""
    if not acts.is_cuda:
        return topk_route_plain(d, acts, t_main, t_aux, dead_f)
    m, n, acts, t_main, t_aux, dead_f = _operands(acts, t_main, t_aux, dead_f)
    if d.shape != (2 * m, n) or d.dtype != acts.dtype or d.device != acts.device:
        raise ValueError(f"d must be (2M, n_dict) {acts.dtype} on {acts.device}, got "
                         f"{tuple(d.shape)} {d.dtype} on {d.device}")
    d = d.contiguous()
    d_acts = torch.empty((m, n), dtype=acts.dtype, device=acts.device)
    db_enc = torch.empty((n,), dtype=torch.float32, device=acts.device)
    partials = torch.empty((-(-m // GROUP_ROWS), n), dtype=torch.float32, device=acts.device)
    _ROUTE(d, acts, int(acts.dtype == torch.float32), t_main, t_aux, dead_f, m, n, GROUP_ROWS,
           d_acts, partials, db_enc)
    return d_acts, db_enc
