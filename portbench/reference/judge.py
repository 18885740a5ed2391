"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, as numbers each held to a limit of the cell."""

from __future__ import annotations

import statistics

import torch


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def norms(leaves: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in leaves.items()}


def counted(ref_grads: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding:
    its norm at least a thousandth of the median leaf's."""
    g = norms(ref_grads)
    med = statistics.median(g.values())
    return [n for n, v in g.items() if v >= 1e-3 * med]


def leaf_norm_gap(prog: dict, ref: dict, names=None) -> float:
    """The worst leaf's gap of norms, |‖p‖ − ‖r‖|, against the larger of
    that leaf's reference norm and the median leaf's."""
    names = list(ref) if names is None else names
    rn, pn = norms({n: ref[n] for n in names}), norms({n: prog[n] for n in names})
    med = statistics.median(rn.values())
    return max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names)


def topk_gap(vals: torch.Tensor, idx: torch.Tensor, ref_acts: torch.Tensor,
             k: int) -> float:
    """How far the program's (rows, k) TopK values and indices lie from the
    reference's (rows, n) latents, as a share of the reference's median row
    maximum: the larger of the widest value gap at the program's indices
    and the widest depth by which a latent the program kept lies below the
    reference's k-th largest in its row. Near ties may swap a latent at the
    margin without a gap; a latent the reference does not keep, or a wrong
    value, shows. Indices out of range or repeated in a row are a fault
    (infinite gap)."""
    n = ref_acts.shape[-1]
    idx = idx.to(torch.int64)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        return float("inf")
    s = torch.sort(idx, dim=-1).values
    if bool((s[:, 1:] == s[:, :-1]).any()):
        return float("inf")
    top = torch.topk(ref_acts, k, dim=-1).values
    scale = float(top[:, 0].median().clamp(min=1e-30))
    kth = top[:, -1:]
    at = torch.gather(ref_acts, 1, idx)
    value = float((vals.to(at.dtype) - at).abs().max())
    below = float((kth - at).clamp(min=0).max())
    return max(value, below) / scale


def top_features_errors(indices, traces, ref_acts: torch.Tensor, k: int,
                        top_n: int) -> torch.Tensor | None:
    """Each error of a ``/top_features`` answer (feature indices by their
    largest activation over the clip, each with its activation at every
    frame) against the reference's (frames, n) latents before the TopK, as
    a share of the reference's median frame maximum: a returned feature's
    depth below the reference's ``top_n``-th largest TopK maximum; at each
    frame of each returned feature, the gap of a kept activation to the
    reference's (or, if larger, its depth below the frame's k-th largest),
    and the height above the frame's k-th largest of one left at zero.
    None for a malformed answer."""
    n = ref_acts.shape[-1]
    try:
        idx = torch.as_tensor(indices, dtype=torch.int64, device=ref_acts.device)
        tr = torch.as_tensor(traces, dtype=ref_acts.dtype, device=ref_acts.device)
    except (TypeError, ValueError, RuntimeError):
        return None
    if (idx.shape != (top_n,) or tr.shape != (top_n, ref_acts.shape[0])
            or int(idx.min()) < 0 or int(idx.max()) >= n
            or len(set(idx.tolist())) != top_n):
        return None
    top = torch.topk(ref_acts, k, dim=-1).values
    scale = top[:, 0].median().clamp(min=1e-30)
    kth = top[:, -1:]
    dense = torch.where(ref_acts >= kth, ref_acts, torch.zeros_like(ref_acts))
    m = dense.amax(dim=0)
    m_top = torch.sort(m, descending=True).values[top_n - 1]
    rank = (m_top - m[idx]).clamp(min=0)
    a = ref_acts[:, idx].T
    kt = kth[:, 0][None, :]
    kept = torch.maximum((tr - a).abs(), (kt - a).clamp(min=0))
    entry = torch.where(tr > 0, kept, (a - kt).clamp(min=0))
    return torch.cat([rank, entry.reshape(-1)]) / scale


def answers_rms(errors: list) -> float:
    """The root mean square of every error of every answer (infinite if
    one answer is malformed)."""
    if not errors or any(e is None for e in errors):
        return float("inf")
    allerr = torch.cat([e.double() for e in errors])
    return float(torch.sqrt(torch.mean(allerr ** 2)))
