"""FREUD's TopK SAE train step in plain float32 PyTorch.

The step, as FREUD's recipe defines it (and the JAX package's trainer, whose
semantics the port keeps): latents relu((x − b_dec)·W_encᵀ + b_enc); the
main decode keeps each row's latents at or above its k-th largest; the
total variance is Σ(x − the mean over the file axis)², 1 where it is 0;
fvu = Σ(sae_out − x)² / tv. AuxK: latents whose frames-since-fired counter
exceeds the dead threshold are dead; each row keeps its k_aux = d/2
largest dead latents (all of them when fewer are dead), and auxk =
alpha · min(n_dead / k_aux, 1) · Σ(ê − e)² / tv with ê the aux decode plus
b_dec. The loss is fvu + auxk; gradients reach the kept, positive latents
(the thresholds are constants). Then optax's global-norm clip, Adam
(β 0.9, 0.999, ε 1e-8) with the schedule read at the update count before
the update, and the counters: every latent ages by the batch's rows
(saturating at 2³⁰), the ones kept with a positive value in any row reset.

Rows are taken in blocks, so the (rows, n_dict) latent of a large batch is
never whole on the device; sums and gradients add up over the blocks.
``operand`` rounds every product's operands and the latent before its
selection (the control's lower precision); None keeps float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

LEAVES = ("encoder.weight", "encoder.bias", "W_dec", "b_dec")


def fp8_operand(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), back to float32; straight through for gradients."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def lr_at(count: int, hp: dict) -> float:
    """The schedule at update count ``count`` (before the update)."""
    lr, steps = hp["lr"], hp["steps"]
    if hp["scheduler"] == "linear":
        warmup = int(hp.get("num_warmup_steps", 0))
        if count < warmup:
            return lr * count / max(warmup, 1)
        return lr * max((steps - count) / max(steps - warmup, 1), 0.0)
    if hp["scheduler"] == "cosine":
        c = min(max(float(count), 0.0), float(steps))
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / steps))
    raise ValueError(f"scheduler {hp['scheduler']!r}")


def _mm(a: torch.Tensor, b: torch.Tensor, operand: Optional[Callable]) -> torch.Tensor:
    if operand is not None:
        a, b = operand(a), operand(b)
    return a @ b


def topk_step(params: dict, mu: dict, nu: dict, count: int, counters: torch.Tensor,
              x: torch.Tensor, hp: dict, block_rows: int = 12000,
              operand: Optional[Callable] = None) -> dict:
    """One train step from ``params`` (LEAVES → f32 tensors), Adam's moments,
    its update count and the dead counters, on the (files, T, d) f32 batch
    ``x``. → loss, fvu, auxk, the clipped gradients, the new parameters,
    moments and counters, and n_dead."""
    dev = x.device
    leaves = {n: params[n].detach().clone().requires_grad_() for n in LEAVES}
    W_enc, b_enc, W_dec, b_dec = (leaves[n] for n in LEAVES)
    d = x.shape[-1]
    n_dict = W_enc.shape[0]
    k, k_aux = int(hp["k"]), d // 2
    tv = torch.sum((x - x.mean(dim=0)) ** 2)
    tv = torch.where(tv == 0, torch.ones_like(tv), tv)
    dead = counters.to(dev) > hp["dead_feature_threshold"]
    n_dead = int(dead.sum())
    scale = min(n_dead / k_aux, 1.0)
    alpha = float(hp["auxk_alpha"])
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    fired = torch.zeros(n_dict, dtype=torch.bool, device=dev)
    grads = {n: torch.zeros_like(leaves[n]) for n in LEAVES}
    fvu = torch.zeros((), dtype=torch.float64, device=dev)
    auxk = torch.zeros((), dtype=torch.float64, device=dev)
    for a in range(0, rows, block_rows):
        xb = x2[a:a + block_rows]
        acts = torch.relu(_mm(xb - b_dec, W_enc.T, operand) + b_enc)
        if operand is not None:
            acts = operand(acts)
        with torch.no_grad():
            t_main = torch.topk(acts, k, dim=-1).values[:, -1:]
            keep_main = acts >= t_main
            fired |= (keep_main & (acts > 0)).any(dim=0)
        y_main = _mm(acts * keep_main, W_dec, operand)
        e = y_main + b_dec - xb
        lf = torch.sum(e * e) / tv
        total = lf
        if n_dead:
            with torch.no_grad():
                masked = torch.where(dead, acts, torch.full_like(acts, -math.inf))
                t_aux = torch.topk(masked, min(k_aux, n_dict), dim=-1).values[:, -1:]
                keep_aux = dead & (acts >= t_aux)
            y_aux = _mm(acts * keep_aux, W_dec, operand)
            r = y_aux - y_main + xb
            la = alpha * scale * torch.sum(r * r) / tv
            total = total + la
            auxk += la.detach().double()
        fvu += lf.detach().double()
        gs = torch.autograd.grad(total, [leaves[n] for n in LEAVES])
        for n, g in zip(LEAVES, gs):
            grads[n] += g
    # optax clip_by_global_norm, then Adam
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
    factor = 1.0 if norm < hp["clip_thresh"] else hp["clip_thresh"] / norm
    grads = {n: g * factor for n, g in grads.items()}
    lr = lr_at(count, hp)
    t = count + 1
    b1, b2, eps = 0.9, 0.999, 1e-8
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    new_p, new_mu, new_nu = {}, {}, {}
    for n in LEAVES:
        g = grads[n]
        m = b1 * mu[n].to(dev) + (1.0 - b1) * g
        v = b2 * nu[n].to(dev) + (1.0 - b2) * g * g
        new_mu[n], new_nu[n] = m, v
        new_p[n] = params[n].to(dev) - (lr / bc1) * m / (torch.sqrt(v / bc2) + eps)
    aged = torch.clamp(counters.to(dev).to(torch.int64) + rows, max=2 ** 30)
    new_counters = torch.where(fired, torch.zeros_like(aged), aged)
    return {"loss": float(fvu + auxk), "fvu": float(fvu), "auxk": float(auxk),
            "grads": grads, "params": new_p, "mu": new_mu, "nu": new_nu,
            "counters": new_counters, "n_dead": n_dead}
