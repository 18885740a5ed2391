"""Optimizers and LR schedules for SAE training (PyTorch).

The port of ``freud_tpu/train/optim.py``, whose optax chain is
global-norm clip → (L2 weight decay, RAdam only) → Adam/RAdam → schedule:

  optimizer "adam"  → ``torch.optim.Adam(lr)``
  optimizer "radam" → ``RAdam(eps=1e-5, weight_decay)`` below: optax's
                      ``scale_by_radam`` formula, which puts eps outside the
                      bias-corrected root (torch's own RAdam divides eps by
                      √(1 − β₂ᵗ) and drifts from JAX once rectification
                      starts); weight decay is L2, added after clipping
  scheduler "cosine" → lr · ½(1 + cos(π·min(c, steps)/steps))
  scheduler "linear" → warmup c/warmup, then (steps − c)/(steps − warmup)

with ``clip_grad_norm_(clip_thresh)`` before every update. The schedule is a
function of the update count c, which starts at 0 as optax's does: under
"linear" the first update has lr 0.
"""

from __future__ import annotations

import math

import torch


def make_schedule(scheduler: str, lr: float, steps: int, scheduler_params: dict):
    """count → lr. ``.host`` is the function itself (the JAX package's name
    for its host-side mirror)."""
    if scheduler == "cosine":
        def schedule(count: int) -> float:
            c = min(max(float(count), 0.0), float(steps))
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / steps))
    elif scheduler == "linear":
        warmup = int((scheduler_params or {}).get("num_warmup_steps", 0))

        def schedule(count: int) -> float:
            c = float(count)
            if c < warmup:
                return lr * c / max(warmup, 1)
            return lr * max((steps - c) / max(steps - warmup, 1), 0.0)
    else:
        raise ValueError(f"Invalid scheduler: {scheduler!r}, must be 'cosine' or 'linear'")
    schedule.host = schedule
    return schedule


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as ``optax.scale_by_radam`` computes it, with L2 weight
    decay added to the (clipped) gradient first."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-5, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = int(st["step"])
                m = st["exp_avg"].mul_(b1).add_(g, alpha=1.0 - b1)
                v = st["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                b2t = b2 ** t
                ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
                mu_hat = m / (1.0 - b1 ** t)
                if ro >= 5.0:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    upd = r * mu_hat / ((v / (1.0 - b2t)).sqrt() + group["eps"])
                else:
                    upd = mu_hat
                p.add_(upd, alpha=-group["lr"])


class SAEOptimizer:
    """Clip → optimizer → schedule for one parameter list (in the JAX
    package's leaf order), counting updates as optax does."""

    def __init__(self, inner: torch.optim.Optimizer, params: list, schedule,
                 clip_thresh: float):
        self.inner = inner
        self.params = params
        self.schedule = schedule
        self.clip_thresh = clip_thresh
        self.count = 0  # updates applied; the schedule reads it before the update

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        torch.nn.utils.clip_grad_norm_(self.params, self.clip_thresh)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1

    def state_leaves(self) -> list[torch.Tensor]:
        """The state as optax's leaves: [count, mu…, nu…, schedule count]
        (int32 scalars, f32 moments on the parameters' device)."""
        states = [self.inner.state.get(p, {}) for p in self.params]
        count = int(states[0]["step"]) if states[0] else 0
        mu = [s["exp_avg"] if s else torch.zeros_like(p) for s, p in zip(states, self.params)]
        nu = [s["exp_avg_sq"] if s else torch.zeros_like(p) for s, p in zip(states, self.params)]
        return [torch.tensor(count, dtype=torch.int32), *mu, *nu,
                torch.tensor(self.count, dtype=torch.int32)]

    def load_state_leaves(self, leaves: list) -> None:
        n = len(self.params)
        if len(leaves) != 2 * n + 2:
            raise ValueError(
                f"optimizer state has {len(leaves)} leaves, expected {2 * n + 2} "
                "(optimizer/scheduler config changed since the checkpoint?)")
        for i, (leaf, p) in enumerate(zip(leaves[1:1 + 2 * n], self.params * 2)):
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(
                    f"optimizer-state leaf {i + 1} has shape {tuple(leaf.shape)}, "
                    f"expected {tuple(p.shape)} (model config changed since the "
                    "checkpoint?)")
        count = int(leaves[0])
        self.inner.state.clear()
        if count:
            for i, p in enumerate(self.params):
                self.inner.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": torch.as_tensor(leaves[1 + i]).to(p.device, torch.float32).clone(),
                    "exp_avg_sq": torch.as_tensor(leaves[1 + n + i]).to(p.device, torch.float32).clone(),
                }
        self.count = int(leaves[-1])


def make_optimizer(optimizer: str, scheduler: str, lr: float, steps: int,
                   params: list, weight_decay: float = 0.0,
                   clip_thresh: float = 1.0,
                   scheduler_params: dict | None = None):
    """→ (SAEOptimizer, schedule) for ``params`` in the JAX leaf order."""
    schedule = make_schedule(scheduler, lr, steps, scheduler_params or {})
    if optimizer == "radam":
        inner = RAdam(params, lr=lr, eps=1e-5, weight_decay=weight_decay)
    elif optimizer == "adam":
        inner = torch.optim.Adam(params, lr=lr)
    else:
        raise ValueError(f"Invalid optimizer: {optimizer!r}, must be 'radam' or 'adam'")
    return SAEOptimizer(inner, params, schedule, clip_thresh), schedule
