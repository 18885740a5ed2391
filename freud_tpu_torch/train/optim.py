"""Optimizers and LR schedules for SAE training (PyTorch).

The port of ``freud_tpu/train/optim.py``, whose optax chain is
global-norm clip → (L2 weight decay, RAdam only) → Adam/RAdam → schedule:

  optimizer "adam"  → optax ``scale_by_adam`` (eps 1e-8), torch Adam's
                      recipe
  optimizer "radam" → optax ``scale_by_radam`` (eps 1e-5), which puts eps
                      outside the bias-corrected root (torch's own RAdam
                      divides eps by √(1 − β₂ᵗ) and drifts from JAX once
                      rectification starts); weight decay is L2, added
                      after clipping
  scheduler "cosine" → lr · ½(1 + cos(π·min(c, steps)/steps))
  scheduler "linear" → warmup c/warmup, then (steps − c)/(steps − warmup)

with optax's ``clip_by_global_norm(clip_thresh)`` before every update. The
schedule is a function of the update count c, which starts at 0 as optax's
does: under "linear" the first update has lr 0.

Every update reads the count from a device tensor, and the schedule, the
bias corrections and RAdam's rectification branch are device arithmetic
(``torch.where``), so a step captured in a CUDA graph replays with the
count of its replay, not the count of its capture. Those scalars are
float64, as the Python floats of the host form were (optax takes them in
f32: RAdam's rectification term 1999 − 2tβ₂ᵗ/(1 − β₂ᵗ) cancels to ~5 at
its start, so the two differ there by ~1e-6 of the parameters, inside the
optax test's 1e-5). The moments, the count and the parameters are updated
in place at fixed addresses. The schedule's ``.host`` is the same formula
in Python, for logging.

With a dictionary split over a mesh's model axis (``model_mesh``, the
trainer's ``shard_dict``) every update is elementwise and stays local to
the rank's rows; only the clip's global norm crosses ranks: Σg² of the
sharded parameters is summed over the model group, and the replicated
ones (TopK's ``b_dec``) count once.
"""

from __future__ import annotations

import math

import torch

from ..parallel import mesh as mesh_lib
from .checkpoint import dict_axes


def make_schedule(scheduler: str, lr: float, steps: int, scheduler_params: dict):
    """count → lr in Python (the function itself, also ``.host``);
    ``.device(count)`` takes a device tensor and returns the lr as a 0-dim
    float64 tensor on its device."""
    if scheduler == "cosine":
        def schedule(count: int) -> float:
            c = min(max(float(count), 0.0), float(steps))
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / steps))

        def device(count: torch.Tensor) -> torch.Tensor:
            c = count.to(torch.float64).clamp(0.0, float(steps))
            return lr * (0.5 * (1.0 + torch.cos(math.pi * c / steps)))
    elif scheduler == "linear":
        warmup = int((scheduler_params or {}).get("num_warmup_steps", 0))

        def schedule(count: int) -> float:
            c = float(count)
            if c < warmup:
                return lr * c / max(warmup, 1)
            return lr * max((steps - c) / max(steps - warmup, 1), 0.0)

        def device(count: torch.Tensor) -> torch.Tensor:
            c = count.to(torch.float64)
            warm = c / max(warmup, 1)
            decay = torch.clamp((steps - c) / max(steps - warmup, 1), min=0.0)
            return lr * torch.where(c < warmup, warm, decay)
    else:
        raise ValueError(f"Invalid scheduler: {scheduler!r}, must be 'cosine' or 'linear'")
    schedule.host = schedule
    schedule.device = device
    return schedule


class SAEOptimizer:
    """Clip → (weight decay) → Adam/RAdam → schedule for one parameter list
    (in the JAX package's leaf order), with the update count, the moments
    and the parameters on the parameters' device."""

    def __init__(self, kind: str, params: list, schedule, clip_thresh: float,
                 weight_decay: float = 0.0, model_mesh=None, variant=None):
        """``model_mesh``: the mesh whose model axis splits the dictionary of
        ``variant``'s parameters (``checkpoint.dict_axes``); None: unsplit."""
        if kind not in ("adam", "radam"):
            raise ValueError(f"Invalid optimizer: {kind!r}, must be 'radam' or 'adam'")
        self.kind = kind
        self.params = params
        self.schedule = schedule
        self.clip_thresh = clip_thresh
        self.weight_decay = weight_decay if kind == "radam" else 0.0
        self.eps = 1e-5 if kind == "radam" else 1e-8
        self.b1, self.b2 = 0.9, 0.999
        dev = params[0].device
        # updates applied; the schedule reads it before the update
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.model_mesh = model_mesh if mesh_lib.model_sharded(model_mesh) else None
        if self.model_mesh is not None:
            # made here: a step captured in a CUDA graph copies nothing from
            # the host
            self._split = torch.tensor([a is not None for a in dict_axes(variant)],
                                       device=dev)

    def global_norm(self, grads: list) -> torch.Tensor:
        """‖g‖ over every parameter; over the whole dictionary when it is
        split (Σg² of the shards summed over the model group, the
        replicated parameters counted once)."""
        norms = torch._foreach_norm(grads)
        if self.model_mesh is None:
            return torch.linalg.vector_norm(torch.stack(norms))
        sq = torch.stack(norms) ** 2
        split = mesh_lib.model_all_reduce(self.model_mesh,
                                          torch.where(self._split, sq, 0.0).sum())
        return torch.sqrt(split + torch.where(self._split, 0.0, sq).sum())

    def step(self) -> None:
        """One update from the parameters' ``.grad``."""
        self.update([p.grad for p in self.params])

    @torch.no_grad()
    def update(self, grads: list) -> None:
        """One update from ``grads`` (the parameters' order), with no host
        synchronisation and no Python value that depends on the count.
        Multi-tensor ops: a launch covers every parameter."""
        norm = self.global_norm(grads)
        # optax clip_by_global_norm: g under the threshold, else scaled to it
        grads = torch._foreach_mul(grads, torch.where(
            norm < self.clip_thresh, 1.0, self.clip_thresh / norm).to(grads[0].dtype))
        if self.weight_decay:
            torch._foreach_add_(grads, self.params, alpha=self.weight_decay)
        lr = self.schedule.device(self.count)
        self.count.add_(1)
        t = self.count.to(torch.float64)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.pow(b1, t)
        b2t = torch.pow(b2, t)
        bc2 = 1.0 - b2t
        torch._foreach_lerp_(self.mu, grads, 1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        # mu_hat / (sqrt(nu_hat) + eps), then · lr
        denom = torch._foreach_mul(self.nu, (1.0 / bc2).float())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, denom)
        del denom
        if self.kind == "radam":
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            ro = ro_inf - 2.0 * t * b2t / bc2
            r = torch.sqrt(torch.clamp(
                (ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro),
                min=0.0))
            # rectified: r · the Adam step; before that, momentum alone
            upd = [torch.where(ro >= 5.0, u * r.float(), m)
                   for u, m in zip(upd, self.mu)]
        torch._foreach_mul_(upd, (lr / bc1).float())
        torch._foreach_sub_(self.params, upd)

    def state_leaves(self) -> list[torch.Tensor]:
        """The state as optax's leaves: [count, mu…, nu…, schedule count]
        (int32 scalars, f32 moments on the parameters' device)."""
        return [self.count.clone(), *self.mu, *self.nu, self.count.clone()]

    @torch.no_grad()
    def load_state_leaves(self, leaves: list) -> None:
        """Copy optax's leaves into the state in place (a captured graph
        keeps reading the same tensors)."""
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
        for dst, leaf in zip(self.mu + self.nu, leaves[1:1 + 2 * n]):
            dst.copy_(torch.as_tensor(leaf))
        # the update count and the schedule's count move together
        self.count.fill_(int(leaves[-1]))


def make_optimizer(optimizer: str, scheduler: str, lr: float, steps: int,
                   params: list, weight_decay: float = 0.0,
                   clip_thresh: float = 1.0,
                   scheduler_params: dict | None = None,
                   model_mesh=None, variant=None):
    """→ (SAEOptimizer, schedule) for ``params`` in the JAX leaf order
    (``model_mesh``, ``variant``: ``SAEOptimizer``'s)."""
    schedule = make_schedule(scheduler, lr, steps, scheduler_params or {})
    return SAEOptimizer(optimizer, params, schedule, clip_thresh,
                        weight_decay=weight_decay, model_mesh=model_mesh,
                        variant=variant), schedule
