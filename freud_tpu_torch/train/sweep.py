"""Concurrent SAE sweeps on one device (PyTorch).

The port of ``freud_tpu/train/sweep.py``. Two sweep shapes:

* **per-layer** (``train_sweep``): one recipe over K activation stores, one
  model a store;
* **hyperparameter grid** (``train_hparam_sweep``): K models with their own
  lr / recon_alpha / auxk_alpha over ONE stream. ``k`` is a selection shape,
  so the grid groups its models by k, one trainer a group.

JAX stacks the K models and ``jax.vmap``s one step. The port holds K
members instead: member ``i`` is an ``SAETrainer`` with ``seed + i`` (its
parameters, optimizer and dead-feature counters), and a sweep step runs
each member's step body (``SAETrainer._step``) on its batch, so a TopK
step launches kernel #4 (or #3, where the recipe routes there) once a
member. ``_FusedLosses`` is an ``autograd.Function`` over a ctypes-bound
kernel with no batching rule, so ``torch.func.vmap`` does not apply; a
model axis inside kernel #4 is queued as perf work.

A grid member's hyperparameters are JAX's traced per-model scalars: member
``i`` is a solo trainer built with its own lr and a config that carries its
own recon_alpha (L1) or auxk_alpha (TopK). JAX runs the chain at unit lr
and multiplies by the lr after it; the port's lr inside the schedule
differs from that by rounding (~1e-6 of the parameters).

Through the device cache (``device_cache_files``), ``train_chunk_shared``
runs every member's shared-batch steps over one drawn (n_steps, batch)
index block: on a CUDA device as one replay of a CUDA graph captured once
per (n_steps, batch), on the CPU as a loop of the same body
(``train/graph.py::run_chunk``). ``train_hparam_sweep`` draws each chunk's
indices once and every k-group trains on that same index tensor (JAX's
"snapshot once per chunk"); a tail shorter than a chunk runs per step on
one ``next_batch``.

With a ``mesh`` each member is a data-parallel ``SAETrainer`` on the
mesh: every rank holds the same global batch, steps on its contiguous
slice of the batch axis (``parallel.mesh.put_batch``'s split), and each
member's gradient is all-reduced in that member's step, as JAX shards each
member's batch over the data axis. A chunk's graph policy is the
trainer's (``SAETrainer.chunk_is_graph``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.device_cache import DeviceShuffleCache
from ..data.loaders import MemoryMappedActivationLoader
from ..data.prefetch import prefetch_iter
from ..device import resolve_device
from ..models.sae import config as sae_config
from ..models.sae.serialize import save_checkpoint, state_dict_from_params
from ..parallel import mesh as mesh_lib
from .graph import run_chunk
from .trainer import SAETrainer


class SAESweepTrainer:
    """K SAEs of one recipe on one device, stepped together."""

    def __init__(
        self,
        variant: str,
        autoencoder_config: dict,
        activation_size: int,
        n_models: int,
        optimizer: str = "radam",
        scheduler: str = "cosine",
        scheduler_params: Optional[dict] = None,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        steps: int = 1000,
        clip_thresh: float = 1.0,
        seed: int = 0,
        amp: bool = True,
        mesh=None,
        model_hparams: Optional[Sequence[dict]] = None,
        device: torch.device | str | None = "cuda",
    ):
        """``model_hparams``: one dict per model with any of
        {"lr", "recon_alpha"} (l1) / {"lr", "auxk_alpha", "k"} (topk);
        missing keys inherit the trainer-level value. All models in ONE
        trainer must share ``k`` (it is a selection shape); use
        ``train_hparam_sweep`` to grid over k via k-groups. ``device``:
        ``cpu`` / ``cuda[:N]``; anything else means cuda (with a ``mesh``,
        its card)."""
        assert variant in ("l1", "topk")
        self.mesh = mesh_lib.check_mesh(mesh)
        self.variant = variant
        self.raw_config = dict(autoencoder_config)
        self.cfg = sae_config.config_for_variant(variant, autoencoder_config)
        self.model_hparams = None
        if model_hparams is not None:
            if len(model_hparams) != n_models:
                raise ValueError(
                    f"{len(model_hparams)} hparam dicts for {n_models} models")
            allowed = ({"lr", "recon_alpha"} if variant == "l1"
                       else {"lr", "auxk_alpha", "k"})
            for hp in model_hparams:
                bad = set(hp) - allowed
                if bad:
                    raise ValueError(
                        f"unsupported sweep hparam(s) {sorted(bad)}; "
                        f"{variant} sweeps vary {sorted(allowed)}")
            ks = {hp.get("k", self.cfg.k) for hp in model_hparams} \
                if variant == "topk" else set()
            if len(ks) > 1:
                raise ValueError(
                    f"models in one sweep trainer must share k (got {sorted(ks)});"
                    " group by k (train_hparam_sweep does)")
            if ks:
                self.cfg.k = int(next(iter(ks)))
                self.raw_config["k"] = self.cfg.k
            self.model_hparams = [dict(hp) for hp in model_hparams]
        self.n_models = n_models
        self.activation_size = activation_size
        self.n_dict_components = sae_config.get_n_dict_components(
            activation_size, self.cfg.expansion_factor, self.cfg.n_dict_components)
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device, what="sweep"))
        alpha_key = "recon_alpha" if variant == "l1" else "auxk_alpha"
        self.members: list[SAETrainer] = []
        for i in range(n_models):
            hp = self.model_hparams[i] if self.model_hparams is not None else {}
            member_config = dict(self.raw_config)
            if alpha_key in hp:
                member_config[alpha_key] = hp[alpha_key]
            self.members.append(SAETrainer(
                variant, member_config, activation_size, optimizer=optimizer,
                scheduler=scheduler, scheduler_params=scheduler_params,
                lr=hp.get("lr", lr), weight_decay=weight_decay, steps=steps,
                clip_thresh=clip_thresh, seed=seed + i, amp=amp, device=self.device,
                mesh=mesh))
        self.step = 0
        # (n_steps, batch_size) → (window, index buffer, CapturedChunk)
        self._chunks: dict = {}

    # ------------------------------------------------------------- steps

    @property
    def metric_names(self) -> tuple:
        """JAX's sweep metrics, each a (K,) stack."""
        return (("loss", "loss_recon", "loss_l1") if self.variant == "l1"
                else ("loss", "fvu"))

    def _state(self) -> list:
        return [t for m in self.members for t in m._state()]

    def _step_all(self, x: torch.Tensor, shared: bool, mesh=None) -> dict:
        """Every member's step body: on the one (B, T, d) device batch
        ``x`` when ``shared``, else member i on ``x[i]`` → {name: (K,)
        device tensor}. With a ``mesh``, ``x`` holds this rank's rows."""
        outs = [m._step(x if shared else x[i], mesh) for i, m in enumerate(self.members)]
        return {k: torch.stack([o[k] for o in outs]) for k in self.metric_names}

    def _to_device(self, batch, axis: int = 0):
        """The batch on the device as f32 → (tensor, the mesh its steps
        reduce over). With a mesh, this rank's slice of the batch axis
        ``axis``; a batch axis that does not divide by the ranks stays whole
        and steps without collectives."""
        mesh = self.mesh
        if mesh is None:
            return torch.as_tensor(batch).to(self.device, torch.float32,
                                             non_blocking=True), None
        b = int(np.shape(batch)[axis])
        if not mesh_lib.divisible_batch(b, mesh):
            return mesh_lib.put_host_batch(mesh, batch).to(torch.float32), None
        lo, hi = mesh_lib.host_shard_bounds(b, mesh)
        local = batch[:, lo:hi] if axis == 1 else batch[lo:hi]
        return mesh_lib.put_host_batch(mesh, local).to(torch.float32), mesh

    def train_step(self, batches) -> dict:
        """``batches``: (K, B, T, activation_size), member i's batch at
        row i. → {name: (K,) device tensor} (no host sync)."""
        if np.ndim(batches) != 4 or np.shape(batches)[0] != self.n_models:
            raise ValueError(f"batches {tuple(np.shape(batches))} must be "
                             f"({self.n_models}, B, T, d)")
        x, mesh = self._to_device(batches, axis=1)
        metrics = self._step_all(x, shared=False, mesh=mesh)
        self.step += 1
        return metrics

    def train_step_shared(self, batch) -> dict:
        """One (B, T, activation_size) batch trains ALL K models (the
        hyperparameter-grid stream): moved to the device once."""
        x, mesh = self._to_device(batch)
        metrics = self._step_all(x, shared=True, mesh=mesh)
        self.step += 1
        return metrics

    def train_chunk_shared(self, window: torch.Tensor, indices: torch.Tensor) -> dict:
        """Shared-batch steps of every member on rows of a cache's window
        (``cache.sample_state()[0]``), one step a row of the (n_steps,
        batch_size) ``indices`` (``cache.draw``): ``train_hparam_sweep`` draws them
        once a chunk and hands every k-group the same tensor. On a CUDA
        device the steps run as one replay of a CUDA graph captured once per
        (n_steps, batch_size); a step that will not capture raises. On the
        CPU they run as a loop of the same body. → the last step's metrics,
        each a (K,) device tensor."""
        mesh = self.mesh
        if mesh is not None and mesh.group is not None:
            # every rank draws the same indices (one seed); each steps on
            # its slice of every step's rows
            lo, hi = mesh_lib.host_shard_bounds(indices.shape[1], mesh)
            indices = indices[:, lo:hi]
        else:
            mesh = None
        lead = self.members[0]
        stack = run_chunk(
            self._chunks, lambda x: self._step_all(x, shared=True, mesh=mesh), window,
            indices, self._state(),
            f"train_chunk_shared ({self.variant}, {self.n_models} models)",
            graph=lead.chunk_is_graph(window))
        self.step += indices.shape[0]
        return {k: v[-1] for k, v in stack.items()}

    def save_all(self, out_dir: str, layer_names: Sequence[str], hparams: dict) -> None:
        """One reference-format checkpoint per layer."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for member, layer in zip(self.members, layer_names):
            save_checkpoint(
                str(out / f"{layer}.pth"),
                {
                    "model": state_dict_from_params(self.variant, member.params),
                    "step": self.step,
                    "best_val_loss": float("inf"),
                    "hparams": {**hparams, "layer_name": layer},
                },
            )


def expand_grid(grid: dict) -> list[dict]:
    """{"lr": [a, b], "k": [2, 4]} → the 4 combination dicts (sorted keys,
    row-major over the given value orders)."""
    keys = sorted(grid)
    combos = [{}]
    for key in keys:
        vals = grid[key]
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        combos = [{**c, key: v} for c in combos for v in vals]
    return combos


def _hp_tag(hp: dict) -> str:
    return "_".join(f"{k}{hp[k]:g}" if isinstance(hp[k], float)
                    else f"{k}{hp[k]}" for k in sorted(hp)) or "base"


def train_hparam_sweep(
    data_path: str,
    layer_name: str,
    variant: str,
    autoencoder_config: dict,
    grid: dict,
    steps: int,
    batch_size: int,
    out_dir: str,
    lr: float = 1e-4,
    optimizer: str = "adam",
    scheduler: str = "linear",
    scheduler_params: Optional[dict] = None,
    seed: int = 0,
    verbose: bool = True,
    device_cache_files: int = 0,
    fused_steps: int = 10,
    device_cache_dtype: str = "float32",
    device: Optional[str] = "cuda",
) -> dict:
    """Hyperparameter-grid sweep over ONE layer store: every grid point is a
    member of a sweep trainer, all fed the SAME batch stream (one mmap read
    and one host→device copy a step, whatever K). Members group by ``k``
    (topk), one trainer a k value; lr / recon_alpha / auxk_alpha are each
    member's own. Checkpoints land at ``<out_dir>/<hparam-tag>.pth``
    (reference format).

    ``device_cache_files > 0`` feeds the sweep from a device shuffle cache
    with ``fused_steps`` steps a chunk (``train_chunk_shared``); every
    k-group trains on the identical index tensor of each chunk. ``device``:
    ``cpu`` / ``cuda[:N]``; anything else means cuda, and a CUDA device
    without a card raises."""
    dev = resolve_device(device, what="sweep")
    combos = expand_grid(grid)
    groups: dict[object, list[dict]] = {}
    for hp in combos:
        groups.setdefault(hp.get("k"), []).append(hp)

    loader = MemoryMappedActivationLoader(
        data_path, layer_name, batch_size, shuffle=True, drop_last=True,
        seed=seed, resample_padding=layer_name.startswith("decoder."))
    if len(loader) == 0:
        raise ValueError(
            f"layer store yields no batches at batch_size={batch_size}")
    act_size = loader.activation_shape[-1]

    trainers = {
        k: SAESweepTrainer(
            variant, autoencoder_config, act_size, len(hps),
            optimizer=optimizer, scheduler=scheduler,
            scheduler_params=scheduler_params, lr=lr, steps=steps, seed=seed,
            model_hparams=hps, device=dev,
        )
        for k, hps in groups.items()
    }

    # k-group → (K,) device tensor of its last step's losses, held without a
    # fetch; one host copy at the end feeds each model's ``final_loss``
    last: dict = {}

    def _shown() -> dict:
        return {str(k): v.tolist() for k, v in last.items()}

    step = 0
    if device_cache_files:
        fused = max(int(fused_steps), 1)
        rows = batch_size * loader.activation_shape[0]
        step_bytes = next(iter(trainers.values())).members[0].step_working_bytes(rows)
        cache = DeviceShuffleCache(
            data_path, layer_name, device_cache_files, seed=seed,
            cache_dtype=device_cache_dtype, device=dev,
            # each k-group's graph pool and the per-step path's pool hold a
            # step's working set
            reserve_bytes=(len(trainers) + 1) * step_bytes)
        try:
            while step < steps:
                if steps - step >= fused and fused > 1:
                    window, _ = cache.sample_state()
                    indices = cache.draw(fused, batch_size)
                    for k, tr in trainers.items():
                        last[k] = tr.train_chunk_shared(window, indices)["loss"]
                    step += fused
                else:
                    # tail shorter than a chunk: per step (a tail-sized chunk
                    # would capture a fresh graph per k-group)
                    x = cache.next_batch(batch_size)
                    for k, tr in trainers.items():
                        last[k] = tr.train_step_shared(x)["loss"]
                    step += 1
                if verbose:
                    print(f"hparam sweep step {step}: loss {_shown()}")
        finally:
            cache.close()
    else:
        def batches():
            while True:
                for b in loader:
                    x = torch.from_numpy(np.asarray(b[0], np.float32))
                    yield x.pin_memory() if dev.type == "cuda" else x

        it = prefetch_iter(batches(), 2)
        try:
            while step < steps:
                x = next(it).to(dev, non_blocking=True)
                for k, tr in trainers.items():
                    last[k] = tr.train_step_shared(x)["loss"]
                step += 1
                if verbose and step % 10 == 0:
                    print(f"hparam sweep step {step}: loss {_shown()}")
        finally:
            it.close()

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    final_losses = {k: v.detach().cpu().numpy().reshape(-1) for k, v in last.items()}
    results = []
    for k, tr in trainers.items():
        for i, hp in enumerate(groups[k]):
            tag = _hp_tag(hp)
            # the stored config carries THIS model's grid values so a later
            # sae_from_checkpoint reconstructs the exact recipe
            cfg_out = {**tr.raw_config,
                       **{kk: v for kk, v in hp.items() if kk != "lr"}}
            save_checkpoint(
                str(out / f"{tag}.pth"),
                {
                    "model": state_dict_from_params(variant, tr.members[i].params),
                    "step": tr.step,
                    "best_val_loss": float("inf"),
                    "hparams": {
                        "autoencoder_variant": variant,
                        "autoencoder_config": cfg_out,
                        "activation_size": act_size,
                        "layer_name": layer_name,
                        "lr": hp.get("lr", lr),
                    },
                },
            )
            row = {"tag": tag, **hp}
            if k in final_losses:
                row["final_loss"] = float(final_losses[k][i])
            results.append(row)
    return {"steps": step, "models": results, "out_dir": out_dir}


def train_sweep(
    data_path: str,
    layer_names: Sequence[str],
    variant: str,
    autoencoder_config: dict,
    steps: int,
    batch_size: int,
    out_dir: str,
    lr: float = 1e-4,
    optimizer: str = "adam",
    scheduler: str = "linear",
    scheduler_params: Optional[dict] = None,
    seed: int = 0,
    verbose: bool = True,
    device: Optional[str] = "cuda",
) -> dict:
    """Train one SAE per layer store (all under ``data_path``) together.
    ``device`` as in ``train_hparam_sweep``."""
    dev = resolve_device(device, what="sweep")
    loaders = [
        MemoryMappedActivationLoader(
            data_path, layer, batch_size, shuffle=True, drop_last=True,
            seed=seed, resample_padding=layer.startswith("decoder."),
        )
        for layer in layer_names
    ]
    act_size = loaders[0].activation_shape[-1]
    assert all(ld.activation_shape[-1] == act_size for ld in loaders), (
        "sweep layers must share an activation width"
    )
    trainer = SAESweepTrainer(
        variant, autoencoder_config, act_size, len(layer_names),
        optimizer=optimizer, scheduler=scheduler, scheduler_params=scheduler_params,
        lr=lr, steps=steps, seed=seed, device=dev,
    )
    for ld in loaders:
        if len(ld) == 0:
            raise ValueError(
                f"layer store yields no batches at batch_size={batch_size} "
                "(fewer files than one batch with drop_last) — shrink the "
                "batch or grow the store"
            )

    def stacked():
        # one gather a layer store a step, stacked on the prefetch thread
        # (and pinned there on the card): disk reads of step N+1 overlap
        # step N
        iters = [iter(ld) for ld in loaders]
        while True:
            batch = []
            for i, ld in enumerate(loaders):
                try:
                    arrays = next(iters[i])
                except StopIteration:
                    iters[i] = iter(ld)
                    arrays = next(iters[i])
                batch.append(np.asarray(arrays[0], np.float32))
            x = torch.from_numpy(np.stack(batch))
            yield x.pin_memory() if dev.type == "cuda" else x

    it = prefetch_iter(stacked(), 2)
    metrics: dict = {}
    last: dict = {}
    try:
        while trainer.step < steps:
            metrics = trainer.train_step(next(it))
            if verbose and trainer.step % 10 == 0:
                # metric fetch only on the log interval: a fetch syncs
                last = {k: v.tolist() for k, v in metrics.items()}
                print(f"sweep step {trainer.step}: loss {last['loss']}")
    finally:
        it.close()
    if metrics:
        last = {k: v.tolist() for k, v in metrics.items()}
    hparams = {
        "autoencoder_variant": variant,
        "autoencoder_config": autoencoder_config,
        "activation_size": act_size,
    }
    trainer.save_all(out_dir, layer_names, hparams)
    return {"steps": trainer.step, "final": last, "out_dir": out_dir}
