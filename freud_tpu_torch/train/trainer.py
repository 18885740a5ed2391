"""SAE trainer on one device (PyTorch).

The port of ``freud_tpu/train/trainer.py``: the same config surface
(``train(**config)``), loss arithmetic, optimizer/scheduler recipes,
dead-feature bookkeeping, TensorBoard tags and checkpoint cadence
(``step{N}.pth`` every ``save_every``, ``bestval.pth`` on an improved
validation, the final step). One step: (L1) renormalise the decoder columns
in place, so the optimizer updates the normalised weight; forward, losses
and backward (TopK: ``models/sae/topk.training_losses``, kernel #4 under
bf16); clip; update; (TopK) age the dead-feature counters. Every piece of
state a step updates (parameters, optimizer moments and count, dead-feature
counters) is updated in place, and a step reads nothing on the host.

Batches come from the mmap loader, one a step, or with ``device_cache_files``
from the device-resident shuffle cache (``data/device_cache.py``), where
``train_chunk`` runs K sample+step pairs at once: on a CUDA device as one
replay of a captured CUDA graph (``train/graph.py``), on the CPU as a loop
of the same body. ``DeviceValSet`` keeps the validation set resident.

Validation transcripts (``enable_transcripts``): the first
``N_TRANSCRIPTS`` validation files are transcribed with the layer's output
replaced by the SAE's reconstruction, and (once) as they are, in one
batched decode each (``WhisperRuntime.transcribe``), and logged as
``val/transcripts/reconstructed_i`` / ``base_i``. An encoder layer's
reconstruction is spliced into the encode as rows; a ``decoder.blocks.N``
store's is made online inside the decode (``decoder_tap``, the SAE
roundtrip of ``analysis/features.py``) from the live SAE parameters, so
validation fetches no rows for it. A decoder sub-module layer has no
steering point: transcripts are off for it, as in JAX.

Decoder-layer stores are EOT-padded past each file's decode: the mmap
loader and the device cache resample the padding rows from valid ones
(``resample_padding_rows``), and so does fly-mode training, keyed on the
file name.

Data parallelism (``mesh``, ``parallel/mesh.py``): one process drives one
card, and each data rank steps on its slice of every global batch. The
parameters start equal on every data rank (broadcast from data rank 0
once); each rank differentiates its part of the GLOBAL loss (the losses'
normalisers are reduced across the data ranks first,
``models/sae/{topk,l1}.py``), the partial gradients and the logged metrics
are summed across the data group in one all-reduce, and the clip and the
update run on the summed gradient. The dead-feature counters age by the
global frame count from the fired mask ORed across the data ranks, so they
stay identical on every rank. With one rank every step equals the
one-process step bit for bit.

The model axis (``shard_dict=True`` on ``make_mesh(model_parallel=P)``,
JAX's ``shard_dict``): each model rank holds ``n_dict / P`` dictionary rows
(L1: columns of W), their optimizer moments and their dead counters; TopK's
``b_dec`` is replicated. The whole dictionary is initialised from the seed
and each rank keeps its rows, so a sharded trainer starts bit-equal to an
unsharded one. A step's losses sum the ranks' partial decodes over the
model group (and TopK selects across the shards, ``ops/topk_sharded``), the
clip's norm sums over it, and everything else is local. Model peers hold
the same batch rows. ``save``/``save_async`` gather the full tensors over
the model group (every rank calls them; rank 0 writes), so the ``.pth``
has the unsharded keys and shapes; ``load`` keeps the rank's rows of a
full checkpoint. With P = 1 ``shard_dict`` changes nothing.

``train(mesh=)`` over several ranks is JAX's pod run: each rank reads its
rows of every global batch (``host_bounds``), or caches and samples its own
file stratum (``process_shard``), and validation, checkpoints, TensorBoard
and transcripts run on rank 0 only. A pod chunk (``train_chunk_pod``) is
one CUDA graph under NCCL, whose collectives capture; under gloo, whose
collectives cannot be captured, it runs its steps eagerly. ``train``
takes no ``shard_dict`` (nor does JAX's): over a 2-D mesh it trains a
replicated dictionary over the data axis.
"""

from __future__ import annotations

import json
import math
import os
import random
import re
import time
import zlib
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .. import profiling
from ..analysis.features import sae_roundtrip_tap_params, sae_steer_fn
from ..audio.decode import load_audio
from ..audio.mel import mels_from_array
from ..constants import get_n_mels
from ..data.device_cache import DeviceShuffleCache, sample_rows_raw
from ..data.loaders import init_dataloader, resample_padding_rows
from ..data.prefetch import prefetch_iter
from ..device import resolve_device
from ..models.sae import config as sae_config
from ..models.sae import l1 as l1_mod
from ..models.sae import topk as topk_mod
from ..models.sae.serialize import params_from_state_dict
from ..models.whisper.runtime import WhisperRuntime, pin_full_f32
from ..ops.topk_fused import topk_sae_decode, topk_sae_encode, topk_sae_forward
from ..ops.topk_sharded import combine_shard_thresholds, shard_candidates
from ..ops.topk_threshold import topk_thresholds_fired
from ..parallel import mesh as mesh_lib
from .checkpoint import (
    AsyncCheckpointWriter,
    dict_axes,
    gather_dict_state,
    load_trainer_checkpoint,
    save_trainer_checkpoint,
    slice_dict_state,
)
from .graph import run_chunk
from .optim import make_optimizer

# the kernel wrappers a train step can launch (their launches are counted
# under graph replay)
STEP_KERNELS = (topk_sae_forward, topk_sae_encode, topk_sae_decode, topk_thresholds_fired,
                shard_candidates, combine_shard_thresholds)
N_TRANSCRIPTS = 4  # validation files transcribed per validation


def set_seeds(seed: int = 42) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def _param_list(variant: str, params) -> list:
    """Parameters in the JAX package's leaf order (the optimizer's)."""
    if variant == "l1":
        return [params.W, params.encoder_bias]
    return [params.encoder_weight, params.encoder_bias, params.W_dec, params.b_dec]


class SAETrainer:
    """Owns the SAE, its optimizer and the dead-feature counters on one
    device (with a ``mesh``, this rank's replica of them)."""

    def __init__(
        self,
        variant: str,
        autoencoder_config: dict,
        activation_size: int,
        optimizer: str = "radam",
        scheduler: str = "cosine",
        scheduler_params: Optional[dict] = None,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        steps: int = 1000,
        clip_thresh: float = 1.0,
        seed: int = 0,
        amp: bool = True,
        device: torch.device | str | None = None,
        mesh=None,
        shard_dict: bool = False,
    ):
        """``device``: default the mesh's card, else the card (``"cpu"`` for
        the CPU; without CUDA anything else raises). ``mesh``: train
        data-parallel over its data axis (``train_step(..., host_local=True)``
        takes this rank's rows; the parameters are broadcast from data rank
        0). ``shard_dict``: split the dictionary over the mesh's model axis
        (module docstring)."""
        assert variant in ("l1", "topk"), (
            f"Invalid autoencoder variant: {variant}, must be 'l1' or 'topk'"
        )
        self.mesh = mesh_lib.check_mesh(mesh)
        if device is None:
            device = (mesh.device if mesh is not None else
                      resolve_device(None, what="trainer",
                                     hint='pass device="cpu" to train on the CPU'))
        # the mesh whose model axis splits the dictionary (None: whole)
        self.model_mesh = mesh if shard_dict and mesh_lib.model_sharded(mesh) else None
        self.variant = variant
        self.raw_config = dict(autoencoder_config)
        self.cfg = sae_config.config_for_variant(variant, autoencoder_config)
        self.activation_size = activation_size
        self.dead_feature_threshold = float(
            autoencoder_config.get("dead_feature_threshold", 1e6))
        # bf16 matmuls in the step (the reference's CUDA autocast); losses
        # and updates stay f32
        self.amp = amp
        self.device = torch.device(device)
        pin_full_f32(self.device)  # f32 products mean f32, not TF32
        init = l1_mod.init_l1 if variant == "l1" else topk_mod.init_topk
        self.n_dict_components = sae_config.get_n_dict_components(
            activation_size, self.cfg.expansion_factor, self.cfg.n_dict_components)
        # the dictionary rows this rank holds (all of them unless sharded)
        self.dict_lo, self.dict_hi = mesh_lib.dict_bounds(self.n_dict_components,
                                                          self.model_mesh)
        if self.model_mesh is None:
            self.params = init(activation_size, self.cfg, seed=seed, device=self.device)
        else:
            # the WHOLE dictionary from the seed (L1's is a QR of the full
            # matrix), then this rank's rows: the start of an unsharded run
            full = init(activation_size, self.cfg, seed=seed, device="cpu")
            self.params = self._shard(full).to(self.device)
        if mesh is not None:
            if torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            # every data rank starts from data rank 0's parameters (one
            # broadcast a model index)
            mesh_lib.broadcast_(mesh, list(self.params.parameters()))
        self.opt, self.schedule = make_optimizer(
            optimizer, scheduler, lr, steps, _param_list(variant, self.params),
            weight_decay=weight_decay, clip_thresh=clip_thresh,
            scheduler_params=scheduler_params, model_mesh=self.model_mesh,
            variant=variant)
        self.num_frames_since_fired = torch.zeros(
            (self.dict_hi - self.dict_lo,), dtype=torch.int32, device=self.device)
        self.step = 0
        self.best_val_loss = float("inf")
        # (n_steps, batch_size) → (window, index buffer, CapturedChunk)
        self._chunks: dict = {}

    def _shard(self, params):
        """This rank's rows of a full parameter module (itself unsharded)."""
        if self.model_mesh is None:
            return params
        kept = slice_dict_state(_param_list(self.variant, params), dict_axes(self.variant),
                                self.model_mesh)
        mod = l1_mod.L1SAE if self.variant == "l1" else topk_mod.TopKSAE
        return mod(*kept)

    # ------------------------------------------------------------- steps

    def _state(self) -> list:
        """Every tensor a step updates in place."""
        return [*_param_list(self.variant, self.params), *self.opt.mu,
                *self.opt.nu, self.opt.count, self.num_frames_since_fired]

    def _step(self, x: torch.Tensor, mesh=None) -> dict:
        """The step body on a (B, T, d) f32 device batch: → metrics as 0-dim
        device tensors. No host synchronisation, no rebinding: a CUDA graph
        replays it. With a ``mesh``, ``x`` is this rank's slice of the global
        batch and the step is the data-parallel one (module docstring); a
        split dictionary's collectives run either way."""
        mm = torch.bfloat16 if self.amp else None
        mmesh = self.model_mesh
        if self.variant == "l1":
            with torch.no_grad():
                self.params.W.copy_(l1_mod.normalize_columns(self.params).W)
        # fresh leaves over the parameters' storage: no autograd node outlives
        # the step (a parameter's own accumulator, made on another stream by
        # an earlier step, would make a captured backward wait on that stream)
        p = SimpleNamespace(**{n: t.detach().requires_grad_()
                               for n, t in self.params.named_parameters()})
        if self.variant == "l1":
            out = l1_mod.forward(p, x, self.cfg, pre_normalized=True, matmul_dtype=mm,
                                 mesh=mesh, model_mesh=mmesh)
            loss = out.reconstruction_loss + out.l1_loss
            metrics = {"loss": loss, "loss_recon": out.reconstruction_loss,
                       "loss_l1": out.l1_loss}
        else:
            dead_mask = self.num_frames_since_fired > self.dead_feature_threshold
            if mmesh is None:
                n_dead, dead_pct = None, dead_mask.float().mean()
            else:  # the whole dictionary's dead count
                n_dead = mesh_lib.model_all_reduce(mmesh, dead_mask.sum().to(torch.float32))
                dead_pct = n_dead / self.n_dict_components
            terms, fired = topk_mod.training_losses(p, x, self.cfg, dead_mask,
                                                    matmul_dtype=mm, mesh=mesh,
                                                    model_mesh=mmesh, n_dead=n_dead)
            loss = terms["fvu"] + terms["auxk_loss"] + terms["multi_topk_fvu"] / 8
            metrics = {"loss": loss, "fvu": terms["fvu"],
                       "auxk_loss": terms["auxk_loss"],
                       "multi_topk_fvu": terms["multi_topk_fvu"],
                       "dead_pct": dead_pct}
        grads = torch.autograd.grad(loss, _param_list(self.variant, p))
        metrics = {k: v.detach() for k, v in metrics.items()}
        frames = x.shape[0] * x.shape[1]
        if mesh is not None:
            # ONE all-reduce over the data group: the partial gradients and
            # this rank's parts of the logged losses (dead_pct is the same on
            # every rank)
            names = [k for k in metrics if k != "dead_pct"]
            *grads, summed = mesh_lib.all_reduce_flat(
                mesh, [*grads, torch.stack([metrics[k] for k in names])])
            metrics.update({k: summed[i] for i, k in enumerate(names)})
            frames *= mesh.data_size
        self.opt.update(grads)
        if self.variant == "topk":
            with torch.no_grad():
                self.num_frames_since_fired.copy_(topk_mod.age_counters(
                    self.num_frames_since_fired, fired, frames))
        return metrics

    def train_step(self, batch, host_local: bool = False) -> dict:
        """One update on a (B, T, d) batch; → metrics as 0-dim device
        tensors (no host sync).

        With a mesh: ``host_local`` marks ``batch`` as this rank's slice of
        the global batch (the pod input path); otherwise ``batch`` is the
        global batch and this rank takes its slice (``put_batch``). A global
        batch that does not divide by the ranks is refused, unless it is
        smaller than the ranks (then every rank steps on all of it, without
        collectives)."""
        mesh = self.mesh
        if mesh is None:
            x = torch.as_tensor(batch).to(self.device, torch.float32, non_blocking=True)
            metrics = self._step(x)
        elif host_local:
            x = mesh_lib.put_host_batch(mesh, batch).to(torch.float32)
            metrics = self._step(x, mesh)
        else:
            b = int(np.shape(batch)[0])
            n_data = mesh.data_size
            if n_data > 1 and b >= n_data and b % n_data:
                raise ValueError(
                    f"training batch of {b} is not divisible by the mesh's data "
                    f"axis ({n_data}); pick a divisible train batch size "
                    "(validation tails may be ragged, training batches must not be)")
            x = mesh_lib.put_batch(mesh, batch).to(torch.float32)
            metrics = self._step(x, mesh if mesh_lib.divisible_batch(b, mesh) else None)
        self.step += 1
        return metrics

    def _chunk_step(self):
        """The step body a chunk runs: the data-parallel one under a process
        group (its collectives at one rank too)."""
        if self.mesh is None or self.mesh.group is None:
            return self._step
        return lambda x: self._step(x, self.mesh)

    def chunk_is_graph(self, window: torch.Tensor) -> bool:
        """Whether a chunk on ``window`` runs as a CUDA graph: on a CUDA
        device, unless its step holds gloo collectives (gloo cannot be
        captured; such a chunk runs its steps eagerly instead). NCCL's
        collectives capture."""
        if window.device.type != "cuda":
            return False
        return self.mesh is None or self.mesh.group is None or self.mesh.backend == "nccl"

    def train_chunk(self, cache: DeviceShuffleCache, batch_size: int, n_steps: int,
                    indices: Optional[torch.Tensor] = None) -> dict:
        """``n_steps`` train steps on batches sampled from ``cache`` (any
        pending refresh applied first, so refresh lands at chunk
        boundaries). → the per-step metric stack, ``{name: (n_steps,)
        device tensor}`` (row i = step ``self.step - n_steps + 1 + i``).

        The chunk's (n_steps, batch_size) window rows are drawn in one
        launch from the cache's generator, or taken from ``indices``. On a
        CUDA device the steps run as one replay of a CUDA graph captured
        once per (n_steps, batch_size) (``train/graph.py``); a step that
        will not capture raises. On the CPU they run as a loop of the same
        body."""
        if self.mesh is not None and self.mesh.data_size > 1:
            raise ValueError("a pod's ranks sample their own strata: use "
                             "train_chunk_pod on a process_shard cache")
        return self._run_chunk(cache, batch_size, n_steps, indices, "train_chunk")

    def _run_chunk(self, cache, batch_size: int, n_steps: int, indices, what: str) -> dict:
        # train_chunk: the host's part (refresh, draw, index copy) and its
        # chunk_replay child
        with profiling.span("train_chunk"):
            window, _ = cache.sample_state()
            if indices is None:
                indices = cache.draw(n_steps, batch_size)
            if tuple(indices.shape) != (n_steps, batch_size):
                raise ValueError(f"indices {tuple(indices.shape)} must be "
                                 f"({n_steps}, {batch_size})")
            metrics = run_chunk(self._chunks, self._chunk_step(), window, indices,
                                self._state(), STEP_KERNELS, f"{what} ({self.variant})",
                                graph=self.chunk_is_graph(window))
            self.step += n_steps
        return metrics

    def train_chunk_pod(self, cache, local_batch: int, n_steps: int,
                        indices: Optional[torch.Tensor] = None) -> dict:
        """The pod counterpart of ``train_chunk``: ``n_steps`` data-parallel
        steps, each on ``local_batch`` rows this rank samples from its own
        cache (a ``process_shard`` stratum), the global batch being every
        rank's rows. → the per-step metric stack (global values).

        As one CUDA graph under NCCL or without a process group; eagerly
        under gloo, whose collectives cannot be captured
        (``chunk_is_graph``). Either way the chunk equals its steps run one
        by one."""
        if self.mesh is None:
            raise ValueError("train_chunk_pod needs a mesh (SAETrainer(mesh=...))")
        return self._run_chunk(cache, local_batch, n_steps, indices, "train_chunk_pod")

    def _build_pod_sampler(self, n_steps: int, batch_size: int):
        """A host-local sampler: ``(window, generator) → ((n_steps,
        batch_size, T, d) rows in the window's storage dtype, generator)``,
        the draw of one ``cache.draw(n_steps, batch_size)`` and its rows (the
        pod chunk samples inside its graph; this stages the same rows for a
        caller that wants them on the host side)."""

        def sampler(window: torch.Tensor, generator: torch.Generator):
            idx = torch.randint(0, window.shape[0], (n_steps, batch_size),
                                generator=generator, device=window.device)
            return sample_rows_raw(window, idx), generator

        return sampler

    def step_working_bytes(self, batch_rows: int) -> int:
        """An estimate of the device bytes a train step needs at
        ``batch_rows`` rows: ~18 bytes per latent entry (the bf16 latent,
        its masks and the backward's bf16 cotangents; 17.3 measured at
        large_v1_audioset's peak), ~40 per input entry, and parameters,
        gradients and both moments. A split dictionary counts this rank's
        rows."""
        n_params = self.param_count()
        width = self.dict_hi - self.dict_lo
        return (batch_rows * (18 * width + 40 * self.activation_size) + 16 * n_params)

    def current_lr(self, step: Optional[int] = None) -> float:
        """The lr of update ``step`` (1-based; default the last one)."""
        count = max((self.step if step is None else step) - 1, 0)
        return float(self.schedule.host(count))

    @torch.no_grad()
    def validate_files(self, batch, sae_out: bool = False) -> dict:
        """Per-file statistics with batch-size-1 semantics (each file is
        its own batch, so the total variance is 0 → 1 and a val fvu is the
        file's squared error): → numpy arrays, one row per file. With
        ``sae_out``, also each file's reconstruction (``sae_out``, f32) and
        the transcript transport head (``sae_out_head``: the first
        N_TRANSCRIPTS reconstructions rounded to bf16, as the JAX package
        fetches them for the validation transcripts). A split dictionary is
        validated by every model rank together (the call is collective),
        each holding the whole file statistics and ``mag`` over every
        feature."""
        x = torch.as_tensor(batch).to(self.device, torch.float32)
        rows = []
        recons = []
        p = self.params
        mmesh = self.model_mesh
        if self.variant == "l1":
            p = l1_mod.normalize_columns(p)
        for xi in x:
            if self.variant == "l1":
                out = l1_mod.forward(p, xi[None], self.cfg, pre_normalized=True,
                                     model_mesh=mmesh)
                rows.append({
                    "recon": out.reconstruction_loss, "l1": out.l1_loss,
                    "mse": torch.mean((out.sae_out[0] - xi) ** 2),
                    "mag": mesh_lib.gather_dict(
                        mmesh, out.encoded.latent[0].abs().amax(dim=0), 0),
                })
            else:
                out = topk_mod.forward(p, xi[None], self.cfg, model_mesh=mmesh)
                # per-feature max |top activation| over the file's frames
                mag = torch.zeros((self.n_dict_components,), device=x.device)
                mag = mag.scatter_reduce(
                    0, out.encoded.top_indices[0].reshape(-1),
                    out.encoded.top_acts[0].abs().reshape(-1), reduce="amax")
                rows.append({
                    "fvu": out.fvu, "auxk_loss": out.auxk_loss,
                    "multi_topk_fvu": out.multi_topk_fvu,
                    "mse": torch.mean((out.sae_out[0] - xi) ** 2), "mag": mag,
                })
            recons.append(out.sae_out[0])
        result = {k: torch.stack([r[k] for r in rows]).cpu().numpy() for k in rows[0]}
        if sae_out:
            full = torch.stack(recons)
            result["sae_out"] = full.cpu().numpy()
            result["sae_out_head"] = (full[:N_TRANSCRIPTS].to(torch.bfloat16)
                                      .float().cpu().numpy())
        return result

    # ------------------------------------------------------- checkpoints

    def hparams(self, **extra) -> dict:
        hp = {
            "autoencoder_variant": self.variant,
            "autoencoder_config": self.raw_config,
            "activation_size": self.activation_size,
        }
        hp.update(extra)
        return hp

    def _extra(self, counter: torch.Tensor) -> dict:
        return {"num_frames_since_fired": counter.detach().cpu().to(torch.int32)}

    def _full_state(self, copy: bool = True):
        """(params module, optimizer leaves, counters) of the WHOLE
        dictionary, as fresh device copies (``copy``) or the live tensors:
        gathered over the model group when it is split (a collective: every
        rank calls it)."""
        def own(t):
            return t.detach().clone() if copy else t.detach()

        with torch.no_grad():
            params = [own(t) for t in _param_list(self.variant, self.params)]
            leaves = [own(t) for t in self.opt.state_leaves()]
            counter = own(self.num_frames_since_fired)
            if self.model_mesh is not None:
                axes = dict_axes(self.variant)
                params = gather_dict_state(params, axes, self.model_mesh)
                # [count, mu…, nu…, count]: the moments mirror the parameters
                leaves = [leaves[0], *gather_dict_state(leaves[1:-1], axes * 2,
                                                        self.model_mesh), leaves[-1]]
                counter = mesh_lib.gather_dict(self.model_mesh, counter, 0)
        mod = l1_mod.L1SAE if self.variant == "l1" else topk_mod.TopKSAE
        return mod(*params), leaves, counter

    def _writes(self) -> bool:
        """Whether this rank writes a checkpoint: rank 0 of a split
        dictionary's mesh; every caller otherwise."""
        return self.model_mesh is None or self.model_mesh.rank == 0

    def save(self, path: str, hparams: dict) -> None:
        """The checkpoint of the whole dictionary. With a split dictionary
        every rank calls it (the gather is collective) and rank 0 writes."""
        params, leaves, counter = self._full_state(copy=False)
        if self._writes():
            save_trainer_checkpoint(
                path, self.variant, params, leaves, self.step, self.best_val_loss,
                hparams, extra=self._extra(counter))

    def save_async(self, paths: list[str], hparams: dict,
                   writer: AsyncCheckpointWriter) -> None:
        """Queue a write-behind checkpoint of the CURRENT state to every path
        in ``paths`` (one snapshot, N disk writes). The snapshot is an
        on-device copy taken now: the next step updates the live tensors in
        place. Host RNG states are captured here, on the training thread.
        With a split dictionary the snapshot is gathered now, on every rank,
        and rank 0 queues the write."""
        params, snap_leaves, snap_fired = self._full_state()
        if not self._writes():
            return
        snap_params = dict(params.named_parameters())
        step, best, variant = self.step, self.best_val_loss, self.variant
        rng_states = (np.random.get_state(), random.getstate())

        def work():
            # checkpoint_d2h splits the device→host copy from the disk write
            with profiling.span("checkpoint_write"):
                with profiling.span("checkpoint_d2h"):
                    host_params = SimpleNamespace(
                        **{k: t.cpu() for k, t in snap_params.items()})
                    host_leaves = [t.cpu() for t in snap_leaves]
                    extra = self._extra(snap_fired)
                with profiling.span("checkpoint_disk"):
                    for path in paths:
                        save_trainer_checkpoint(
                            path, variant, host_params, host_leaves, step, best,
                            hparams, extra=extra, rng_states=rng_states)

        # pure-bestval writes coalesce: a queued superseded snapshot is
        # replaced by the newer one (same path, strictly better loss)
        coalesce = ("bestval" if all(p.endswith("bestval.pth") for p in paths)
                    else None)
        writer.submit(work, coalesce=coalesce)

    def load(self, path: str) -> None:
        """Resume from a checkpoint of the whole dictionary (either
        package's); a split dictionary keeps this rank's rows of it."""
        ckpt, step, best = load_trainer_checkpoint(path)
        loaded = self._shard(params_from_state_dict(self.variant, ckpt["model"]))
        with torch.no_grad():
            for dst, src in zip(_param_list(self.variant, self.params),
                                _param_list(self.variant, loaded)):
                dst.copy_(src)
        optimizer = ckpt.get("optimizer")
        if isinstance(optimizer, dict) and "leaves" in optimizer:
            leaves = list(optimizer["leaves"])
            if self.model_mesh is not None and len(leaves) > 2:
                axes = dict_axes(self.variant)
                leaves = [leaves[0], *slice_dict_state(
                    [torch.as_tensor(np.asarray(v)) for v in leaves[1:-1]], axes * 2,
                    self.model_mesh), leaves[-1]]
            self.opt.load_state_leaves(leaves)
        self.step = step
        self.best_val_loss = best
        if "num_frames_since_fired" in ckpt:
            counter = torch.as_tensor(np.asarray(ckpt["num_frames_since_fired"]),
                                      dtype=torch.int32)
            self.num_frames_since_fired.copy_(counter[self.dict_lo:self.dict_hi])

    def param_count(self) -> int:
        mod = l1_mod if self.variant == "l1" else topk_mod
        return mod.param_count(self.params)


class _NullTB:
    """TensorBoard stand-in when the ``tensorboard`` package is missing, and
    on every rank but rank 0."""

    def _noop(self, *a, **k):
        return None

    add_scalar = add_text = add_histogram = add_audio = close = _noop


def _summary_writer(run_dir: str, verbose: bool):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:  # tensorboard is an optional package
        if verbose:
            print(f"TensorBoard logging is off: the tensorboard package is "
                  f"missing ({e})")
        return _NullTB()
    return SummaryWriter(run_dir, flush_secs=10)


# ---------------------------------------------------------------------------
# Full training entry point (reference train(**config) surface)


def _val_batches(loader):
    """Yield ``(x, n_valid, filenames)`` per loader batch."""
    for batch in loader:
        *arrays, filenames = batch
        if loader.activation_type == "indexed":
            # stores built from a TopK SAE hold (acts, indices); validation
            # operates on dense activations only, as in the reference
            raise ValueError("validation expects dense activation stores")
        x = np.asarray(arrays[0], np.float32)
        yield x, x.shape[0], list(filenames)


class DeviceValSet:
    """Device-resident validation set: the val store uploads ONCE and every
    validation runs on the resident tensors, with no per-call host gather
    or copy. ``ok`` is False when the set exceeds ``max_bytes`` (JAX's
    default 1 GiB) or the store is indexed; callers then stream from the
    loader. ``mesh``: the set lives on the rank's card (``device`` defaults
    to the mesh's); validation runs on rank 0 alone with its local
    parameters, as JAX's pod keeps a single-device placement."""

    def __init__(self, loader, device: torch.device | str | None = None,
                 val_batch: int = 8, max_bytes: int = 1 << 30, mesh=None):
        mesh_lib.check_mesh(mesh)
        if device is None:
            if mesh is None:
                raise ValueError("DeviceValSet needs a device or a mesh")
            device = mesh.device
        self.batches = []
        self.ok = False
        if getattr(loader, "activation_type", "tensor") == "indexed":
            return
        if hasattr(loader, "set_position"):
            loader.set_position(0)
        total = 0
        for x, n_valid, filenames in _val_batches(loader):
            total += x.nbytes
            if total > max_bytes:
                self.batches = []
                return
            self.batches.append((torch.from_numpy(x).to(device), n_valid, filenames))
        self.ok = True

    def __iter__(self):
        return iter(self.batches)


def validate(
    trainer: SAETrainer,
    val_folder: str,
    layer_name: str,
    whisper_model: str,
    from_disk: bool,
    log_base_transcripts: bool = False,
    val_batch: int = 8,
    transcriber=None,
    loader=None,
    device_set: Optional[DeviceValSet] = None,
    substitute_rows: bool = True,
):
    """Reference ``validate`` semantics: per-file losses and MSE
    (batch-size-1 math), per-feature magnitude maxes and stds, and the
    transcripts of the first N_TRANSCRIPTS files whose audio loads (a file
    that fails to load takes no slot) with the layer's output replaced by
    the SAE's reconstruction — and, with ``log_base_transcripts``, as they
    are. Pass a ``loader`` to reuse one across calls, or a ``device_set``
    (an ``ok`` ``DeviceValSet``) to validate on resident tensors; both give
    the same numbers.

    ``transcriber`` is batched: ``transcriber(mels, substitute_values=None)
    → list[str]`` over stacked (B, n_mels, 3000) mels and (B, s, d)
    replacement rows; the slots are padded to N_TRANSCRIPTS so every
    validation decodes one shape. The rows are the bf16 transport head of
    the batch (``validate_files``), or the f32 reconstruction past it, as
    the JAX package fetches them. ``substitute_rows=False`` (decoder-layer
    online steering): the transcriber rebuilds the reconstruction itself,
    so no row is fetched and ``substitute_values`` is a bare ``True``.

    → (losses, subbed_transcripts, base_transcripts, base_filenames,
       magnitude maxes, magnitude stds)."""
    resident = device_set is not None and device_set.ok
    if resident:
        source = device_set
    else:
        if loader is None:
            loader, _, _ = init_dataloader(
                from_disk, val_folder, whisper_model, None, layer_name,
                batch_size=val_batch, shuffle=False,
                resample_padding=layer_name.startswith("decoder."),
                device=trainer.device,
            )
        if hasattr(loader, "set_position"):
            loader.set_position(0)  # a reused loader must scan from the start
        source = _val_batches(loader)
    sums: dict[str, float] = {}
    counts = 0
    mags = []
    pending: list[tuple] = []  # (mel, sae_out row, filename)
    budget = 0  # files offered to the transcripts so far (the resident rule)
    for x, n_valid, filenames in source:
        # the JAX package fetches the transport head for a resident batch
        # while the slots could remain assuming every offered file loads,
        # and for a streamed batch while slots remain
        want_slots = transcriber is not None and len(pending) < N_TRANSCRIPTS
        if resident:
            head_wanted = transcriber is not None and budget < N_TRANSCRIPTS
            budget += n_valid
        else:
            head_wanted = want_slots
        want_rows = want_slots and substitute_rows
        out = trainer.validate_files(x, sae_out=want_rows)
        for key in ("recon", "l1", "fvu", "auxk_loss", "multi_topk_fvu", "mse"):
            if key in out:
                sums[key] = sums.get(key, 0.0) + float(np.sum(out[key]))
        counts += n_valid
        mags.append(out["mag"])
        if not want_slots:
            continue
        head = out["sae_out_head"] if want_rows and head_wanted else None
        for j in range(n_valid):
            if len(pending) >= N_TRANSCRIPTS:
                break
            try:
                audio = load_audio(filenames[j])
            except RuntimeError:
                continue  # a file that does not load takes no slot
            mel = mels_from_array(audio, get_n_mels(whisper_model), device=trainer.device)
            if not substitute_rows:
                row = None
            elif head is not None and j < head.shape[0]:
                row = head[j]
            else:
                row = out["sae_out"][j]
            pending.append((mel, row, filenames[j]))

    subbed: list[str] = []
    base: list[str] = []
    base_filenames: list[str] = []
    if pending:
        n_real = len(pending)
        padded = pending + [pending[-1]] * (N_TRANSCRIPTS - n_real)
        mels = torch.stack([p[0] for p in padded])
        subs = np.stack([p[1] for p in padded]) if substitute_rows else True
        with profiling.span("val_transcripts"):
            subbed = list(transcriber(mels, substitute_values=subs))[:n_real]
            if log_base_transcripts:
                base = list(transcriber(mels))[:n_real]
                base_filenames = [p[2] for p in pending]

    mag_matrix = np.concatenate(mags, axis=0) if mags else np.zeros((0, 1))
    means = {k: v / max(counts, 1) for k, v in sums.items()}
    losses = {k: means.get(k) for k in ("l1", "recon", "fvu", "auxk_loss",
                                        "multi_topk_fvu")}
    losses["mse"] = means.get("mse", 0.0)
    return (
        losses, subbed, base, base_filenames,
        mag_matrix.max(axis=0) if len(mag_matrix) else np.zeros(1),
        mag_matrix.std(axis=0) if len(mag_matrix) else np.zeros(1),
    )


def train(
    seed: int,
    train_folder: str,
    val_folder: str,
    run_dir: str,
    lr: float,
    weight_decay: float,
    steps: int,
    clip_thresh: float,
    batch_size: int,
    log_tb_every: int,
    save_every: int,
    val_every: int,
    whisper_config: dict,
    optimizer: str,
    scheduler: str,
    scheduler_params: dict,
    autoencoder_variant: str,
    autoencoder_config: dict,
    from_disk: bool = True,
    start_checkpoint: Optional[str] = None,
    device: Optional[str] = None,
    dl_max_workers: int = 0,  # accepted for config parity
    mesh=None,
    enable_transcripts: bool = True,
    max_transcript_tokens: int = 224,
    verbose: bool = True,
    device_cache_files: int = 0,
    fused_steps: Optional[int] = None,
    device_cache_dtype: str = "float32",
    val_device_cache: Optional[bool] = None,
) -> dict:
    """``device``: ``cpu`` / ``cuda[:N]``; anything else (the configs'
    ``"tpu"``) means cuda, and a CUDA device without a card raises.

    ``device_cache_files > 0`` (with ``from_disk``; fly mode ignores it, as
    JAX does) trains from a device-resident shuffle cache of that many
    files (``data/device_cache.py``), stored as ``device_cache_dtype``
    (``float32`` or ``bfloat16``). A window that does not fit the device
    raises, naming the largest that fits.

    ``fused_steps``: the chunk of sample+step pairs ``train_chunk`` runs at
    once from the cache (on a CUDA device, one CUDA graph replay). ``None``
    picks the largest divisor of gcd(save_every, val_every) that is at most
    100; ``0``/``1`` trains per step; an explicit value must divide
    save_every and val_every. A resume off a chunk boundary and the tail
    of fewer than ``fused_steps`` steps run per step.

    ``val_device_cache``: keep the validation set resident on the device
    (``DeviceValSet``). ``None`` turns it on when the set fits in 1 GiB,
    ``True`` forces it, ``False`` streams from the loader every call.

    ``mesh`` (``parallel.mesh.make_mesh()`` after
    ``parallel.distributed.initialize()``): train data-parallel on the
    mesh's card (``device`` is then not read). Over several ranks each rank
    reads only its rows of every global batch (``host_shard_bounds``; the
    (seed, epoch) order is the same on every rank), or with
    ``device_cache_files`` caches and samples its own file stratum
    (``batch_size / ranks`` rows a step, in ``train_chunk_pod`` chunks);
    validation, checkpoints, TensorBoard and transcripts run on rank 0
    only. Fly-mode pod training is refused, as in JAX. One rank is the
    one-card run, bit for bit."""
    mesh = mesh_lib.check_mesh(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device, what="training")
    set_seeds(seed)
    layer_name = whisper_config["layer_name"]
    whisper_model = whisper_config["model"]
    decoder_store = layer_name.startswith("decoder.")

    # the pod input path: every rank draws the same (seed, epoch) order and
    # loads only its own contiguous slice of each global batch; host-side
    # artifacts are rank 0's
    host_bounds = None
    multihost = mesh_lib.is_multiprocess(mesh)
    is_main = mesh is None or mesh.rank == 0
    if multihost:
        if not from_disk:
            raise SystemExit(
                "multi-host training requires a collected store (from_disk); "
                "fly-mode pod training is not supported — collect with "
                "data_parallel + per-host shards first")
        host_bounds = mesh_lib.host_shard_bounds(batch_size, mesh)

    loader, feat_dim, _ = init_dataloader(
        from_disk, train_folder, whisper_model, None, layer_name,
        batch_size=batch_size, shuffle=True, drop_last=True, seed=seed,
        resample_padding=decoder_store, device=dev, host_bounds=host_bounds,
    )
    if len(loader) == 0:
        raise ValueError(
            f"{train_folder!r} holds {loader.dataset_length} files, fewer than "
            f"one batch of {batch_size}: there is nothing to train on")
    if getattr(loader, "activation_type", "tensor") == "indexed":
        raise SystemExit(
            f"{train_folder!r} holds an SAE-indexed store (TopK pairs), not "
            "raw activations — training needs a store collected WITHOUT "
            "sae_model")
    if (from_disk and val_folder
            and not (Path(val_folder) / f"{layer_name}_tensors.npy").exists()
            and (Path(val_folder)
                 / f"{layer_name}_activation_values.npy").exists()):
        raise SystemExit(
            f"{val_folder!r} holds an SAE-indexed store (TopK pairs) — "
            "validation needs a store collected WITHOUT sae_model")

    trainer = SAETrainer(
        autoencoder_variant, autoencoder_config, feat_dim,
        optimizer=optimizer, scheduler=scheduler, scheduler_params=scheduler_params,
        lr=lr, weight_decay=weight_decay, steps=steps, clip_thresh=clip_thresh,
        seed=seed, device=dev, mesh=mesh,
    )

    hparam_dict = {
        "autoencoder_variant": autoencoder_variant,
        "autoencoder_config": autoencoder_config,
        "lr": lr,
        "weight_decay": weight_decay,
        "steps": steps,
        "clip_thresh": clip_thresh,
        "batch_size": batch_size,
        "whisper_config": whisper_config,
        "activation_size": feat_dim,
        "train_folder": train_folder,
        "val_folder": val_folder,
        "optimizer": optimizer,
        "scheduler": scheduler,
        "scheduler_params": scheduler_params,
    }

    ckpt_dir = Path(run_dir) / "checkpoints"
    verbose = verbose and is_main
    if is_main:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        tb = _summary_writer(run_dir, verbose)
    else:
        tb = _NullTB()  # the other ranks write no host-side artifacts
    tb.add_text("hparams", json.dumps(hparam_dict, indent=4))
    if verbose:
        print("Model: %.2fM" % (trainer.param_count() / 1e6))

    if start_checkpoint:
        if verbose:
            print(f"Checkpoint: {start_checkpoint}")
        trainer.load(start_checkpoint)
        # deterministic resume: the shuffle order is a pure function of
        # (seed, epoch), so the step count positions the loader exactly
        if hasattr(loader, "set_position"):
            loader.set_position(trainer.step)

    transcriber = None
    decoder_steer_layer = None
    if enable_transcripts and is_main and decoder_store:
        m = re.fullmatch(r"decoder\.blocks\.(\d+)", layer_name)
        if m is None:
            # a decoder sub-module (mlp.0, attn_ln, …) has no online
            # steering point in the decode, and tensor substitution splices
            # the encoder only
            enable_transcripts = False
            if verbose:
                print("transcript logging disabled: decoder-layer "
                      "transcripts steer block outputs (decoder.blocks.N) "
                      f"only, got {layer_name!r}")
        else:
            decoder_steer_layer = int(m.group(1))
    if enable_transcripts and is_main:
        try:
            rt = WhisperRuntime(whisper_model, layer_name,
                                max_new_tokens=max_transcript_tokens, device=dev)
            if decoder_steer_layer is not None:
                steer_fn = sae_steer_fn(trainer.variant, trainer.cfg)

                def transcriber(mels, substitute_values=None):
                    # decoder stores: the reconstruction is spliced in
                    # ONLINE, position by position, from the SAE's live
                    # parameters (updated in place by the steps, also under
                    # graph replay); substitute_values is only a flag here
                    if substitute_values is None:
                        return rt.transcribe(mels)
                    tp = sae_roundtrip_tap_params(trainer.variant, trainer.params)
                    return rt.transcribe(
                        mels, decoder_tap=(decoder_steer_layer, steer_fn, tp))
            else:
                def transcriber(mels, substitute_values=None):
                    # batched: mels (B, n_mels, T), substitute_values
                    # (B, s, d) or None → B transcripts
                    if substitute_values is None:
                        return rt.transcribe(mels)
                    return rt.transcribe(mels, substitute_layer=layer_name,
                                         substitute_value=substitute_values)
        except (FileNotFoundError, ValueError) as e:
            if verbose:
                print(f"transcript logging disabled: {e}")
    logged_base_transcripts = False

    val_loader = None
    val_set = None
    t_start = time.perf_counter()
    steps_done_at_start = trainer.step
    cuda = dev.type == "cuda"

    cache = None
    cache_batch = batch_size
    fused = 0
    if device_cache_files and from_disk:
        rows = batch_size * loader.activation_shape[0]
        if multihost:  # host_shard_bounds checked that the data axis divides it
            cache_batch = batch_size // mesh.data_size
        cache = DeviceShuffleCache(
            train_folder, layer_name, device_cache_files, seed=seed,
            start_step=trainer.step, cache_dtype=device_cache_dtype, device=dev,
            # a pod rank caches and samples its data index's strided file
            # stratum (model peers the same one, with the same draws)
            process_shard=(mesh.data_rank, mesh.data_size) if multihost else None,
            # the graph's private pool and the per-step path's pool each
            # hold a step's working set
            reserve_bytes=2 * trainer.step_working_bytes(
                rows // (mesh.data_size if multihost else 1)))
        # save/val events run host code against the trainer state, so they
        # must land on chunk boundaries; TB logs interior steps from the
        # chunk's stack. The auto chunk stays a DIVISOR of the cadence gcd
        g = math.gcd(save_every, val_every)
        auto = max(k for k in range(1, min(g, 100) + 1) if g % k == 0)
        if fused_steps is None:
            fused = auto if auto > 1 else 0
        elif fused_steps > 1:
            for name, cadence in (("save_every", save_every),
                                  ("val_every", val_every)):
                if cadence % fused_steps:
                    raise ValueError(
                        f"fused_steps={fused_steps} must divide {name}="
                        f"{cadence} (checkpoint/validation events must land "
                        "on chunk boundaries)")
            fused = fused_steps

    def host_batches():
        if decoder_store and not from_disk:
            # fly-mode decoder training: the capture EOT-pads each file's
            # rows past its decode (n_frames, the last element): resample
            # them from valid rows as the disk loaders do, keyed on the file
            # name
            for b in loader.iter_with_lengths():
                x = np.asarray(b[0], np.float32)
                ids = [zlib.crc32(str(n).encode()) for n in b[-2]]
                yield resample_padding_rows(x, ids, b[-1], seed)
        else:
            for b in loader:
                yield np.asarray(b[0], np.float32)

    def batch_stream():
        while True:
            for b in host_batches():
                x = torch.from_numpy(b)
                # on the card, stage the batch in pinned memory here, on the
                # prefetch thread, so the step's host→device copy is async
                yield x.pin_memory() if cuda else x

    def log_train(m: dict, step: int) -> None:
        tb.add_scalar("train/loss", m["loss"], step)
        if autoencoder_variant == "l1":
            tb.add_scalar("train/loss_recon", m["loss_recon"], step)
            tb.add_scalar("train/loss_l1", m["loss_l1"], step)
        else:
            tb.add_scalar("train/fvu", m["fvu"], step)
            tb.add_scalar("train/auxk_loss", m["auxk_loss"], step)
            tb.add_scalar("train/multi_topk_fvu", m["multi_topk_fvu"], step)
            tb.add_scalar("train/dead_pct", m["dead_pct"], step)
        tb.add_scalar("train/lr", trainer.current_lr(step), step)
        if verbose:
            print(f"step {step}: loss {m['loss']:.4f}")

    # the cache serves on-device batches; only the loader needs a prefetch
    # thread
    stream = None if cache is not None else prefetch_iter(batch_stream(), 2)
    ckpt_writer = AsyncCheckpointWriter()
    try:
        while trainer.step < steps:
            if (fused and trainer.step % fused == 0
                    and steps - trainer.step >= fused):
                first = trainer.step + 1
                # train_chunk_wait: the chunk through its synchronisation
                # (the method opens train_chunk inside it)
                with profiling.span("train_chunk_wait"):
                    metrics = (trainer.train_chunk_pod(cache, cache_batch, fused)
                               if multihost
                               else trainer.train_chunk(cache, batch_size, fused))
                    if cuda:
                        torch.cuda.synchronize(dev)
                log_steps = [s for s in range(first, trainer.step + 1)
                             if s % log_tb_every == 0]
                if log_steps:
                    # ONE host fetch of the whole (fused,) stack per chunk
                    names = list(metrics)
                    stack = torch.stack([metrics[k] for k in names]).cpu().numpy()
                    for s in log_steps:
                        log_train({k: float(stack[j, s - first])
                                   for j, k in enumerate(names)}, s)
            else:
                x = cache.next_batch(cache_batch) if cache is not None else next(stream)
                with profiling.span("train_step"):
                    metrics = (trainer.train_step(x, host_local=True) if multihost
                               else trainer.train_step(x))
                    if cuda:
                        # the span covers the step's device work, not its
                        # enqueue
                        torch.cuda.synchronize(dev)
                if trainer.step % log_tb_every == 0:
                    log_train({k: float(v) for k, v in metrics.items()}, trainer.step)

            ckpt_paths: list[str] = []
            if trainer.step % save_every == 0 and is_main:
                ckpt_paths.append(str(ckpt_dir / f"step{trainer.step}.pth"))

            if trainer.step % val_every == 0 and is_main:
                if val_loader is None:
                    val_loader, _, _ = init_dataloader(
                        from_disk, val_folder, whisper_model, None,
                        layer_name, batch_size=8, shuffle=False,
                        resample_padding=decoder_store, device=dev,
                    )
                    if val_device_cache is not False:
                        vs = DeviceValSet(
                            val_loader, dev,
                            max_bytes=(1 << 62) if val_device_cache else (1 << 30))
                        if vs.ok:
                            val_set = vs
                with profiling.span("validate"):
                    (losses_dict, subbed, base_ts, base_files,
                     mag_maxes, mag_stds) = validate(
                        trainer, val_folder, layer_name, whisper_model,
                        from_disk, not logged_base_transcripts,
                        transcriber=transcriber, loader=val_loader,
                        device_set=val_set,
                        substitute_rows=decoder_steer_layer is None)
                logged_base_transcripts = True
                val_keys = (("recon", "l1") if autoencoder_variant == "l1"
                            else ("fvu", "auxk_loss", "multi_topk_fvu"))
                if any(losses_dict.get(k) is None for k in val_keys):
                    print(f"{trainer.step}: validation set empty — skipping "
                          "val logging")
                else:
                    if autoencoder_variant == "l1":
                        tb.add_scalar("val/loss_recon", losses_dict["recon"], trainer.step)
                        tb.add_scalar("val/loss_l1", losses_dict["l1"], trainer.step)
                    else:
                        tb.add_scalar("val/fvu", losses_dict["fvu"], trainer.step)
                        tb.add_scalar("val/auxk_loss", losses_dict["auxk_loss"], trainer.step)
                        tb.add_scalar("val/multi_topk_fvu", losses_dict["multi_topk_fvu"], trainer.step)
                    tb.add_scalar("val/mse", losses_dict["mse"], trainer.step)
                tb.add_histogram("val/encoded/magnitude_maxes", mag_maxes, trainer.step)
                tb.add_histogram("val/encoded/magnitude_stds", mag_stds, trainer.step)
                num_dead = int(np.count_nonzero(mag_maxes <= 0))
                tb.add_scalar("val/encoded/num_dead", num_dead, trainer.step)
                tb.add_scalar("val/encoded/percent_dead",
                              num_dead / mag_maxes.shape[-1], trainer.step)
                for i, t in enumerate(subbed):
                    tb.add_text(f"val/transcripts/reconstructed_{i}", t, trainer.step)
                for i, t in enumerate(base_ts):
                    tb.add_text(f"val/transcripts/base_{i}", t, trainer.step)
                for i, fname in enumerate(base_files):
                    tb.add_audio(f"val/transcripts/audio_{i}",
                                 load_audio(fname).reshape(1, -1), trainer.step,
                                 sample_rate=16000)
                save_loss = (losses_dict["recon"] if autoencoder_variant == "l1"
                             else losses_dict["fvu"])
                if verbose:
                    print(f"{trainer.step} validation: {losses_dict}")
                if save_loss is not None and save_loss < trainer.best_val_loss:
                    trainer.best_val_loss = float(save_loss)
                    ckpt_paths.append(str(ckpt_dir / "bestval.pth"))

            if ckpt_paths:
                trainer.save_async(ckpt_paths, hparam_dict, ckpt_writer)
    finally:
        # close() flushes queued checkpoints, so an interrupted run's resume
        # point is whatever was last submitted, never a torn file
        ckpt_writer.close()
        if cache is not None:
            cache.close()
    if is_main:
        trainer.save(str(ckpt_dir / f"step{trainer.step}.pth"), hparam_dict)
    elapsed = time.perf_counter() - t_start
    done = trainer.step - steps_done_at_start
    tb.close()
    return {
        "steps": trainer.step,
        "steps_per_sec": done / max(elapsed, 1e-9),
        "best_val_loss": trainer.best_val_loss,
        "run_dir": run_dir,
    }
