"""Activation loaders: on-the-fly (Whisper → SAE) and memory-mapped.

The port of ``freud_tpu/data/loaders.py``:

* ``FlyActivationLoader``: audio batches stream through the native decoder
  → on-device mel → for an encoder layer one encoder forward that stops
  after the captured layer, for a ``decoder.*`` layer the runtime's
  ``decode_capture`` (greedy decode, then a teacher-forced captured pass)
  → with an attached SAE, its encode on the same device.
  ``iter_with_lengths`` yields (activations, filenames, n_frames); an L1 SAE
  yields its dense latent, a TopK SAE the pair (top_acts, top_indices).
  A decoder layer's n_frames are the positions each clip's decode
  processed, computed on the device and fetched with the batch.
* ``MemoryMappedActivationLoader``: shuffled batches gathered from a
  collected store, the order a pure function of (seed, epoch), so a step
  count is a resume position. Framework-free, as in the JAX package.

Over several ranks (``parallel/mesh.py``): ``host_bounds`` makes the mmap
loader read only this rank's rows of every global batch, and the fly
loader takes ``shard`` (every n-th file, a pod collection's split) and
``mesh`` (each rank encodes its slice of every batch, and the batch is
gathered whole on every rank, as JAX's sharded batch is one global array).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .. import profiling
from ..analysis.features import activation_length_from_samples
from ..models.sae import config as sae_config
from ..models.sae import l1 as l1_mod
from ..models.sae import serialize as sae_serialize
from ..models.sae import topk as topk_mod
from ..models import audio_lm_runtime
from ..models.whisper import WhisperRuntime
from ..device import resolve_device
from ..parallel import mesh as mesh_lib
from .audio_dataset import AudioBatchPipeline
from .store import ActivationStoreReader


def decodable_mask(lengths: np.ndarray, filenames: list[str]) -> np.ndarray:
    """Per-file decode-degrade policy: lengths < 0 mark undecodable files —
    warn once per batch and return the keep mask."""
    ok = lengths >= 0
    if not ok.all():
        bad = [f for f, good in zip(filenames, ok) if not good]
        print(f"skipping {len(bad)} undecodable file(s): {bad[:3]}…")
    return ok


def load_sae(checkpoint: str, device: torch.device | str = "cpu"):
    """(variant, cfg, activation_size, module) from a trainer checkpoint."""
    return sae_serialize.sae_from_checkpoint(checkpoint, device)


def resample_padding_rows(
    x: np.ndarray,
    file_indices,
    n_frames,
    seed: int,
) -> np.ndarray:
    """Replace each file's padding rows with draws from its VALID rows.

    Decoder-layer stores are EOT-padded: row ``t >= n_frames[f]`` of file
    ``f`` is teacher-forced garbage past the position where greedy decode
    sampled EOT (the JAX package's decoder capture) — often the majority of
    the (n_prompt + max_new) buffer for short transcripts. Training consumes
    full fixed-shape (B, T, d) batches, so instead of masking inside every
    loss and kernel, the padding rows are RESAMPLED uniformly from the
    file's valid rows at load time: each file still contributes exactly T
    frames, every frame is a real decode position, and the train/val stack
    downstream is untouched.

    Deterministic per (seed, file index): reloading a file in any epoch
    reproduces the identical rows. Mutates and returns ``x`` (callers pass
    freshly-gathered batches). Files with ``n_frames == 0`` (undecodable
    audio stored as zeros) are left as-is.
    """
    t = x.shape[1]
    for row, (fi, n) in enumerate(zip(file_indices, n_frames)):
        n = int(n)
        if 0 < n < t:
            rng = np.random.default_rng((seed, int(fi)))
            x[row, n:] = x[row, rng.integers(0, n, t - n)]
    return x


def _sae_tail(acts: torch.Tensor, sae) -> tuple:
    """The attached SAE's encode of captured activations (the JAX package's
    ``_sae_fetch_tail``): dense → (acts,); L1 → (latent,); TopK →
    (top_acts, top_indices)."""
    if sae is None:
        return (acts,)
    variant, cfg, params = sae
    x = acts.to(torch.float32)  # JAX promotes a bf16 capture against f32 params
    if variant == "l1":
        return (l1_mod.encode(params, x).latent,)
    enc = topk_mod.encode(params, x, cfg)
    return (enc.top_acts, enc.top_indices)


class DeviceFetch:
    """A device→host copy in flight: pinned host memory filled by an
    asynchronous copy, with the CUDA event that marks its end.
    ``np.asarray(fetch)`` waits for that event only — not for the work
    queued behind it (the next batch's encode) — so the consumer's fetch
    overlaps the device's next batch."""

    def __init__(self, src: torch.Tensor):
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        self.host.copy_(src, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def __array__(self, dtype=None, copy=None):
        self.event.synchronize()
        arr = self.host.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


class FlyActivationLoader:
    """Compute Whisper (and optionally SAE) activations on the fly."""

    def __init__(
        self,
        data_path: str,
        whisper_model: str,
        sae_checkpoint: Optional[str],
        layer_name: str,
        batch_size: int,
        subset_size: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
        decode_threads: int | None = None,
        exclude: set | None = None,
        fetch_dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        drop_last: bool = False,
        max_new_tokens: int = 224,
        mesh=None,
        shard: tuple[int, int] | None = None,
        model_weights: tuple | None = None,
    ):
        """``whisper_model`` names a Whisper model or an audio language
        model (``uni-moe-2.0-omni``, ``longcat-flash-omni``, or its checkpoint
        directory), whose taps are ``lm.layers.N`` (a clip's audio tokens)
        and ``encoder.blocks.N`` (its Whisper tower); ``model_weights=
        (hf_config, state_dict)`` hands its weights over in memory (the
        loader takes the state dict's tensors; the config's ``model_type``
        picks the model). Its per-layer router counts ride to the host with
        each batch's fetch and are recorded as its runtime's counter
        (``moe.tokens``, ``longcat.routes``; ``profiling.count``) when the
        batch is yielded.

        ``max_new_tokens`` sizes a decoder layer's capture buffer
        (n_prompt + max_new_tokens rows a file); encoder layers ignore it.
        ``device``: default the mesh's card, else the card (``"cpu"`` for
        the CPU; without CUDA anything else raises).

        ``mesh``: split the encoder's work over the ranks: every rank
        decodes and runs the log-mel on the whole batch, encodes its
        contiguous slice of it (the batch padded to ``batch_size``, which
        must divide by the ranks) and the slices are gathered, so every
        rank yields the whole batch. ``shard=(i, n)``: process only every
        n-th file starting at i, the pod collection's split (merge the
        per-rank stores with ``scripts/merge_stores.py``)."""
        self.mesh = mesh_lib.check_mesh(mesh)
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device, what="fly loader",
                                     hint='pass device="cpu" to run it on the CPU')
        if mesh is not None:
            if self.device != mesh.device:
                raise ValueError(f"device {self.device} is not the mesh's {mesh.device}")
            if batch_size % mesh.data_size:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the mesh's data "
                    f"axis ({mesh.data_size})")
        lm_runtime = audio_lm_runtime(whisper_model, model_weights)
        if lm_runtime is not None:
            if mesh is not None or shard is not None:
                raise ValueError(f"{lm_runtime.MODEL} collects on one card (no mesh or shard)")
            self.runtime = lm_runtime(whisper_model, layer_name, compute_dtype=compute_dtype,
                                      device=self.device, weights=model_weights)
        else:
            self.runtime = WhisperRuntime(whisper_model, layer_name,
                                          compute_dtype=compute_dtype,
                                          max_new_tokens=max_new_tokens,
                                          device=self.device)
        self._counters = getattr(self.runtime, "counters", None)
        self._counter_name = getattr(self.runtime, "COUNTER", None)
        self._decoder_layer = layer_name.startswith("decoder.")
        self.batch_size = batch_size
        # the sequential-scan guard of analysis/search.py reads both
        self.shuffle = False
        self.drop_last = drop_last
        self.fetch_dtype = fetch_dtype
        self.pipeline = AudioBatchPipeline(
            data_path,
            batch_size,
            self.runtime.dims.n_mels,
            subset_size=subset_size,
            decode_threads=decode_threads,
            exclude=exclude,
            device=self.device,
            drop_last=drop_last,
            shard=shard,
        )
        self.sae = None
        self.activation_type = "tensor"
        width = self.runtime.activation_width
        if sae_checkpoint:
            variant, cfg, _, params = load_sae(sae_checkpoint, self.device)
            self.sae = (variant, cfg, params.eval())
            if variant == "topk":
                self.activation_type = "indexed"
            # reported like the reference: (T, n_dict) for both variants,
            # though a TopK store's rows are (T, k) indexed pairs
            width = sae_config.get_n_dict_components(
                width, cfg.expansion_factor, cfg.n_dict_components)
        self.activation_shape = (self.runtime.activation_frames, width)

    @property
    def dataset_length(self) -> int:
        return self.pipeline.dataset_length

    def __len__(self) -> int:
        return len(self.pipeline)

    def _compute(self, mels: torch.Tensor, n: int, fetch: bool = True):
        """The batch's outputs; with ``fetch`` False they stay on the
        device as tensors (floats in f32) instead of starting their host
        copies."""
        split = mesh_lib.is_multiprocess(self.mesh)
        pad = self.batch_size - n if mels.is_cuda else 0
        if split:
            # this rank's slice of the batch padded to its shape
            lo, _ = mesh_lib.host_shard_bounds(self.batch_size, self.mesh)
            mels = mesh_lib.pad_and_shard(self.mesh, mels, self.batch_size)
        elif pad:
            # on the card, pad the ragged tail to the batch shape so every
            # batch runs the same kernel shapes (one shape for a CUDA graph
            # to capture later); padded rows trim below. The CPU path runs
            # the tail as it is.
            mels = torch.cat([mels, mels.new_zeros((pad, *mels.shape[1:]))])
        with profiling.span("encoder_capture"):
            acts, n_valid = self.runtime.activations_with_lengths(mels)
            with torch.inference_mode():
                outs = _sae_tail(acts, self.sae)
        if self._decoder_layer:
            # the decode's valid positions ride with the batch's fetch
            outs = (*outs, n_valid)
        if split:
            # every rank's slice, bit for bit, on every rank
            outs = tuple(mesh_lib.gather_rows(self.mesh, o, lo, self.batch_size)
                         for o in outs)
        fetched = []
        for o in outs:
            if pad or split:
                o = o[:n]
            if not fetch:
                fetched.append(o.to(torch.float32) if o.is_floating_point() else o)
                continue
            if o.is_floating_point():
                if self.fetch_dtype is not None:
                    # cast on the device before the host fetch: a float16
                    # store then moves half the bytes
                    o = o.to(self.fetch_dtype)
                elif o.dtype == torch.bfloat16:
                    # numpy has no bfloat16; the store keeps float32
                    o = o.to(torch.float32)
            # on the card, start the device→host copy now, ahead of the next
            # batch's work
            fetched.append(DeviceFetch(o) if o.is_cuda else o)
        if self._counters is not None:
            # the router's counts, copied behind the batch's outputs
            table = self._counters()
            fetched.append(DeviceFetch(table) if fetch and table.is_cuda else table.clone())
        return tuple(fetched)

    def __iter__(self) -> Iterator[tuple]:
        """Yields (*outputs, filenames), undecodable files dropped."""
        for *outs, filenames, _ in self.iter_with_lengths():
            yield (*(np.asarray(o) for o in outs), filenames)

    def iter_with_lengths(self, fetch: bool = True) -> Iterator[tuple]:
        """Yields (activations, filenames, n_frames): per-file true
        activation frame counts beside each batch. ``fetch=False`` yields
        the activations as device tensors (search reduces them where they
        are).

        Files the decoder could not read (length < 0) are dropped from the
        batch. The loop runs one batch ahead: batch k+1's mel and encode are
        queued on the device (CUDA launches return at once) before batch k
        is yielded, so the device computes k+1 while the consumer waits on
        k's device→host copy and writes the store."""
        pending = None
        for mels, filenames, lengths in self.pipeline:
            outs = self._compute(mels, len(filenames), fetch=fetch)
            if pending is not None:
                yield self._finalize(*pending)
            pending = (outs, filenames, lengths)
        if pending is not None:
            yield self._finalize(*pending)

    def _finalize(self, outs, filenames, lengths):
        if self._counters is not None:
            *outs, table = outs
            profiling.count(self._counter_name, table)
        ok = decodable_mask(lengths, filenames)
        if not ok.all():
            outs = tuple(o[torch.from_numpy(ok).to(o.device)]
                         if isinstance(o, torch.Tensor) else np.asarray(o)[ok]
                         for o in outs)
            filenames = [f for f, good in zip(filenames, ok) if good]
            lengths = lengths[ok]
        if self._decoder_layer:
            # a decoder layer's true length is the positions its decode
            # processed (the last output): the audio length says nothing of
            # the transcript's
            *outs, n_valid = outs
            if isinstance(n_valid, torch.Tensor):
                n_valid = n_valid.cpu()
            return (*outs, filenames, np.asarray(n_valid, np.int64))
        length = getattr(self.runtime, "activation_length", activation_length_from_samples)
        n_frames = np.asarray([length(int(n)) for n in lengths], np.int64)
        return (*outs, filenames, n_frames)


class MemoryMappedActivationLoader:
    """Batched reader over a collected activation store."""

    def __init__(
        self,
        data_path: str,
        layer_name: str,
        batch_size: int,
        subset_size: Optional[int] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        resample_padding: bool = False,
        host_bounds: Optional[tuple] = None,
    ):
        """``resample_padding``: replace EOT-padding rows of decoder-layer
        stores with per-file-deterministic draws from the valid rows (see
        ``resample_padding_rows``).

        ``host_bounds=(lo, hi)``: the pod input path. Every rank computes
        the SAME (seed, epoch) order, and this loader yields only rows
        [lo, hi) of each global batch (``parallel.mesh.host_shard_bounds``).
        It needs ``drop_last``, so every global batch is full; ``len`` and
        the position count global batches, one a train step."""
        if host_bounds is not None:
            lo, hi = host_bounds
            if not (0 <= lo < hi <= batch_size):
                raise ValueError(f"host_bounds {host_bounds} outside the "
                                 f"global batch of {batch_size}")
            if not drop_last:
                raise ValueError(
                    "host_bounds requires drop_last=True (a ragged global "
                    "tail would misalign the per-host slices)")
        self.host_bounds = host_bounds
        self.reader = ActivationStoreReader(data_path, layer_name, subset_size)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.activation_shape = self.reader.activation_shape
        self.activation_type = self.reader.activation_type
        self.tensor_shape = self.reader.tensor_shape
        self.dataset_length = len(self.reader)
        self.seed = seed
        self.resample_padding = bool(
            resample_padding
            and self.activation_type == "tensor"
            and self.reader.n_frames is not None
        )
        # Position state for deterministic resume: the shuffle order is a
        # pure function of (seed, epoch), so a checkpointed batch count fully
        # determines the remaining data stream.
        self.epoch = 0
        self.cursor = 0  # batches already yielded in the current epoch

    def __len__(self) -> int:
        # the reference's MemoryMappedActivationDataLoader.__len__ floors
        return self.dataset_length // self.batch_size

    @property
    def batches_per_epoch(self) -> int:
        n, b = self.dataset_length, self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.dataset_length)
        return np.random.default_rng((self.seed, epoch)).permutation(
            self.dataset_length
        )

    def set_position(self, consumed_batches: int) -> None:
        """Jump to the state after ``consumed_batches`` total batches."""
        per = max(self.batches_per_epoch, 1)
        self.epoch = consumed_batches // per
        self.cursor = consumed_batches % per

    def __iter__(self) -> Iterator[tuple]:
        order = self._epoch_order(self.epoch)
        stop = len(self) * self.batch_size if self.drop_last else self.dataset_length
        for i in range(self.cursor * self.batch_size, stop, self.batch_size):
            idx = order[i : i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            # advance BEFORE yielding: if the consumer abandons the iteration
            # mid-epoch (the train loop breaking at `steps`), a later iter()
            # resumes at the next unseen batch instead of re-yielding this one
            self.cursor += 1
            if self.host_bounds is not None:
                idx = idx[self.host_bounds[0]:self.host_bounds[1]]
            with profiling.span("mmap_batch"):
                batch = self.reader.batch(idx)
            if self.resample_padding:
                # reader.batch gathers fresh arrays (fancy indexing copies
                # out of the mmap), so in-place resampling is safe
                resample_padding_rows(
                    batch[0], idx,
                    [self.reader.n_frames[i] for i in idx], self.seed)
            yield batch
        self.epoch += 1
        self.cursor = 0


def init_dataloader(
    from_disk: bool,
    data_path: str,
    whisper_model: str,
    sae_checkpoint: Optional[str],
    layer_name: str,
    batch_size: int,
    subset_size: Optional[int] = None,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int = 0,
    resample_padding: bool = False,
    device: torch.device | str = "cpu",
    host_bounds: Optional[tuple] = None,
):
    """(loader, feat_dim, dataset_len). ``seed`` drives the shuffle stream;
    ``device`` is where a fly loader computes. ``resample_padding`` replaces
    a decoder store's EOT-padding rows (mmap loader; fly-mode training
    resamples its own, see ``train``). ``host_bounds``: the mmap loader's
    pod slice of every global batch."""
    if from_disk:
        loader = MemoryMappedActivationLoader(
            data_path, layer_name, batch_size,
            subset_size=subset_size, shuffle=shuffle, drop_last=drop_last,
            seed=seed, resample_padding=resample_padding, host_bounds=host_bounds,
        )
    else:
        loader = FlyActivationLoader(
            data_path, whisper_model, sae_checkpoint, layer_name, batch_size,
            subset_size=subset_size, drop_last=drop_last, device=device,
        )
    feat_dim = loader.activation_shape[-1]
    return loader, feat_dim, loader.dataset_length
