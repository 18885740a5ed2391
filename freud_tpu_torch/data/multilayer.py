"""Multi-layer activation collection: N capture points in ONE encoder pass.

The port of ``freud_tpu/data/multilayer.py``: each audio batch runs one
encoder forward that captures every requested layer and stops after the
deepest one (``encoder_forward(..., stop_after_capture=True)``), and the
collection streams each layer to its own reference-format store. On the
card the batch runs kernel #1 (log-mel) once and the encoder's attention
kernel once a block up to the deepest layer.

Over several ranks the loader takes ``shard`` (every n-th file) and
``mesh`` (each rank encodes its slice of every batch, gathered whole on
every rank), as ``FlyActivationLoader`` does, and ``data_parallel``
collection writes ``<out_folder>/shard<rank>`` stores for every layer
(``collection_shard_setup``; merge each layer with
``scripts/merge_stores.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import profiling
from ..analysis.features import activation_length_from_samples
from ..device import resolve_device
from ..models.whisper import WhisperRuntime, encoder_forward
from ..parallel import mesh as mesh_lib
from .audio_dataset import AudioBatchPipeline
from .feature_store import FeatureMajorReader, extend_feature_major_index
from .loaders import DeviceFetch, decodable_mask
from .store import ActivationStoreWriter


class MultiLayerActivationLoader:
    """Yields ({layer: activations}, filenames, n_frames) per audio batch."""

    def __init__(
        self,
        data_path: str,
        whisper_model: str,
        layer_names: Sequence[str],
        batch_size: int,
        subset_size: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
        mesh=None,
        shard: tuple[int, int] | None = None,
        device: torch.device | str | None = "cuda",
        fetch_dtype: torch.dtype | None = None,
    ):
        """``device``: ``cpu`` / ``cuda[:N]``; anything else means cuda (with
        a ``mesh``, its card). ``fetch_dtype`` casts each layer on the device
        before its host copy (a float16 store then moves half the bytes).
        ``mesh`` and ``shard`` as ``FlyActivationLoader``'s."""
        self.mesh = mesh_lib.check_mesh(mesh)
        self.layer_names = tuple(layer_names)
        bad = [n for n in self.layer_names if n.startswith("decoder.")]
        if bad:
            raise ValueError(
                f"multi-layer collection captures from ONE encoder pass; "
                f"decoder layers {bad} need a greedy decode per batch — "
                "collect them one at a time (single-layer collection "
                "supports decoder.* names)"
            )
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if mesh is not None and batch_size % mesh.data_size:
            raise ValueError(f"batch_size {batch_size} not divisible by the mesh's "
                             f"data axis ({mesh.data_size})")
        self.runtime = WhisperRuntime(whisper_model, None, compute_dtype=compute_dtype,
                                      device=self.device)
        self.batch_size = batch_size
        self.fetch_dtype = fetch_dtype
        self.pipeline = AudioBatchPipeline(
            data_path, batch_size, self.runtime.dims.n_mels,
            subset_size=subset_size, device=self.device, shard=shard,
        )

    @property
    def dataset_length(self) -> int:
        return self.pipeline.dataset_length

    def _compute(self, mels: torch.Tensor, n: int) -> dict:
        """One captured encoder pass → {layer: host array, or its
        device→host copy in flight on the card}."""
        split = mesh_lib.is_multiprocess(self.mesh)
        pad = self.batch_size - n if mels.is_cuda else 0
        if split:
            # this rank's slice of the batch padded to its shape
            lo, _ = mesh_lib.host_shard_bounds(self.batch_size, self.mesh)
            mels = mesh_lib.pad_and_shard(self.mesh, mels, self.batch_size)
        elif pad:
            # on the card, pad the ragged tail to the batch shape (every
            # batch runs the same kernel shapes); padded rows trim below
            mels = torch.cat([mels, mels.new_zeros((pad, *mels.shape[1:]))])
        rt = self.runtime
        with profiling.span("multilayer_capture"):
            with torch.inference_mode():
                _, caps = encoder_forward(
                    rt.encoder, rt.dims, mels, capture=self.layer_names,
                    compute_dtype=rt.compute_dtype, stop_after_capture=True)
        out = {}
        for layer in self.layer_names:
            o = caps[layer]
            if split:
                o = mesh_lib.gather_rows(self.mesh, o, lo, self.batch_size)
            o = o[:n]
            if self.fetch_dtype is not None:
                o = o.to(self.fetch_dtype)
            elif o.dtype == torch.bfloat16:
                o = o.to(torch.float32)  # numpy has no bfloat16
            # on the card, start the device→host copy now, ahead of the next
            # batch's work
            out[layer] = DeviceFetch(o) if o.is_cuda else o.numpy()
        return out

    def __iter__(self):
        """One batch ahead: batch k+1's mel and encode are queued on the
        device before batch k is yielded, so the device computes k+1 while
        the consumer waits on k's copies and writes the stores. Undecodable
        files are dropped."""
        pending = None
        for mels, filenames, lengths in self.pipeline:
            caps = self._compute(mels, len(filenames))
            if pending is not None:
                yield self._finalize(*pending)
            pending = (caps, filenames, lengths)
        if pending is not None:
            yield self._finalize(*pending)

    def _finalize(self, caps: dict, filenames: list, lengths: np.ndarray):
        # per-file decode degrade (shared policy, loaders.decodable_mask):
        # drop undecodable files instead of writing their zero rows +
        # negative n_frames into every layer store
        ok = decodable_mask(lengths, filenames)
        if not ok.all():
            # masking waits on the copies: count that wait as the fetch
            with profiling.span("d2h_fetch"):
                caps = {k: np.asarray(v)[ok] for k, v in caps.items()}
            filenames = [f for f, good in zip(filenames, ok) if good]
            lengths = lengths[ok]
        n_frames = np.asarray(
            [activation_length_from_samples(int(n)) for n in lengths], np.int64)
        return caps, filenames, n_frames


def collect_multilayer(
    data_path: str,
    layer_names: Sequence[str],
    whisper_model: str,
    batch_size: int,
    out_folder: str,
    collect_max: Optional[int] = None,
    verbose: bool = True,
    data_parallel: bool = False,
    precision: str = "float32",
    build_index: bool = False,
    store_dtype: str = "float32",
    device: Optional[str] = "cuda",
) -> dict:
    """One encoder pass per batch, one reference-format store per layer.

    A batch whose files all fail to decode is skipped (the JAX package's
    store writer raises on it), as the port's single-layer collection does.
    ``device`` as in ``get_activations``. ``data_parallel`` over several
    ranks: each writes ``<out_folder>/shard<rank>`` stores for every layer
    (``collection_shard_setup``, the single-layer policy), unindexed."""
    from ..scripts.collect_activations import collection_shard_setup

    mesh, shard, out_folder = collection_shard_setup(out_folder, data_parallel, device)
    compute_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    loader = MultiLayerActivationLoader(
        data_path, whisper_model, layer_names, batch_size,
        subset_size=collect_max, compute_dtype=compute_dtype, device=device,
        fetch_dtype=torch.float16 if store_dtype == "float16" else None,
        mesh=mesh, shard=shard,
    )
    writers: dict[str, ActivationStoreWriter] = {}
    n_files = 0
    for caps, filenames, n_frames in loader:
        if not filenames:
            continue  # every file of the batch failed to decode
        for layer in loader.layer_names:
            with profiling.span("d2h_fetch"):
                arr = np.asarray(caps[layer])
            if layer not in writers:
                writers[layer] = ActivationStoreWriter(
                    out_folder, layer,
                    tensor_shape=arr.shape[1:], activation_shape=arr.shape[1:],
                    store_dtype=np.dtype(store_dtype),
                )
            with profiling.span("store_append"):
                writers[layer].append_batch(filenames, arr, n_frames=n_frames)
        n_files += len(filenames)
        if verbose:
            print(f"\rcollected {n_files}/{loader.dataset_length} files "
                  f"x {len(loader.layer_names)} layers", end="", flush=True)
    for w in writers.values():
        w.close()
    for layer in writers if shard is None else ():
        if build_index or FeatureMajorReader.exists(out_folder, layer):
            extend_feature_major_index(out_folder, layer, verbose=verbose)
    if verbose:
        print()
    return {"n_files": n_files, "layers": list(loader.layer_names)}
