"""Activation collection CLI (PyTorch + CUDA).

The config schema and output artifacts of ``freud_tpu.scripts.collect_activations``
(keys data_path / layer_name / whisper_model / sae_model / batch_size /
device / out_folder / dl_max_workers / collect_max / precision / store_dtype /
resume / max_new_tokens; outputs ``{layer}_metadata.json`` +
``{layer}_tensors.npy``). The pipeline: native batched decode → pinned host
buffer → CUDA log-mel kernel → encoder forward up to the captured layer (the
fused q/k/v attention kernel for d ≤ 768, the blocked attention kernel for
medium and large) → asynchronous device→host copy → streamed append to the
memory-mappable store on a write-behind thread. An undecodable file is
left out of the store; a batch whose files all fail to decode is skipped
(the JAX package's collection raises on it), and a run with no decodable
file writes nothing and says so.

A ``decoder.*`` layer runs the whole encoder, a greedy decode of
``max_new_tokens`` (default 224) and one teacher-forced decoder pass that
captures every position: each file stores n_prompt + max_new_tokens rows,
and its ``n_frames`` is the positions its decode processed (the rows after
are EOT padding).

``whisper_model`` may also be ``uni-moe-2.0-omni`` (Uni-MoE-2.0-Omni, its
HuggingFace directory found under ``$FREUD_OMNI_DIR``): its taps are
``lm.layers.N`` (the language model's residual stream after layer N, a
clip's 200 audio tokens of 0.1 s each; ``n_frames`` counts those that cover
real audio) and ``encoder.blocks.N`` (its Whisper tower).
It runs on the card in ``precision="bfloat16"``, the model's own (any
other precision is refused there; the CPU also runs float32).
``longcat-flash-omni`` (LongCat-Flash-Omni, found under
``$FREUD_LONGCAT_DIR``) takes the same taps and precision: a clip's 375
audio tokens of 0.08 s each at ``lm.layers.N``, after double layer N, on a
card holding its share of the routed experts (the checkpoint's
``deployment``).

With ``sae_model`` (a trainer checkpoint) the SAE encodes each batch on
the device: an L1 SAE stores its dense latents, a TopK SAE an indexed store
of ``(top_acts, top_indices)`` (``{layer}_activation_values.npy`` and
``{layer}_feature_indices.npy``).

``device`` is honoured when it is ``cpu`` or ``cuda[:N]``; any other value
(the repo's configs say ``"tpu"``) means ``cuda``. A CUDA device without a
card raises — the run never carries on on the CPU.

At the end of a run the feature-major search index (``data/feature_store.py``)
is built when ``build_index`` is set and extended whenever one already
exists, as in the JAX package: a dense store gets the transposed-plane
index, an indexed (TopK) store the CSR-by-feature one.

``data_parallel`` over several ranks (after
``parallel.distributed.initialize()``): rank i collects every n-th file
from i on its own card into ``<out_folder>/shard<i>`` (no index; merge the
shards with ``scripts/merge_stores.py``, which restores the file order).
With one rank it is the one-card collection into ``out_folder``.

A list of encoder layers as ``layer_name`` collects them all from one
encoder pass a batch, one store a layer (``data/multilayer.py``); it
refuses ``sae_model``, ``--resume`` and ``decoder.*`` names, as the JAX
package does.

Usage: python -m freud_tpu_torch.scripts.collect_activations --config cfg.json
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import profiling
from ..constants import CHUNK_LENGTH
from ..data import feature_store as fs
from ..data.loaders import FlyActivationLoader
from ..data.multilayer import collect_multilayer
from ..data.store import ActivationStoreWriter
from ..device import resolve_device
from ..parallel import mesh as mesh_lib


def collection_shard_setup(out_folder: str, data_parallel: bool, device=None):
    """(mesh, shard, out_folder): ONE sharding policy for single- and
    multi-layer collection. Over several ranks each rank collects a
    disjoint strided file shard on its own card into
    ``<out_folder>/shard<rank>``; collection is embarrassingly parallel, so
    nothing crosses between ranks. One rank: a mesh of this process alone
    and ``out_folder`` itself."""
    if not data_parallel:
        return None, None, out_folder
    world = mesh_lib.make_mesh(device=resolve_device(device))
    if mesh_lib.is_multiprocess(world):
        return (mesh_lib.local_mesh(world), (world.data_rank, world.data_size),
                str(Path(out_folder) / f"shard{world.data_rank}"))
    return mesh_lib.local_mesh(world), None, out_folder


def get_activations(
    data_path: str,
    layer_name: str,
    whisper_model: str,
    sae_model: Optional[str],
    batch_size: int,
    out_folder: str,
    collect_max: Optional[int] = None,
    verbose: bool = True,
    precision: str = "float32",
    dl_max_workers: int = 0,
    build_index: bool = False,
    data_parallel: bool = False,
    resume: bool = False,
    flush_every_s: float = 30.0,
    store_dtype: str = "float32",
    device: Optional[str] = "cuda",
    max_new_tokens: int = 224,
) -> dict:
    """``precision="bfloat16"`` runs the encoder in bf16; the default keeps
    f32 (on CUDA the attention kernel's products are bf16 either way).
    ``resume=True`` continues an interrupted collection: already-stored
    files are skipped, new activations append, and the store is flushed
    crash-consistently every ``flush_every_s`` seconds.
    ``store_dtype="float16"`` halves store size and read IO.
    ``max_new_tokens`` sizes a decoder layer's decode (encoder layers
    ignore it). ``build_index`` builds the feature-major search index at
    the end of the run; an existing one is extended whatever it says."""
    mesh, shard, out_folder = collection_shard_setup(out_folder, data_parallel, device)
    dev = resolve_device(device)
    compute_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32

    exclude = None
    if resume:
        meta_path = Path(out_folder) / f"{layer_name}_metadata.json"
        if meta_path.exists():
            with open(meta_path) as f:
                exclude = set(json.load(f).get("filenames", []))
            if verbose and exclude:
                print(f"resume: skipping {len(exclude)} already-stored files")

    loader = FlyActivationLoader(
        data_path=data_path,
        whisper_model=whisper_model,
        sae_checkpoint=sae_model,
        layer_name=layer_name,
        batch_size=batch_size,
        subset_size=collect_max,
        compute_dtype=compute_dtype,
        decode_threads=dl_max_workers if dl_max_workers > 0 else None,
        exclude=exclude,
        fetch_dtype=torch.float16 if store_dtype == "float16" else None,
        device=dev,
        max_new_tokens=max_new_tokens,
        mesh=mesh,
        shard=shard,
    )

    # Write-behind store thread: batch k writes to disk while batch k+1
    # fetches (decode overlaps in the prefetch thread, device compute under
    # the fetch via the loader's one-ahead dispatch), so the wall tracks the
    # slowest single stage instead of the sum. The writer thread owns ALL
    # writer calls including the periodic flush points.
    writer: Optional[ActivationStoreWriter] = None
    wq: queue.Queue = queue.Queue(maxsize=2)
    werr: list[BaseException] = []

    def _drain():
        last_flush = time.perf_counter()
        while True:
            item = wq.get()
            if item is None:
                return
            filenames, arrays, n_frames = item
            try:
                with profiling.span("store_append"):
                    writer.append_batch(filenames, *arrays, n_frames=n_frames)
                # periodic crash-consistency point (header + metadata)
                if time.perf_counter() - last_flush >= flush_every_s:
                    writer.flush()
                    last_flush = time.perf_counter()
            except BaseException as e:  # surface in the main loop
                werr.append(e)
                return
            finally:
                wq.task_done()

    def _safe_put(item):
        # never block forever against a dead writer thread
        while True:
            if werr:
                raise werr[0]
            try:
                wq.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    wthread: Optional[threading.Thread] = None
    n_files = 0
    t0 = time.perf_counter()
    try:
        for batch in loader.iter_with_lengths():
            *arrays, filenames, n_frames = batch
            if not filenames:
                # every file of the batch failed to decode: the loader
                # dropped their rows, and a zero-row batch has nothing to
                # fetch or store (the writer cannot take its shape from it)
                continue
            # waits for this batch's device→host copy only; the next batch's
            # encode is already queued on the device
            with profiling.span("d2h_fetch"):
                arrays = [np.asarray(a) for a in arrays]
            if writer is None:
                writer = ActivationStoreWriter(
                    out_folder,
                    layer_name,
                    tensor_shape=arrays[0].shape[1:],
                    activation_shape=loader.activation_shape,
                    indexed=loader.activation_type == "indexed",
                    overwrite=not resume,
                    store_dtype=np.dtype(store_dtype),
                )
                wthread = threading.Thread(target=_drain, daemon=True)
                wthread.start()
            _safe_put((filenames, arrays, n_frames))
            n_files += len(filenames)
            if verbose:
                dt = time.perf_counter() - t0
                rtfx = n_files * CHUNK_LENGTH / max(dt, 1e-9)
                print(
                    f"\rcollected {n_files}/{loader.dataset_length} files "
                    f"({rtfx:.0f}x realtime)",
                    end="",
                    flush=True,
                )
    finally:
        if wthread is not None:
            try:
                while wthread.is_alive():
                    try:
                        wq.put(None, timeout=1.0)
                        break
                    except queue.Full:
                        continue
            finally:
                wthread.join()
    if werr:
        raise werr[0]
    if writer is None:
        print(f"no decodable audio file under {data_path}: nothing written to "
              f"{out_folder}", file=sys.stderr)
    else:
        writer.close()
    if writer is not None and shard is None:
        # keep an existing index current after every run (a grown store must
        # never silently degrade search to a full scan); build fresh only
        # when asked. A rank's shard store gets none: the merge would orphan
        # it (merge_stores --build_index indexes the merged store)
        if writer.indexed:
            if build_index or fs.SparseFeatureMajorReader.exists(out_folder, layer_name):
                fs.extend_sparse_feature_major_index(out_folder, layer_name,
                                                     verbose=verbose)
        elif build_index or fs.FeatureMajorReader.exists(out_folder, layer_name):
            fs.extend_feature_major_index(out_folder, layer_name, verbose=verbose)
    elapsed = time.perf_counter() - t0
    if verbose:
        print()
        print(profiling.report())
    return {
        "n_files": n_files,
        "elapsed_s": elapsed,
        "rtfx": n_files * CHUNK_LENGTH / max(elapsed, 1e-9),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="Path to feature configuration file (whisper_model: a "
                             "Whisper name, or uni-moe-2.0-omni or longcat-flash-omni "
                             "with layer_name lm.layers.N or encoder.blocks.N)")
    parser.add_argument("--resume", action="store_true",
                        help="continue an interrupted collection: skip "
                             "already-stored files and append to the store")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    if isinstance(config["layer_name"], list):
        if args.resume or config.get("resume"):
            raise SystemExit("--resume is not supported for multi-layer "
                             "collection yet; re-collect or collect the "
                             "missing layers individually")
        # multi-layer: one encoder pass, one store per layer
        if config.get("sae_model"):
            raise SystemExit(
                "multi-layer collection does not support sae_model — "
                "collect raw activations per layer, then train per-layer "
                "SAEs (train/sweep.py)"
            )
        stats = collect_multilayer(
            data_path=config["data_path"],
            layer_names=config["layer_name"],
            whisper_model=config["whisper_model"],
            batch_size=config["batch_size"],
            out_folder=config["out_folder"],
            collect_max=config.get("collect_max"),
            data_parallel=bool(config.get("data_parallel", False)),
            precision=config.get("precision", "float32"),
            build_index=bool(config.get("build_index", False)),
            store_dtype=config.get("store_dtype", "float32"),
            device=config.get("device"),
        )
        print(json.dumps(stats))
        return
    stats = get_activations(
        data_path=config["data_path"],
        layer_name=config["layer_name"],
        whisper_model=config["whisper_model"],
        sae_model=config.get("sae_model"),
        batch_size=config["batch_size"],
        out_folder=config["out_folder"],
        collect_max=config.get("collect_max"),
        precision=config.get("precision", "float32"),
        dl_max_workers=config.get("dl_max_workers", 0),
        build_index=bool(config.get("build_index", False)),
        data_parallel=bool(config.get("data_parallel", False)),
        resume=bool(args.resume or config.get("resume", False)),
        store_dtype=config.get("store_dtype", "float32"),
        device=config.get("device"),
        max_new_tokens=int(config.get("max_new_tokens", 224)),
    )
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
