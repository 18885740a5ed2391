"""Dataset-wide activation search (top-activating files for a feature).

The port of ``freud_tpu/analysis/search.py``: scan every file, trim each
activation trace to the file's true duration, rank files by (abs-)max
activation with an optional [min, max] filter, return the top-n (file,
trimmed trace, max value, max time) plus per-file maxima for the histogram.

* Chunks of the store go up to the device once; per-file trimmed max /
  argmax / signed-max are one masked reduction over the (chunk, time)
  block (``_dense_stats``), fetched to the host in ONE copy together with
  the chunk's (C, T) trace. A fly loader's chunks are on the device
  already and stay there.
* True lengths come from store metadata ``n_frames`` written at
  collection time (fallback: one native header read per file).
* When a current feature-major index lies beside the store
  (``data/feature_store.py``), a query reads that one feature's (files,
  time) plane instead of scanning the store.

With a ``mesh`` (several ranks) every rank reads the same chunk, reduces
its contiguous slice of the chunk's files, and the statistics themselves
(with the traces they are of) are gathered bit for bit, so every rank ranks
the same values and returns the one-rank answer.

The ranking is the JAX package's, on values that are bit-equal to its own
for a store-backed search: the maxima are exact, both argmaxes take the
first maximal frame, and the host keeps Python's stable sort over the same
entry tuples. Torch needs no padding of the ragged tail chunk to one
compiled shape.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..audio.decode import audio_duration_s
from ..constants import TIMESTEP_S
from ..data.loaders import FlyActivationLoader, MemoryMappedActivationLoader
from ..device import resolve_device
from ..parallel import mesh as mesh_lib

_N_STATS = 4  # plain max, plain argmax, abs argmax, signed value at the abs argmax


def _dense_stats(trace: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """(C, T) f32 traces and (C,) frame counts on one device → (C, 4) f32:
    plain max, plain argmax, abs argmax and the signed value at the abs
    argmax over each row's first ``n_frames`` frames (the argmaxes as exact
    f32 integers). Masked frames are -inf; ``torch.argmax`` returns the
    first maximal index, as ``jnp.argmax`` does, so a row with ``n_frames``
    0 gives max -inf at frame 0, as in JAX."""
    t = torch.arange(trace.shape[1], device=trace.device)[None, :]
    valid = t < n_frames[:, None]
    neg_inf = torch.tensor(float("-inf"), dtype=trace.dtype, device=trace.device)
    masked = torch.where(valid, trace, neg_inf)
    abs_masked = torch.where(valid, trace.abs(), neg_inf)
    abs_argmax = torch.argmax(abs_masked, dim=1)
    signed_at_absmax = torch.take_along_dim(trace, abs_argmax[:, None], dim=1)[:, 0]
    return torch.stack([torch.amax(masked, dim=1),
                        torch.argmax(masked, dim=1).to(trace.dtype),
                        abs_argmax.to(trace.dtype), signed_at_absmax], dim=1)


def _densify_indexed(vals: torch.Tensor, idx: torch.Tensor, feature_idx: int) -> torch.Tensor:
    """(C, T, k) indexed rows → (C, T) dense trace of one feature."""
    return torch.sum(torch.where(idx == feature_idx, vals, 0.0), dim=-1)


def _true_lengths(loader, filenames: list[str], start: int) -> np.ndarray:
    reader = getattr(loader, "reader", None)
    if reader is not None and reader.n_frames is not None:
        return np.asarray(reader.n_frames[start : start + len(filenames)], np.int32)
    out = np.empty(len(filenames), np.int32)
    for i, f in enumerate(filenames):
        try:
            out[i] = min(int(audio_duration_s(f) / TIMESTEP_S), 1500)
        except Exception:
            out[i] = 1500
    return out


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A host chunk (numpy, f16 or f32) or a device tensor → f32 on
    ``device``; a host chunk crosses once, in its stored dtype."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.float16, np.float32):
        a = a.astype(np.float32)
    with warnings.catch_warnings():
        # an index plane is a read-only mmap view; nothing writes to it
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(a).to(device).to(torch.float32)


def _rank(stats: np.ndarray, absolute_magnitude, min_val, max_val):
    """Per-file (value, allowed, max_t, histogram value) from host stats."""
    plain_max, plain_argmax, abs_argmax, signed = (stats[:, i].tolist()
                                                   for i in range(_N_STATS))
    out = []
    for j in range(stats.shape[0]):
        if absolute_magnitude:
            value = abs(signed[j])
            allowed = _passes(signed[j], min_val, max_val)
            # the reported time must locate the reported VALUE — the plain
            # (signed) argmax can sit at a different peak
            max_t = abs_argmax[j] * TIMESTEP_S
            hist = signed[j]
        else:
            value = plain_max[j]
            allowed = _passes(value, min_val, max_val)
            max_t = plain_argmax[j] * TIMESTEP_S
            hist = value
        out.append((value, allowed, max_t, hist))
    return out


def top_activations(
    loader: MemoryMappedActivationLoader | FlyActivationLoader,
    feature_idx: int,
    n_files: int,
    max_val: Optional[float] = None,
    min_val: Optional[float] = None,
    absolute_magnitude: bool = False,
    return_max_per_file: bool = True,
    mesh=None,
    device: torch.device | str | None = None,
):
    """Returns ([(file, trimmed_trace, max_value, max_time_s)], max_per_file).

    When a feature-major index exists next to a store
    (``freud_tpu_torch.data.feature_store``), the query reads only that
    feature's (files, time) plane instead of scanning the whole store.

    The reductions run on a fly loader's own device, else on ``device``
    (None means the card; pass ``"cpu"`` for the CPU), or on the ``mesh``'s
    card: over several ranks each rank reduces its slice of every chunk's
    files and the statistics are gathered, so every rank returns the
    one-rank answer, bit for bit."""
    mesh_lib.check_mesh(mesh)
    n_feat = getattr(loader, "activation_shape", (None, None))[-1]
    if n_feat is not None and not (0 <= int(feature_idx) < n_feat):
        # checked on the host before any device work: an out-of-range index
        # reaching a CUDA gather fires a device-side assert that poisons
        # the process's CUDA context for every later request
        raise ValueError(
            f"feature_idx {feature_idx} out of range [0, {n_feat})"
        )
    feature_idx = int(feature_idx)
    if isinstance(loader, FlyActivationLoader):
        dev = loader.device
    elif mesh is not None:
        dev = mesh.device
    else:
        dev = resolve_device(device, "search", hint='pass device="cpu" to search on the CPU')

    reader = getattr(loader, "reader", None)
    if reader is not None:
        # dense stores use the transposed-plane index; indexed (TopK) stores
        # the CSR-by-feature one — both serve the SAME one-plane fast path
        from ..data import feature_store as fs

        if reader.activation_type == "tensor":
            fm_cls, current = fs.FeatureMajorReader, fs.index_is_current
        else:
            fm_cls = fs.SparseFeatureMajorReader
            current = fs.sparse_index_is_current
        if fm_cls.exists(reader.data_path, reader.layer_name):
            if current(reader.data_path, reader.layer_name, len(reader)):
                fm = fm_cls(reader.data_path, reader.layer_name,
                            subset_size=len(reader))
                return _top_activations_indexed_plane(
                    loader, reader, feature_idx, n_files, max_val, min_val,
                    absolute_magnitude, return_max_per_file, fm, dev, mesh,
                )
            # the store changed under the index (grown, truncated, or
            # re-collected by an external writer — the sidecar filename
            # fingerprint no longer matches): fall through to the full
            # scan; the next collection or scripts/index_activations.py
            # rebuilds the fast path
            print("feature-major index is stale (store changed); scanning")

    # the scan's offset/lazy-row bookkeeping assumes the loader yields the
    # store SEQUENTIALLY and COMPLETELY — a shuffled or tail-dropping loader
    # would silently attach n_frames (and re-read traces) for the WRONG files
    if getattr(loader, "shuffle", False):
        raise ValueError("top_activations requires an unshuffled loader")
    if getattr(loader, "drop_last", False):
        raise ValueError(
            "top_activations requires drop_last=False (the tail files would "
            "silently never be scanned)"
        )

    entries = []  # (value_for_ranking, file, n_frames, max_t, trace)
    max_per_file: list[float] = []
    offset = 0

    if hasattr(loader, "set_position"):
        # the server shares one loader across requests; an aborted previous
        # scan would otherwise leave its resume cursor mid-epoch and silently
        # misalign this scan's file/offset bookkeeping
        loader.set_position(0)

    # fly loaders know every file's exact frame count from the decode they
    # are already doing, and keep their outputs on the device
    fly = reader is None and hasattr(loader, "iter_with_lengths")
    stream = loader.iter_with_lengths(fetch=False) if fly else loader

    for batch in stream:
        batch_n_frames = None
        if fly:
            *batch, filenames, batch_n_frames = batch
        else:
            *batch, filenames = batch
        if batch_n_frames is not None:
            n_frames = np.asarray(batch_n_frames, np.int32)
        else:
            n_frames = _true_lengths(loader, filenames, offset)
        offset += len(filenames)
        # with several ranks, each uploads and reduces only its rows
        lo, hi = mesh_lib.split_bounds(len(filenames), mesh)
        if loader.activation_type == "tensor":
            (chunk,) = batch
            trace = _to_device(chunk[lo:hi], dev)[:, :, feature_idx]
        else:
            vals, idx = batch
            idx = idx[lo:hi]
            idx = idx.to(dev) if isinstance(idx, torch.Tensor) else \
                torch.from_numpy(np.asarray(idx)).to(dev)
            trace = _densify_indexed(_to_device(vals[lo:hi], dev), idx, feature_idx)

        # ONE device→host copy a chunk: the stats and the (C, T) trace
        nf_dev = torch.from_numpy(n_frames[lo:hi]).to(dev)
        host = torch.cat([_dense_stats(trace, nf_dev), trace], dim=1)
        host = mesh_lib.gather_rows(mesh, host, lo, len(filenames)).cpu().numpy()
        stats, traces = host[:, :_N_STATS], host[:, _N_STATS:]

        for j, (value, allowed, max_t, hist) in enumerate(
                _rank(stats, absolute_magnitude, min_val, max_val)):
            if return_max_per_file:
                max_per_file.append(hist)
            if allowed:
                entries.append((value, filenames[j], int(n_frames[j]), max_t,
                                traces[j].copy()))
        entries.sort(key=lambda e: e[0], reverse=True)
        entries = entries[:n_files]

    return (
        [(fname, trace[:nf], value, max_time)
         for value, fname, nf, max_time, trace in entries],
        max_per_file if return_max_per_file else None,
    )


def _top_activations_indexed_plane(
    loader, reader, feature_idx, n_files, max_val, min_val,
    absolute_magnitude, return_max_per_file, fm, dev, mesh=None,
):
    """Fast path: one feature plane from the feature-major index. The
    plane is on the host already, so only the (N, 4) stats come back (with
    a mesh, each rank reduces its slice of the N files)."""
    plane = fm.feature(feature_idx)  # (N, T)
    filenames = reader.filenames
    if reader.n_frames is not None:
        n_frames = np.asarray(reader.n_frames, np.int32)
    else:
        n_frames = _true_lengths(loader, filenames, 0)

    lo, hi = mesh_lib.split_bounds(plane.shape[0], mesh)
    stats = _dense_stats(_to_device(plane[lo:hi], dev),
                         torch.from_numpy(n_frames[lo:hi]).to(dev))
    stats = mesh_lib.gather_rows(mesh, stats, lo, plane.shape[0]).cpu().numpy()
    max_per_file = []
    entries = []
    for j, (value, allowed, max_t, hist) in enumerate(
            _rank(stats, absolute_magnitude, min_val, max_val)):
        if return_max_per_file:
            max_per_file.append(hist)
        if allowed:
            entries.append((value, filenames[j], int(n_frames[j]), max_t, j))
    entries.sort(key=lambda e: e[0], reverse=True)
    results = [
        (fname, plane[row, :nf].copy(), value, max_time)
        for value, fname, nf, max_time, row in entries[:n_files]
    ]
    return results, (max_per_file if return_max_per_file else None)


def _passes(value: float, min_val: Optional[float], max_val: Optional[float]) -> bool:
    if max_val is not None and value > max_val:
        return False
    if min_val is not None and value < min_val:
        return False
    return True
