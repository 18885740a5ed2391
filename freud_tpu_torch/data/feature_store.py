"""Feature-major activation index: O(one feature) search instead of full scans.

The port's copy of ``freud_tpu/data/feature_store.py``, which is numpy
only: an index (and its meta JSON) that either package writes is
byte-identical to the other's, and each package's readers read the
other's (``tests/test_torch_feature_store.py``).

The reference's ``/top_files`` search reads the ENTIRE (files × time ×
features) store for every query (src/utils/activations.py:60-132 — at
large-v3 scale that is hundreds of GB per GUI click). Activation search is
feature-major by nature: one query touches exactly one feature column. This
module builds a one-time transposed copy ``{layer}_feature_major.npy`` with
shape (features, files, time); a query then mmap-reads a single (files, time)
plane — e.g. 60 MB instead of 23 GB for a 10k-file large-v3 store — and the
device computes the trimmed maxima in one shot.

The index is an optional acceleration: search falls back to the scan when the
file is absent, and the primary store format stays reference-compatible.

Growth: the (features, files, time) layout cannot be appended in place (the
file axis is interior), so the index is SEGMENTED — the base
``{layer}_feature_major.npy`` plus ``{layer}_feature_major.seg{K}.npy``
files, each covering a contiguous file range. ``extend_feature_major_index``
transposes only the files added since the last build into a new segment (the
collection pipeline calls it at the end of every run whenever an index
exists), and a
feature query concatenates the per-segment planes — still O(one feature).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .store import ActivationStoreReader


def index_path(data_path: str | Path, layer_name: str) -> Path:
    return Path(data_path) / f"{layer_name}_feature_major.npy"


def segment_paths(data_path: str | Path, layer_name: str) -> list[Path]:
    """All existing index segments in file order: base, seg1, seg2, …"""
    base = index_path(data_path, layer_name)
    if not base.exists():
        return []
    segs = []
    k = 1
    while True:
        p = Path(data_path) / f"{layer_name}_feature_major.seg{k}.npy"
        if not p.exists():
            break
        segs.append(p)
        k += 1
    return [base] + segs


def _meta_path(data_path: str | Path, layer_name: str) -> Path:
    return Path(data_path) / f"{layer_name}_feature_major.meta.json"


def _fingerprint(filenames: list[str]) -> str:
    import hashlib

    return hashlib.sha1("\n".join(filenames).encode()).hexdigest()


def _store_filenames(data_path: str | Path, layer_name: str) -> list[str]:
    import json

    with open(Path(data_path) / f"{layer_name}_metadata.json") as f:
        return json.load(f)["filenames"]


def _write_meta(data_path, layer_name, covered: int, filenames: list[str]):
    import json

    _meta_path(data_path, layer_name).write_text(json.dumps({
        "covered": covered,
        "fingerprint": _fingerprint(filenames[:covered]),
    }))


def index_is_current(data_path: str | Path, layer_name: str,
                     n_query: int) -> bool:
    """True iff the index VERIFIABLY covers the store's first ``n_query``
    files: the sidecar meta's filename fingerprint must match the store's
    current metadata. A same-size re-collection changes the fingerprint, so
    a stale index can never silently serve the previous run's activations
    (it rebuilds on the next collection flush, and search falls back to the
    scan until then)."""
    import json

    segs = segment_paths(data_path, layer_name)
    mp = _meta_path(data_path, layer_name)
    if not segs or not mp.exists():
        return False
    try:
        meta = json.loads(mp.read_text())
        covered = sum(np.load(p, mmap_mode="r").shape[1] for p in segs)
        if covered != meta.get("covered") or covered < n_query:
            return False
        filenames = _store_filenames(data_path, layer_name)
        if covered > len(filenames):
            return False
        return _fingerprint(filenames[:covered]) == meta.get("fingerprint")
    except (OSError, ValueError, KeyError):
        return False


def build_feature_major_index(
    data_path: str | Path,
    layer_name: str,
    chunk_files: int = 256,
    verbose: bool = True,
) -> Path:
    """Transpose a dense store to (features, files, time), chunked by files.

    A full (re)build: any existing growth segments and sidecar meta are
    removed first, and a fresh fingerprint meta is written."""
    reader = ActivationStoreReader(data_path, layer_name)
    if reader.activation_type != "tensor":
        raise ValueError("feature-major index requires a dense store")
    for p in segment_paths(data_path, layer_name)[1:]:
        p.unlink()
    mp = _meta_path(data_path, layer_name)
    if mp.exists():
        mp.unlink()
    n = len(reader)
    t, f = reader.tensor_shape
    out_path = index_path(data_path, layer_name)
    out = np.lib.format.open_memmap(
        out_path, mode="w+", dtype=np.float32, shape=(f, n, t)
    )
    for start in range(0, n, chunk_files):
        idx = np.arange(start, min(start + chunk_files, n))
        chunk = reader.batch(idx)[0]  # (C, T, F)
        out[:, idx[0] : idx[-1] + 1, :] = np.ascontiguousarray(
            chunk.transpose(2, 0, 1)
        )
        if verbose:
            print(f"\rindexed {idx[-1] + 1}/{n} files", end="", flush=True)
    out.flush()
    del out
    _write_meta(data_path, layer_name, n,
                _store_filenames(data_path, layer_name))
    if verbose:
        print()
    return out_path


def extend_feature_major_index(
    data_path: str | Path,
    layer_name: str,
    chunk_files: int = 256,
    verbose: bool = True,
) -> Optional[Path]:
    """Transpose the files added since the last build into a new segment.

    Returns the new segment path (or the full-rebuild base path), or None
    when the index verifiably already covers the store. Called by the
    collection pipeline at the end of every run whenever an index exists,
    so a grown store
    never silently degrades search to a full scan (the staleness path in
    analysis/search.py). The sidecar fingerprint guards against a
    TRUNCATING or same-size re-collection: if the store's covered-prefix
    filenames no longer match what was indexed, the whole index rebuilds
    instead of splicing the previous run's planes with new ones."""
    reader = ActivationStoreReader(data_path, layer_name)
    if reader.activation_type != "tensor":
        raise ValueError("feature-major index requires a dense store")
    segs = segment_paths(data_path, layer_name)
    if not segs:
        return build_feature_major_index(
            data_path, layer_name, chunk_files, verbose)
    covered = 0
    for p in segs:
        covered += np.load(p, mmap_mode="r").shape[1]
    n = len(reader)
    import json

    mp = _meta_path(data_path, layer_name)
    verified = False
    if mp.exists():
        try:
            meta = json.loads(mp.read_text())
            filenames = _store_filenames(data_path, layer_name)
            verified = (
                meta.get("covered") == covered
                and covered <= len(filenames)
                and _fingerprint(filenames[:covered]) == meta.get("fingerprint")
            )
        except (OSError, ValueError, KeyError):
            verified = False
    if not verified or covered > n:
        # the indexed prefix no longer matches the store (re-collection,
        # truncation, or a pre-fingerprint index): rebuild from scratch
        return build_feature_major_index(
            data_path, layer_name, chunk_files, verbose)
    if covered == n:
        return None
    t, f = reader.tensor_shape
    out_path = Path(data_path) / f"{layer_name}_feature_major.seg{len(segs)}.npy"
    out = np.lib.format.open_memmap(
        out_path, mode="w+", dtype=np.float32, shape=(f, n - covered, t)
    )
    for start in range(covered, n, chunk_files):
        idx = np.arange(start, min(start + chunk_files, n))
        chunk = reader.batch(idx)[0]  # (C, T, F)
        out[:, idx[0] - covered : idx[-1] - covered + 1, :] = (
            np.ascontiguousarray(chunk.transpose(2, 0, 1))
        )
        if verbose:
            print(f"\rindexed {idx[-1] + 1}/{n} files", end="", flush=True)
    out.flush()
    del out
    _write_meta(data_path, layer_name, n,
                _store_filenames(data_path, layer_name))
    if verbose:
        print()
    return out_path


# ---------------------------------------------------------------- indexed
# TopK stores are (T, k) sparse rows; their feature-major index is sparse
# too — a dense (n_dict, files, T) transpose would be k/n_dict times larger
# than the store itself (hundreds of GB at production scale). CSR-by-feature
# instead: offsets (n_dict+1,) into three parallel hit arrays (file, time,
# act). A query slices ONE feature's hits and scatters them into the
# (files, T) plane — O(hits of that feature), the sparse analogue of the
# dense index's O(one plane) read. Growth uses the same segment scheme as
# the dense index (one CSR group per contiguous file range).

SPARSE_PARTS = ("offsets", "file", "time", "act")


def _sparse_paths(data_path: str | Path, layer_name: str, k: int) -> dict:
    return {p: Path(data_path) / f"{layer_name}_feature_major.sparse{k}.{p}.npy"
            for p in SPARSE_PARTS}


def sparse_segment_groups(data_path: str | Path, layer_name: str) -> list[dict]:
    groups = []
    k = 0
    while True:
        paths = _sparse_paths(data_path, layer_name, k)
        if not all(v.exists() for v in paths.values()):
            break
        groups.append(paths)
        k += 1
    return groups


def _build_sparse_segment(reader, start: int, stop: int, paths: dict,
                          chunk_files: int, verbose: bool) -> int:
    """CSR-by-feature over store files [start, stop) → ``paths``. Two
    streaming passes (count, fill) so only chunk_files files are ever in
    memory. Returns the number of files covered."""
    n_dict = reader.activation_shape[-1]
    counts = np.zeros(n_dict, np.int64)
    for s in range(start, stop, chunk_files):
        ids = np.arange(s, min(s + chunk_files, stop))
        _, idx, _ = reader.batch(ids)
        counts += np.bincount(idx.reshape(-1), minlength=n_dict)
    offsets = np.zeros(n_dict + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    nnz = int(offsets[-1])
    f_mm = np.lib.format.open_memmap(paths["file"], mode="w+",
                                     dtype=np.int32, shape=(nnz,))
    t_mm = np.lib.format.open_memmap(paths["time"], mode="w+",
                                     dtype=np.int32, shape=(nnz,))
    a_mm = np.lib.format.open_memmap(paths["act"], mode="w+",
                                     dtype=np.float32, shape=(nnz,))
    cursor = offsets[:-1].copy()
    t_len, kk = reader.tensor_shape
    for s in range(start, stop, chunk_files):
        ids = np.arange(s, min(s + chunk_files, stop))
        vals, idx, _ = reader.batch(ids)
        flat_feat = idx.reshape(-1).astype(np.int64)
        order = np.argsort(flat_feat, kind="stable")
        sorted_feat = flat_feat[order]
        # row positions of the sorted hits inside the chunk
        file_of = np.repeat(ids - start, t_len * kk)[order].astype(np.int32)
        time_of = np.tile(np.repeat(np.arange(t_len, dtype=np.int32), kk),
                          len(ids))[order]
        act_of = vals.reshape(-1).astype(np.float32)[order]
        # contiguous runs per feature → one slice write per present feature
        feats, run_starts = np.unique(sorted_feat, return_index=True)
        run_ends = np.append(run_starts[1:], len(sorted_feat))
        for feat, lo, hi in zip(feats, run_starts, run_ends):
            c = cursor[feat]
            f_mm[c:c + hi - lo] = file_of[lo:hi]
            t_mm[c:c + hi - lo] = time_of[lo:hi]
            a_mm[c:c + hi - lo] = act_of[lo:hi]
            cursor[feat] = c + hi - lo
        if verbose:
            print(f"\rindexed {ids[-1] + 1}/{stop} files", end="", flush=True)
    assert (cursor == offsets[1:]).all()
    for mm in (f_mm, t_mm, a_mm):
        mm.flush()
    o_mm = np.lib.format.open_memmap(paths["offsets"], mode="w+",
                                     dtype=np.int64, shape=(n_dict + 1,))
    o_mm[:] = offsets
    o_mm.flush()
    if verbose:
        print()
    return stop - start


def build_sparse_feature_major_index(
    data_path: str | Path,
    layer_name: str,
    chunk_files: int = 256,
    verbose: bool = True,
) -> Path:
    """Full (re)build of the sparse index for an indexed (TopK) store."""
    reader = ActivationStoreReader(data_path, layer_name)
    if reader.activation_type != "indexed":
        raise ValueError("sparse feature-major index is for indexed stores")
    for group in sparse_segment_groups(data_path, layer_name):
        for p in group.values():
            p.unlink()
    mp = _meta_path(data_path, layer_name)
    if mp.exists():
        mp.unlink()
    n = len(reader)
    paths = _sparse_paths(data_path, layer_name, 0)
    _build_sparse_segment(reader, 0, n, paths, chunk_files, verbose)
    _write_nfiles_sidecar(paths, n)
    _write_meta(data_path, layer_name, n,
                _store_filenames(data_path, layer_name))
    return paths["offsets"]


def extend_sparse_feature_major_index(
    data_path: str | Path,
    layer_name: str,
    chunk_files: int = 256,
    verbose: bool = True,
) -> Optional[Path]:
    """Index only the files added since the last build as a new CSR segment
    (same staleness rules as the dense extend: a fingerprint mismatch
    rebuilds from scratch)."""
    import json

    reader = ActivationStoreReader(data_path, layer_name)
    if reader.activation_type != "indexed":
        raise ValueError("sparse feature-major index is for indexed stores")
    groups = sparse_segment_groups(data_path, layer_name)
    if not groups:
        return build_sparse_feature_major_index(
            data_path, layer_name, chunk_files, verbose)
    covered = sum(_segment_n_files(g) for g in groups)
    n = len(reader)
    mp = _meta_path(data_path, layer_name)
    verified = False
    if mp.exists():
        try:
            meta = json.loads(mp.read_text())
            filenames = _store_filenames(data_path, layer_name)
            verified = (
                meta.get("covered") == covered
                and covered <= len(filenames)
                and _fingerprint(filenames[:covered]) == meta.get("fingerprint")
            )
        except (OSError, ValueError, KeyError):
            verified = False
    if not verified or covered > n:
        return build_sparse_feature_major_index(
            data_path, layer_name, chunk_files, verbose)
    if covered == n:
        return None
    paths = _sparse_paths(data_path, layer_name, len(groups))
    _build_sparse_segment(reader, covered, n, paths, chunk_files, verbose)
    _write_nfiles_sidecar(paths, n - covered)
    _write_meta(data_path, layer_name, n,
                _store_filenames(data_path, layer_name))
    return paths["offsets"]


def _nfiles_sidecar(paths: dict) -> Path:
    return paths["offsets"].with_suffix(".nfiles")


def _write_nfiles_sidecar(paths: dict, n_files: int) -> None:
    _nfiles_sidecar(paths).write_text(str(n_files))


def _segment_n_files(paths: dict) -> int:
    """Files covered by a CSR segment — from the sidecar every build/extend
    writes (the hit arrays can't record it: a trailing file with no hits
    would leave no trace). Fallback for a hand-built index: max file id + 1."""
    sc = _nfiles_sidecar(paths)
    if sc.exists():
        return int(sc.read_text())
    f = np.load(paths["file"], mmap_mode="r")
    return int(f[:].max()) + 1 if f.shape[0] else 0


def sparse_index_is_current(data_path: str | Path, layer_name: str,
                            n_query: int) -> bool:
    """Sparse analogue of ``index_is_current`` (same sidecar fingerprint
    rules): True iff the CSR segments verifiably cover the store's first
    ``n_query`` files."""
    import json

    groups = sparse_segment_groups(data_path, layer_name)
    mp = _meta_path(data_path, layer_name)
    if not groups or not mp.exists():
        return False
    try:
        meta = json.loads(mp.read_text())
        covered = sum(_segment_n_files(g) for g in groups)
        if covered != meta.get("covered") or covered < n_query:
            return False
        filenames = _store_filenames(data_path, layer_name)
        if covered > len(filenames):
            return False
        return _fingerprint(filenames[:covered]) == meta.get("fingerprint")
    except (OSError, ValueError, KeyError):
        return False


class SparseFeatureMajorReader:
    """One feature's (files, time) plane reconstructed from the CSR index —
    numerically identical to the scan path's ``_densify_indexed`` (duplicate
    indices accumulate, everything else is 0)."""

    def __init__(self, data_path: str | Path, layer_name: str,
                 subset_size: Optional[int] = None):
        self.groups = sparse_segment_groups(data_path, layer_name)
        if not self.groups:
            raise FileNotFoundError(
                str(_sparse_paths(data_path, layer_name, 0)["offsets"]))
        reader = ActivationStoreReader(data_path, layer_name)
        self.t_len = reader.tensor_shape[0]
        self.seg_files = [_segment_n_files(g) for g in self.groups]
        self.n_files = sum(self.seg_files)
        self.subset_size = subset_size
        self._mm = [
            {p: np.load(g[p], mmap_mode="r") for p in SPARSE_PARTS}
            for g in self.groups
        ]

    @staticmethod
    def exists(data_path: str | Path, layer_name: str) -> bool:
        return bool(sparse_segment_groups(data_path, layer_name))

    def feature(self, feature_idx: int) -> np.ndarray:
        plane = np.zeros((self.n_files, self.t_len), np.float32)
        base = 0
        for mm, nf in zip(self._mm, self.seg_files):
            off = mm["offsets"]
            lo, hi = int(off[feature_idx]), int(off[feature_idx + 1])
            if hi > lo:
                np.add.at(plane,
                          (np.asarray(mm["file"][lo:hi]) + base,
                           np.asarray(mm["time"][lo:hi])),
                          np.asarray(mm["act"][lo:hi], np.float32))
            base += nf
        if self.subset_size is not None:
            plane = plane[: self.subset_size]
        return plane


class FeatureMajorReader:
    """mmap access to one feature's (files, time) activation plane, spliced
    across the base index and any growth segments."""

    def __init__(self, data_path: str | Path, layer_name: str,
                 subset_size: Optional[int] = None):
        self.mmaps = [np.load(p, mmap_mode="r")
                      for p in segment_paths(data_path, layer_name)]
        if not self.mmaps:
            raise FileNotFoundError(index_path(data_path, layer_name))
        self.n_files = sum(m.shape[1] for m in self.mmaps)
        self.subset_size = subset_size

    @staticmethod
    def exists(data_path: str | Path, layer_name: str) -> bool:
        return index_path(data_path, layer_name).exists()

    def feature(self, feature_idx: int) -> np.ndarray:
        planes = [m[feature_idx] for m in self.mmaps]
        plane = planes[0] if len(planes) == 1 else np.concatenate(planes, 0)
        if self.subset_size is not None:
            plane = plane[: self.subset_size]
        return np.asarray(plane)
