"""Where a feature-major search index lies beside an activation store.

``freud_tpu/data/feature_store.py`` keeps two kinds of index next to a
layer's store: the dense one (``{layer}_feature_major.npy`` and its growth
segments) and the sparse one (CSR by feature, groups of
``{layer}_feature_major.sparse{k}.{part}.npy``). freud_tpu's collection
extends an existing index after every run; this package does not build or
extend one yet, so its collection refuses a folder that already holds one
rather than leave it stale (search would then fall back to the full scan).
The path rules are copied from ``feature_store`` and held equal to it by
``tests/test_torch_host.py``.
"""

from __future__ import annotations

from pathlib import Path

SPARSE_PARTS = ("offsets", "file", "time", "act")


def index_path(data_path: str | Path, layer_name: str) -> Path:
    """The dense index's base file (``feature_store.index_path``)."""
    return Path(data_path) / f"{layer_name}_feature_major.npy"


def _sparse_paths(data_path: str | Path, layer_name: str, k: int) -> dict:
    return {p: Path(data_path) / f"{layer_name}_feature_major.sparse{k}.{p}.npy"
            for p in SPARSE_PARTS}


def sparse_segment_groups(data_path: str | Path, layer_name: str) -> list[dict]:
    """The sparse index's complete segment groups, in order
    (``feature_store.sparse_segment_groups``)."""
    groups = []
    k = 0
    while True:
        paths = _sparse_paths(data_path, layer_name, k)
        if not all(v.exists() for v in paths.values()):
            break
        groups.append(paths)
        k += 1
    return groups


def dense_index_exists(data_path: str | Path, layer_name: str) -> bool:
    """``feature_store.FeatureMajorReader.exists``."""
    return index_path(data_path, layer_name).exists()


def sparse_index_exists(data_path: str | Path, layer_name: str) -> bool:
    """``feature_store.SparseFeatureMajorReader.exists``."""
    return bool(sparse_segment_groups(data_path, layer_name))


def existing_index(data_path: str | Path, layer_name: str) -> Path | None:
    """The first file of a dense or sparse index of ``layer_name`` in
    ``data_path``, or None when it holds neither."""
    if dense_index_exists(data_path, layer_name):
        return index_path(data_path, layer_name)
    groups = sparse_segment_groups(data_path, layer_name)
    return groups[0]["offsets"] if groups else None
