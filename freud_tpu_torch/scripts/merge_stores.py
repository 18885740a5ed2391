"""Merge per-rank collection shards into one reference-format store.

The port of ``freud_tpu/scripts/merge_stores.py``, framework-free as the
original is (numpy and the port's ``data/store.py``). A pod collection
(``"data_parallel": true`` over several ranks) gives each rank a disjoint
strided file shard (file j of the sorted dataset lives in shard ``j % P``
at row ``j // P``) written to ``<out_folder>/shard<i>``. This tool
interleaves the shards back into the original sorted file order as a single
store in ``<out_folder>``, byte-compatible with a one-card collection of the
same dataset (dense and indexed layouts both; ``n_frames`` metadata
preserved). It reads shards written by either package.

Usage: python -m freud_tpu_torch.scripts.merge_stores \
           --out_folder activations/run --layer_name encoder.blocks.2
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.store import ActivationStoreReader, ActivationStoreWriter


def merge_shards(out_folder: str, layer_name: str, chunk: int = 0,
                 verbose: bool = True, build_index: bool = False) -> dict:
    """``chunk``: rows buffered per write; 0 sizes it to ~64 MB of rows
    (large-model dense rows are ~8 MB each — a fixed row count would balloon
    to gigabytes on the single-core host). ``build_index``: build the
    feature-major search index over the MERGED store (per-shard indexes are
    never built — they would be orphaned by the merge)."""
    root = Path(out_folder)
    shard_dirs = []
    while (root / f"shard{len(shard_dirs)}").exists():
        shard_dirs.append(root / f"shard{len(shard_dirs)}")
    if not shard_dirs:
        raise FileNotFoundError(f"no shard0/ under {out_folder}")
    readers = [ActivationStoreReader(d, layer_name) for d in shard_dirs]
    counts = [len(r) for r in readers]
    total = sum(counts)
    indexed = readers[0].activation_type == "indexed"
    # n_frames must be all-or-nothing across the merged store (a partial
    # list would be positionally misaligned — the writer now rejects it);
    # if any shard lacks it, drop it everywhere and say so
    has_nf = all(r.n_frames is not None for r in readers)
    if not has_nf and any(r.n_frames is not None for r in readers) and verbose:
        print("warning: n_frames present in only some shards — dropped "
              "from the merged store")
    if chunk <= 0:
        row_bytes = int(np.prod(readers[0].tensor_shape)) * 4 * (
            2 if indexed else 1)
        chunk = max(1, (64 * 1024 * 1024) // max(row_bytes, 1))

    # preserve the shards' on-disk value dtype (a float16 collection must
    # not silently double in size through an f32 merge)
    value_dtype = readers[0].mmaps[0].dtype
    for i, r in enumerate(readers[1:], start=1):
        if r.mmaps[0].dtype != value_dtype:
            # mixed-precision shards mean the hosts ran different configs —
            # a silent cast would corrupt one side's precision
            raise ValueError(
                f"shard{i} stores {r.mmaps[0].dtype} but shard0 stores "
                f"{value_dtype} — re-collect with one store_dtype"
            )
    writer = ActivationStoreWriter(
        out_folder, layer_name,
        tensor_shape=readers[0].tensor_shape,
        activation_shape=readers[0].activation_shape,
        indexed=indexed,
        store_dtype=value_dtype,
    )
    p = len(readers)
    written = 0
    buf: list[tuple] = []

    def flush():
        nonlocal written
        if not buf:
            return
        names = [b[0] for b in buf]
        arrays = [np.stack([b[1][a] for b in buf])
                  for a in range(len(buf[0][1]))]
        n_frames = [b[2] for b in buf] if buf[0][2] is not None else None
        writer.append_batch(names, *arrays, n_frames=n_frames)
        written += len(buf)
        buf.clear()
        if verbose:
            print(f"\rmerged {written}/{total} files", end="", flush=True)

    for j in range(total):
        r = readers[j % p]
        row = j // p
        if row >= len(r):
            raise ValueError(
                f"shard{j % p} is missing row {row} — shards are not a "
                f"complete strided split of one dataset"
            )
        *arrays, names = r.batch(np.asarray([row]))
        nf = int(r.n_frames[row]) if has_nf else None
        buf.append((names[0], [a[0] for a in arrays], nf))
        if len(buf) >= chunk:
            flush()
    flush()
    writer.close()
    if verbose:
        print()
    if build_index and not indexed:
        from ..data.feature_store import build_feature_major_index

        build_feature_major_index(out_folder, layer_name, verbose=verbose)
    return {"n_files": total, "shards": p, "out_folder": out_folder}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out_folder", required=True)
    ap.add_argument("--layer_name", required=True)
    ap.add_argument("--build_index", action="store_true",
                    help="build the feature-major search index over the "
                         "merged store (dense layouts)")
    args = ap.parse_args(argv)
    import json

    print(json.dumps(merge_shards(args.out_folder, args.layer_name,
                                  build_index=args.build_index)))


if __name__ == "__main__":
    main()
