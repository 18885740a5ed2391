"""Audio dataset downloader: LibriSpeech, AudioSet, ESC-50.

The port of ``freud_tpu/scripts/download_audio_datasets.py``, framework-free
as the original is (``requests`` and the standard library): fetches the
LibriSpeech test-other / dev-other / train-other-500 splits from OpenSLR,
the balanced AudioSet train + eval tars (HuggingFace agkphysics/AudioSet)
with their CSVs and ontology, and ESC-50 from GitHub; streams to disk in
chunks, extracts tar/zip archives, and removes the archive afterwards.

Usage:
  python -m freud_tpu_torch.scripts.download_audio_datasets --dataset librispeech \
      --out audio_data
"""

from __future__ import annotations

import argparse
import shutil
import tarfile
import zipfile
from pathlib import Path

_LIBRISPEECH_ROOT = "https://www.openslr.org/resources/12"
_AUDIOSET_ROOT = (
    "https://huggingface.co/datasets/agkphysics/AudioSet/resolve/main/data"
)
_ESC50_URL = "https://github.com/karolpiczak/ESC-50/archive/master.zip"

DATASETS: dict[str, list[str]] = {
    "librispeech": [
        f"{_LIBRISPEECH_ROOT}/test-other.tar.gz",
        f"{_LIBRISPEECH_ROOT}/dev-other.tar.gz",
        f"{_LIBRISPEECH_ROOT}/train-other-500.tar.gz",
    ],
    "audioset": (
        [f"{_AUDIOSET_ROOT}/bal_train{i:02d}.tar" for i in range(10)]
        + [f"{_AUDIOSET_ROOT}/eval{i:02d}.tar" for i in range(9)]
        + [
            f"{_AUDIOSET_ROOT}/balanced_train_segments.csv",
            f"{_AUDIOSET_ROOT}/eval_segments.csv",
            f"{_AUDIOSET_ROOT}/ontology.json",
        ]
    ),
    "esc50": [_ESC50_URL],
}


def download_file(url: str, dest: Path, chunk_size: int = 1 << 20) -> Path:
    import requests

    dest.parent.mkdir(parents=True, exist_ok=True)
    with requests.get(url, stream=True, timeout=60) as r:
        r.raise_for_status()
        tmp = dest.with_suffix(dest.suffix + ".part")
        with open(tmp, "wb") as f:
            for chunk in r.iter_content(chunk_size=chunk_size):
                if chunk:
                    f.write(chunk)
        tmp.rename(dest)
    return dest


def extract_archive(path: Path, out_dir: Path, delete: bool = True) -> None:
    name = path.name
    if name.endswith((".tar.gz", ".tgz")):
        with tarfile.open(path, "r:gz") as t:
            # filter="data" blocks path traversal / absolute members /
            # device nodes from a compromised or corrupted archive (and is
            # the 3.14 default)
            t.extractall(out_dir, filter="data")
    elif name.endswith(".tar"):
        with tarfile.open(path, "r") as t:
            t.extractall(out_dir, filter="data")
    elif name.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(out_dir)
    else:
        return  # plain file (csv/json) — keep in place
    if delete:
        path.unlink()


def download_dataset(dataset: str, out_root: str, keep_archives: bool = False) -> None:
    if dataset not in DATASETS:
        raise ValueError(f"Unknown dataset {dataset!r}; choose from {sorted(DATASETS)}")
    out_dir = Path(out_root) / dataset
    out_dir.mkdir(parents=True, exist_ok=True)
    for url in DATASETS[dataset]:
        fname = url.rsplit("/", 1)[-1]
        dest = out_dir / fname
        marker = out_dir / f".{fname}.extracted"
        if marker.exists():
            # archives are deleted after extraction, so presence of the
            # archive itself can't signal completion — the marker does
            print(f"already extracted, skipping: {fname}")
            continue
        if dest.exists():
            # archive present but no marker: a previous run died between
            # download and extraction — finish the extraction, don't skip it
            print(f"archive present, extracting: {dest}")
        else:
            print(f"downloading {url}")
            download_file(url, dest)
        extract_archive(dest, out_dir, delete=not keep_archives)
        marker.touch()
    print(f"done: {out_dir} ({shutil.disk_usage(out_dir).free >> 30} GiB free)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", required=True, choices=sorted(DATASETS),
                        help="Which dataset to download")
    parser.add_argument("--out", default="audio_data", help="Output root folder")
    parser.add_argument("--keep_archives", action="store_true")
    args = parser.parse_args(argv)
    download_dataset(args.dataset, args.out, args.keep_archives)


if __name__ == "__main__":
    main()
