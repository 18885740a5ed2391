"""Audio-folder dataset and prefetching batch pipeline.

The pipeline of ``freud_tpu/data/audio_dataset.py`` on a CUDA card: the
native decoder fills one contiguous (B, 480000) float32 buffer per batch on
a thread pool — on CUDA that buffer is pinned host memory, so the copy to
the card is asynchronous (``non_blocking=True``) — and the log-mel for the
whole batch runs on the device (the CUDA log-mel kernel). A one-deep
prefetch thread overlaps next-batch decode with current-batch device work.

File order is sorted for determinism.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from .. import profiling
from ..audio.decode import load_audio_batch
from ..audio.mel import batched_log_mel
from ..constants import N_SAMPLES, is_audio_file

_PREFETCH_DEPTH = 2  # decoded batches held ahead of the device


def list_audio_files(folder: str) -> list[str]:
    """Sorted audio files under ``folder`` — or ``[folder]`` itself when it
    IS a single audio file."""
    if os.path.isfile(folder):
        return [os.path.abspath(folder)] if is_audio_file(folder) else []
    files = []
    for root, _dirs, names in os.walk(folder):
        root = os.path.abspath(root)
        for name in names:
            if is_audio_file(name):
                files.append(os.path.join(root, name))
    files.sort()
    return files


class AudioBatchPipeline:
    """Iterates (mels, filenames, true_lengths) batches over an audio folder;
    ``mels`` is a (B, n_mels, 3000) float32 tensor on ``device``."""

    def __init__(
        self,
        folder: str,
        batch_size: int,
        n_mels: int,
        subset_size: Optional[int] = None,
        decode_threads: int | None = None,
        exclude: Optional[set] = None,
        device: torch.device | str = "cpu",
        drop_last: bool = False,
        shard: tuple[int, int] | None = None,
    ):
        """``shard=(i, n)`` keeps every n-th file starting at i: the pod
        collection split (every rank walks the same sorted list, so the
        shards are disjoint and exhaustive; ``subset_size`` applies to the
        full list first so the ranks agree on the universe). ``exclude``:
        file paths to skip, applied after ``subset_size`` and ``shard`` so a
        resumed run keeps the original run's universe and split.
        ``drop_last`` leaves out a last batch shorter than ``batch_size``."""
        self.files = list_audio_files(folder)
        if subset_size is not None:
            self.files = self.files[:subset_size]
        if shard is not None:
            idx, count = shard
            if not (0 <= idx < count):
                raise ValueError(f"bad shard {shard}")
            self.files = self.files[idx::count]
        if exclude:
            self.files = [f for f in self.files if f not in exclude]
        self.batch_size = batch_size
        self.n_mels = n_mels
        self.decode_threads = decode_threads
        self.device = torch.device(device)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.files)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def dataset_length(self) -> int:
        return len(self.files)

    def _batches(self) -> list[list[str]]:
        return [self.files[i : i + self.batch_size]
                for i in range(0, len(self) * self.batch_size, self.batch_size)]

    def _host_buffer(self, n: int) -> torch.Tensor:
        # pinned on CUDA: the host→device copy then runs asynchronously
        return torch.empty((n, N_SAMPLES), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def __iter__(self) -> Iterator[tuple[torch.Tensor, list[str], np.ndarray]]:
        from .prefetch import prefetch_iter

        def decoded():
            for chunk in self._batches():
                with profiling.span("decode_batch"):
                    buf = self._host_buffer(len(chunk))
                    _, lengths = load_audio_batch(
                        chunk, frame_len=N_SAMPLES,
                        n_threads=self.decode_threads, out=buf.numpy(),
                    )
                yield buf, chunk, lengths

        # the shared cancellable prefetch handles early close and forwards
        # decode exceptions instead of hanging the consumer
        for buf, chunk, lengths in prefetch_iter(decoded(), _PREFETCH_DEPTH):
            with profiling.span("mel_batch"):
                audio = buf.to(self.device, non_blocking=True)
                mels = batched_log_mel(audio, self.n_mels)
            yield mels, chunk, lengths
