"""Device-resident activation shuffle cache for SAE training (PyTorch).

The port of ``freud_tpu/data/device_cache.py``. Streaming every batch from
the host store costs a one-thread mmap gather and a host→device copy a step
(~230 MB at tiny_l1). The cache keeps a window of files resident on the
device, serves batches as on-device gathers (``torch.randint`` over the
window's rows, ``index_select``, the f32 upcast), and a background producer
refreshes random slots from the store.

Sampling semantics, as in JAX: batches are drawn uniformly from the resident
window (files recur until evicted), the shuffle-buffer trade surfaced as the
``device_cache_files`` train option. The window is filled from the head of a
numpy shuffle order seeded ``(seed, start_step)`` and refreshed along the
same order, so the fill and the refresh plan equal JAX's. The indices come
from a ``torch.Generator`` on the cache's device seeded from ``(seed,
start_step)``: not JAX's PRNG stream, which the port does not copy.

On a CUDA device the window keeps one address for its whole life — a
captured CUDA graph (``SAETrainer.train_chunk``) reads it — so a refresh is
an in-place ``index_copy_``. The producer thread uploads each refresh from
pinned host memory on a side stream and records an event; the consumer's
stream waits on that event before the copy, so nothing on the training
thread waits for the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import mesh as mesh_lib
from .loaders import MemoryMappedActivationLoader, resample_padding_rows

CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sample_rows_raw(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (any shape) of the window, in its storage dtype:
    → (*idx.shape, T, d)."""
    return cache.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *cache.shape[1:])


def sample_rows(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``sample_rows_raw`` upcast to f32 (exact from bf16): THE sampling
    body of ``next_batch`` and of the trainer's fused chunks."""
    return sample_rows_raw(cache, idx).to(torch.float32)


def _last_of_each_slot(rows: np.ndarray, slots: np.ndarray):
    """Drop all but the last row aimed at each slot: the scatter then has
    one writer a slot, and the window equals a sequential scatter's (JAX on
    the CPU: the last write wins)."""
    _, first_rev = np.unique(slots[::-1], return_index=True)
    keep = np.sort(len(slots) - 1 - first_rev)
    return rows[keep], slots[keep]


class DeviceShuffleCache:
    def __init__(
        self,
        data_path: str,
        layer_name: str,
        capacity_files: int,
        refresh_files: int = 16,
        seed: int = 0,
        subset_size: Optional[int] = None,
        start_step: int = 0,
        process_shard: Optional[tuple] = None,
        mesh=None,
        cache_dtype: str = "float32",
        device: torch.device | str | None = None,
        reserve_bytes: int = 0,
    ):
        """``start_step``: fold the resume position into the file order and
        the sampler's seed, so a resumed run does not re-issue the
        start-of-run sample sequence (exact stream replay is impossible by
        construction: the refresh is timing-dependent).

        ``cache_dtype="bfloat16"`` stores the window in bf16: twice the
        files per byte, half the refresh upload and gather traffic; samples
        upcast to f32.

        ``reserve_bytes`` (CUDA): device memory the caller keeps for its own
        work (the train step's working set). The window must fit in what
        ``torch.cuda.mem_get_info`` reports free, less that and the refresh
        staging; else a ValueError names the largest ``capacity_files``
        that fits. The window is never shrunk silently.

        ``process_shard=(i, n)``: the pod mode. This rank caches and samples
        only its strided file stratum (every n-th store file from i), with
        its fill order and generator seeded from (seed, start_step, i) as
        JAX's per-host PRNGs are; the global batch is every rank's sample
        (``SAETrainer.train_chunk_pod``). Each rank's memory, reads and
        refresh traffic stay constant as the pod grows.

        ``mesh``: the window lives on the rank's card (``device`` defaults
        to the mesh's). JAX replicates the window over a single process's
        chips; a rank has one card, so the placement is the card. Without
        either the window is on the card (``device="cpu"`` for the CPU;
        without CUDA anything else raises)."""
        mesh_lib.check_mesh(mesh)
        if device is None and mesh is not None:
            device = mesh.device
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(
                f"cache_dtype must be float32 or bfloat16, got {cache_dtype}")
        self.dtype = CACHE_DTYPES[cache_dtype]
        self.device = resolve_device(device, what="device cache",
                                     hint='pass device="cpu" to keep the window on the CPU')
        self.loader = MemoryMappedActivationLoader(
            data_path, layer_name, batch_size=max(refresh_files, 1),
            subset_size=subset_size, shuffle=True, drop_last=False, seed=seed,
        )
        if self.loader.activation_type != "tensor":
            raise ValueError("device cache supports dense activation stores")
        # decoder-layer stores are EOT-padded past each file's valid decode
        # positions: padding rows are resampled from valid ones at fill and
        # refresh (per-file-deterministic, so every refresh of a file
        # reproduces identical rows)
        self._resample = (layer_name.startswith("decoder.")
                          and self.loader.reader.n_frames is not None)
        self._store_seed = seed
        n_store = self.loader.dataset_length
        if process_shard is not None:
            pi, pc = process_shard
            if not (0 <= pi < pc):
                raise ValueError(f"bad process_shard {process_shard}")
            self._files = np.arange(n_store)[pi::pc]
            seed_tuple = (seed, start_step, pi)
        else:
            self._files = np.arange(n_store)
            seed_tuple = (seed, start_step)
        n = len(self._files)
        if n == 0:
            raise ValueError("device cache shard holds no files")
        self.capacity = min(capacity_files, n)
        self.refresh_files = refresh_files if n > self.capacity else 0
        self._rng = np.random.default_rng(seed_tuple)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(
            np.random.SeedSequence(seed_tuple).generate_state(1, np.uint64)[0]))

        reader = self.loader.reader
        file_bytes = int(np.prod(reader.tensor_shape)) * self.dtype.itemsize
        if self.device.type == "cuda":
            self._check_fits(file_bytes, reserve_bytes)
        # fill from the head of the SHUFFLE ORDER, not store order: a
        # sequentially-written store would otherwise bias early training to
        # a correlated prefix, and the refresh cursor (which starts at
        # capacity into this order) would skip a random non-resident subset
        # for a whole epoch
        self._order0 = self._rng.permutation(n)
        fill_idx = np.sort(self._files[self._order0[: self.capacity]])
        first = self._resample_rows(reader.batch(fill_idx)[0], fill_idx)
        self.cache = self._host_rows(first).to(self.device)
        self.window_bytes = self.cache.numel() * self.cache.element_size()

        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        if self.refresh_files:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
        else:
            self._thread = None

    def _check_fits(self, file_bytes: int, reserve_bytes: int) -> None:
        free, _ = torch.cuda.mem_get_info(self.device)
        # the queue's two staged refreshes and the one being built
        staging = 3 * self.refresh_files * file_bytes
        room = free - reserve_bytes - staging
        if self.capacity * file_bytes > room:
            raise ValueError(
                f"device_cache_files={self.capacity} needs "
                f"{self.capacity * file_bytes / 2**30:.3f} GiB for the window, but "
                f"{self.device} has {free / 2**30:.3f} GiB free, less "
                f"{reserve_bytes / 2**30:.3f} GiB kept for the train step and "
                f"{staging / 2**30:.3f} GiB of refresh staging: the largest "
                f"device_cache_files that fits is {max(room // file_bytes, 0)}")

    def _host_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Store rows as a host tensor of the window's dtype (bf16 by
        round-to-nearest-even, as JAX's cast)."""
        return torch.from_numpy(np.asarray(rows, np.float32)).to(self.dtype)

    def _resample_rows(self, rows: np.ndarray, file_idx: np.ndarray):
        if not self._resample:
            return rows
        nf = self.loader.reader.n_frames
        return resample_padding_rows(
            rows, file_idx, [nf[i] for i in file_idx], self._store_seed)

    def _stage(self, rows: np.ndarray, slots: np.ndarray):
        """One refresh item: (rows, slots, event) on the cache's device. On
        the card the upload runs here, on the producer thread: pinned rows,
        a copy on the side stream, and an event the consumer waits on."""
        rows, slots = _last_of_each_slot(rows, slots)
        host, host_slots = self._host_rows(rows), torch.from_numpy(slots)
        if self._side is None:
            return host, host_slots, None
        with torch.cuda.stream(self._side):
            dev_rows = host.pin_memory().to(self.device, non_blocking=True)
            dev_slots = host_slots.pin_memory().to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._side)
        return dev_rows, dev_slots, event

    def _producer(self):
        try:
            reader = self.loader.reader
            n = len(self._files)
            # continue the SAME permutation the initial fill consumed —
            # cursor starts right after the resident files
            cursor = self.capacity
            order = self._order0
            while not self._stop.is_set():
                take = []
                while len(take) < self.refresh_files:
                    if cursor >= n:
                        order = self._rng.permutation(n)
                        cursor = 0
                    take.append(order[cursor])
                    cursor += 1
                refresh_idx = self._files[np.asarray(take)]
                rows = self._resample_rows(reader.batch(refresh_idx)[0], refresh_idx)
                slots = self._rng.integers(0, self.capacity, self.refresh_files)
                # the queue bound (2) caps the staged device buffers
                item = self._stage(rows, slots)
                while not self._stop.is_set():
                    # retry the SAME item: dropping it on a full queue would
                    # busy-loop on wasted disk reads and skip these files'
                    # cache residency entirely
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface I/O errors to next_batch —
            self._error = e         # a silently dead refresher would freeze
            return                  # the shuffle window for the whole run

    def _apply_pending_refresh(self) -> None:
        if self._error is not None:
            raise RuntimeError("device-cache refresh thread died") from self._error
        if self._thread is None:
            return
        try:
            rows, slots, event = self._q.get_nowait()
        except queue.Empty:
            return
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # the side stream allocated them: keep them until this stream's
            # copy has read them
            rows.record_stream(stream)
            slots.record_stream(stream)
        self.cache.index_copy_(0, slots, rows)

    def draw(self, n_steps: int, batch_size: int) -> torch.Tensor:
        """(n_steps, batch_size) int64 window rows, in one launch."""
        return torch.randint(0, self.capacity, (n_steps, batch_size),
                             generator=self.generator, device=self.device)

    def next_batch(self, batch_size: int) -> torch.Tensor:
        """On-device (batch, T, d) f32 sample; applies any pending refresh
        first."""
        self._apply_pending_refresh()
        return sample_rows(self.cache, self.draw(1, batch_size)[0])

    def sample_state(self):
        """(window, generator) for a fused chunk, which draws its own
        indices; applies any pending refresh first (refresh lands at chunk
        boundaries). The generator advances in place; ``set_key`` replaces
        it."""
        self._apply_pending_refresh()
        return self.cache, self.generator

    def set_key(self, generator: torch.Generator) -> None:
        self.generator = generator

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
