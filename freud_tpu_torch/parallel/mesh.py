"""The data-parallel mesh over ranks, and the batch helpers (torch.distributed).

The port of ``freud_tpu/parallel/mesh.py``. JAX builds one ``Mesh`` over the
chips with a ``data`` axis (the batch) and a ``model`` axis (the
dictionary), and XLA inserts the collectives. In the port one process drives
one card, so the data axis is the ranks of a process group, and a rank is
what a JAX host with one local chip is: ``is_multiprocess(mesh)`` holds
whenever the world has more than one rank. The collectives are explicit
(``all_reduce``, ``all_reduce_flat``, ``gather_rows``); with no process
group they are no-ops, and with one rank they return their input unchanged.

Each rank holds a contiguous slice of a global batch, in rank order
(``host_shard_bounds``): the slice ``put_batch`` takes from a global batch
that every rank holds, and the slice a pod loader reads with
``host_bounds``. A batch that does not divide by the ranks stays whole on
every rank, with JAX's warn-once rule.

The model axis (``model_parallel > 1``, the trainer's ``shard_dict``) is
not ported: it row-shards the dictionary, and TopK then needs the k-th
largest value across shards, which none of the kernels computes (ROADMAP
Queue 1 #12c).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import default_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

MODEL_AXIS_TODO = ("the model axis (model_parallel > 1, shard_dict) is not "
                   "ported to freud_tpu_torch yet (ROADMAP Queue 1 #12c)")

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """This rank's place on the data axis: the process group (None for a
    mesh of this process alone), rank, world size and the rank's card."""

    def __init__(self, device: torch.device | str, group=None):
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.rank, self.world_size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world_size, MODEL_AXIS: 1}

    @property
    def size(self) -> int:
        return self.world_size

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, world_size={self.world_size}, "
                f"device={self.device}, backend={self.backend})")


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` if it is None or a ``Mesh``; anything else is refused."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a freud_tpu_torch.parallel.mesh.Mesh (make_mesh()), "
            f"got {type(mesh).__name__}")
    return mesh


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
    device: Optional[str | torch.device] = None,
) -> Mesh:
    """The data axis over every rank of the process group (this process
    alone without one). ``device``: this rank's card (default: the one
    ``initialize`` bound, else ``cuda:LOCAL_RANK``). ``devices``: JAX's
    local-chip mesh, here one device: a mesh of this process alone, as a
    pod collection uses. ``n_devices``, when given, must be the world
    size."""
    if model_parallel != 1:
        raise NotImplementedError(MODEL_AXIS_TODO)
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(
                f"one process drives one card: a local mesh takes one device, "
                f"got {len(devices)}")
        return Mesh(default_device(device if device is not None else devices[0]))
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = Mesh(default_device(device), group)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {mesh.size} "
            "rank(s), one card each")
    return mesh


def local_mesh(mesh: Mesh) -> Mesh:
    """A mesh of this rank alone, on its card (JAX's
    ``make_mesh(devices=jax.local_devices())``)."""
    return Mesh(mesh.device)


def divisible_batch(batch: int, mesh: Mesh) -> bool:
    return batch % mesh.shape[DATA_AXIS] == 0


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """True when the mesh spans more than one rank: the pod case, where
    host data is read and placed per rank."""
    return mesh is not None and mesh.size > 1


def host_shard_bounds(global_batch: int, mesh: Mesh) -> tuple[int, int]:
    """[lo, hi) rows of a global batch this rank owns: contiguous, in rank
    order, the same split on every rank."""
    n = mesh.size
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    return mesh.rank * per, (mesh.rank + 1) * per


def split_bounds(n: int, mesh: Optional[Mesh]) -> tuple[int, int]:
    """[lo, hi) of ``n`` rows this rank works on when every rank holds all
    of them: contiguous, in rank order, the sizes as even as ``n`` allows
    (all ``n`` without a mesh)."""
    if mesh is None:
        return 0, n
    return mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size


def _to_device(a, device: torch.device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=True)


_warned_replicated = False


def put_batch(mesh: Mesh, *arrays, expected_tail: bool = False):
    """This rank's rows of each global batch (axis 0), on its card. A batch
    that does not divide by the ranks stays whole on every rank (correct,
    not data-parallel): that warns once a process unless the caller marks
    it expected (``expected_tail``), since a training batch that never
    divides would train fully replicated."""
    global _warned_replicated
    out = []
    for a in arrays:
        b = int(np.shape(a)[0])
        if divisible_batch(b, mesh):
            lo, hi = host_shard_bounds(b, mesh)
            a = a[lo:hi]
        elif mesh.size > 1 and not expected_tail and not _warned_replicated:
            _warned_replicated = True
            warnings.warn(
                f"batch of {b} is not divisible by the mesh's data axis "
                f"({mesh.size}); every rank keeps it WHOLE — correct but not "
                "data-parallel. Expected for ragged validation tails; a "
                "training batch should be made divisible.", stacklevel=2)
        out.append(_to_device(a, mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def put_host_batch(mesh: Mesh, local_batch) -> torch.Tensor:
    """This rank's slice of a global batch (the rows ``host_shard_bounds``
    names), on its card. Nothing moves between ranks: each rank's rows go
    to its own card, and the step's collectives combine them."""
    return _to_device(local_batch, mesh.device)


def put_host_chunk(mesh: Mesh, local_stack) -> torch.Tensor:
    """``put_host_batch`` for a fused chunk's (n_steps, local_batch, ...)
    stack."""
    return _to_device(local_stack, mesh.device)


def pad_and_shard(mesh: Mesh, buf, batch_size: int) -> torch.Tensor:
    """Zero-pad a host batch's leading dim to ``batch_size`` (the collection
    loaders' ragged-tail rule: one shape a run, outputs trimmed by the
    caller), then this rank's slice of it, on its card."""
    buf = _to_device(buf, mesh.device)
    n = buf.shape[0]
    if n < batch_size:
        buf = torch.cat([buf, buf.new_zeros((batch_size - n, *buf.shape[1:]))])
    lo, hi = host_shard_bounds(batch_size, mesh)
    return buf[lo:hi]


# --------------------------------------------------------------- collectives


def all_reduce(mesh: Optional[Mesh], t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` over the mesh's ranks (``sum`` or
    ``max``); → ``t``. A no-op without a process group."""
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(t, op=_OPS[op], group=mesh.group)
    return t


def broadcast_(mesh: Optional[Mesh], tensors: list) -> None:
    """Overwrite each tensor in place with rank 0's (the mesh's first
    rank's) copy. A no-op without a process group."""
    if mesh is None or mesh.group is None:
        return
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=mesh.group)


def all_reduce_flat(mesh: Optional[Mesh], tensors: list) -> list:
    """Sum each tensor over the ranks in ONE collective (one flat buffer);
    → new tensors of the same shapes."""
    if mesh is None or mesh.group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=_OPS["sum"], group=mesh.group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def gather_rows(mesh: Optional[Mesh], local: torch.Tensor, lo: int,
                total: int) -> torch.Tensor:
    """Every rank's rows in one (total, ...) tensor on every rank, where
    this rank's ``local`` rows sit at [lo, lo + len(local)) and the ranks'
    ranges tile [0, total). Bit-exact for any dtype: the rows are summed as
    bytes into a zero buffer, so a value crosses no float arithmetic (gloo
    has no all-gather for CUDA tensors; an all-reduce serves both
    backends)."""
    if mesh is None or mesh.group is None:
        return local
    local = local.contiguous()
    full = local.new_zeros((total, *local.shape[1:]))
    full[lo:lo + local.shape[0]] = local
    dist.all_reduce(full.view(torch.uint8), op=_OPS["sum"], group=mesh.group)
    return full
