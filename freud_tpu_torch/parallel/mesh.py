"""The (data × model) mesh over ranks, its collectives and the batch helpers
(torch.distributed).

The port of ``freud_tpu/parallel/mesh.py``. JAX builds one ``Mesh`` over the
chips with a ``data`` axis (the batch) and a ``model`` axis (the
dictionary), and XLA inserts the collectives. In the port one process drives
one card, so a mesh is the ranks of a process group laid out as JAX lays
out its devices: ``make_mesh(model_parallel=P)`` over W ranks puts rank r at
data index ``r // P`` and model index ``r % P`` (the model axis is the fast
one). The ranks of one data index form a model group (consecutive ranks),
the ranks of one model index a data group (strided ranks). A rank is what a
JAX host with one local chip is: ``is_multiprocess(mesh)`` holds whenever
the world has more than one rank.

The data axis: each data index holds a contiguous slice of a global batch,
in data-rank order (``host_shard_bounds``: the slice ``put_batch`` takes
from a global batch that every rank holds, and the slice a pod loader reads
with ``host_bounds``). Model peers (the ranks of one model group) hold the
SAME rows, as JAX replicates the batch over ``model``. A batch that does not
divide by the data axis stays whole on every rank, with JAX's warn-once
rule. ``all_reduce``, ``all_reduce_flat``, ``broadcast_`` and
``gather_rows`` run over the data group.

The model axis (the trainer's ``shard_dict``): each model index holds
``n_dict / P`` dictionary rows (``dict_bounds``, ``shard_dict_slice``,
``gather_dict``). Its collectives run over the model group:
``model_all_reduce`` (sum, min, max), ``model_all_gather`` (bit-exact) and
the two autograd pieces of a row-sharded product, ``model_sum`` (a SUM
forward, identity backward: partial decodes) and ``model_copy`` (identity
forward, a SUM backward: a replicated input read by every shard).

With no process group every collective is a no-op, and with one rank on an
axis the axis' collectives return their input unchanged.
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

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Mesh:
    """This rank's place on the (data × model) mesh: the process group (None
    for a mesh of this process alone), rank, world size, the model axis'
    size, the data and model groups and the rank's card."""

    def __init__(self, device: torch.device | str, group=None, model_size: int = 1,
                 data_group=None, model_group=None):
        self.device = torch.device(device)
        self.group = group
        self.model_size = model_size
        # None: no collective on that axis (one rank on it); with
        # model_size 1 the data group is the whole group
        self._data_group = data_group
        self.model_group = model_group
        if group is None:
            self.rank, self.world_size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def data_group(self):
        return self.group if self.model_size == 1 else self._data_group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_size}

    @property
    def size(self) -> int:
        return self.world_size

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, world_size={self.world_size}, "
                f"shape={self.shape}, device={self.device}, backend={self.backend})")


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
    """The (data × model) mesh over every rank of the process group (this
    process alone without one): ``model_parallel`` ranks a model group, the
    world size over it a data group, JAX's device layout. Every rank must
    call it, in the same order as its other group creations
    (``dist.new_group`` is collective). ``device``: this rank's card
    (default: the one ``initialize`` bound, else ``cuda:LOCAL_RANK``).
    ``devices``: JAX's local-chip mesh, here one device: a mesh of this
    process alone, as a pod collection uses. ``n_devices``, when given,
    must be the world size."""
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(
                f"one process drives one card: a local mesh takes one device, "
                f"got {len(devices)}")
        if model_parallel != 1:
            raise ValueError(f"1 devices not divisible by model_parallel={model_parallel}")
        return Mesh(default_device(device if device is not None else devices[0]))
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {world} "
            "rank(s), one card each")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    data_group = model_group = None
    if group is not None and model_parallel > 1:
        rank, p = dist.get_rank(), model_parallel
        # every rank creates every group, model groups first, in one order
        for d in range(world // p):
            ranks = list(range(d * p, (d + 1) * p))
            g = dist.new_group(ranks)
            if rank in ranks:
                model_group = g
        if world > p:
            for m in range(p):
                ranks = list(range(m, world, p))
                g = dist.new_group(ranks)
                if rank in ranks:
                    data_group = g
    return Mesh(default_device(device), group, model_parallel, data_group, model_group)


def local_mesh(mesh: Mesh) -> Mesh:
    """A mesh of this rank alone, on its card (JAX's
    ``make_mesh(devices=jax.local_devices())``)."""
    return Mesh(mesh.device)


def divisible_batch(batch: int, mesh: Mesh) -> bool:
    return batch % mesh.shape[DATA_AXIS] == 0


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """True when the mesh spans more than one rank: the pod case, where
    host data is read and placed per rank (on either axis)."""
    return mesh is not None and mesh.size > 1


def host_shard_bounds(global_batch: int, mesh: Mesh) -> tuple[int, int]:
    """[lo, hi) rows of a global batch this rank owns: contiguous, in
    data-rank order, the same split on every rank (model peers own the same
    rows)."""
    n = mesh.data_size
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def split_bounds(n: int, mesh: Optional[Mesh]) -> tuple[int, int]:
    """[lo, hi) of ``n`` rows this rank works on when every rank holds all
    of them: contiguous, in data-rank order, the sizes as even as ``n``
    allows (all ``n`` without a mesh)."""
    if mesh is None:
        return 0, n
    r, size = mesh.data_rank, mesh.data_size
    return r * n // size, (r + 1) * n // size


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
        elif mesh.data_size > 1 and not expected_tail and not _warned_replicated:
            _warned_replicated = True
            warnings.warn(
                f"batch of {b} is not divisible by the mesh's data axis "
                f"({mesh.data_size}); every rank keeps it WHOLE — correct but not "
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
    """In-place all-reduce of ``t`` over the mesh's data axis (``sum``,
    ``max`` or ``min``); → ``t``. A no-op without a process group."""
    if mesh is not None and mesh.data_group is not None:
        dist.all_reduce(t, op=_OPS[op], group=mesh.data_group)
    return t


def broadcast_(mesh: Optional[Mesh], tensors: list) -> None:
    """Overwrite each tensor in place with data rank 0's copy (the first
    rank of this rank's data group: one source a model index). A no-op
    without a process group."""
    group = None if mesh is None else mesh.data_group
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)


def all_reduce_flat(mesh: Optional[Mesh], tensors: list) -> list:
    """Sum each tensor over the data axis in ONE collective (one flat
    buffer); → new tensors of the same shapes."""
    if mesh is None or mesh.data_group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=_OPS["sum"], group=mesh.data_group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def gather_rows(mesh: Optional[Mesh], local: torch.Tensor, lo: int,
                total: int) -> torch.Tensor:
    """Every data rank's rows in one (total, ...) tensor on every rank,
    where this rank's ``local`` rows sit at [lo, lo + len(local)) and the
    data ranks' ranges tile [0, total). Bit-exact for any dtype: the rows
    are summed as bytes into a zero buffer, so a value crosses no float
    arithmetic (gloo has no all-gather for CUDA tensors; an all-reduce
    serves both backends)."""
    if mesh is None or mesh.data_group is None:
        return local
    return _byte_sum_gather(local, lo, total, mesh.data_group)


def _byte_sum_gather(local: torch.Tensor, lo: int, total: int, group) -> torch.Tensor:
    local = local.contiguous()
    full = local.new_zeros((total, *local.shape[1:]))
    full[lo:lo + local.shape[0]] = local
    dist.all_reduce(full.view(torch.uint8), op=_OPS["sum"], group=group)
    return full


# ------------------------------------------------------------- the model axis


def model_sharded(mesh: Optional[Mesh]) -> bool:
    """True when the mesh's model axis has more than one rank (the
    dictionary is split and the model collectives run)."""
    return mesh is not None and mesh.model_group is not None


def dict_bounds(n_dict: int, mesh: Optional[Mesh]) -> tuple[int, int]:
    """[lo, hi) of the ``n_dict`` dictionary rows this rank holds: contiguous,
    in model-rank order (all of them without a model axis)."""
    p = 1 if mesh is None else mesh.model_size
    if n_dict % p:
        raise ValueError(f"n_dict {n_dict} not divisible by model_parallel={p}")
    per = n_dict // p
    r = 0 if mesh is None else mesh.model_rank
    return r * per, (r + 1) * per


def shard_dict_slice(t: torch.Tensor, axis: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a full tensor's dictionary ``axis``, contiguous
    (JAX's ``dict_sharding(mesh, axis, ndim)`` shard)."""
    lo, hi = dict_bounds(t.shape[axis], mesh)
    return t.narrow(axis, lo, hi - lo).contiguous()


def model_all_gather(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """Every model rank's ``t`` stacked in model-rank order: → (P, *t.shape)
    on every rank of the model group, bit-exact (the byte-sum gather of
    ``gather_rows``)."""
    if not model_sharded(mesh):
        return t[None]
    return _byte_sum_gather(t[None], mesh.model_rank, mesh.model_size, mesh.model_group)


def gather_dict(mesh: Optional[Mesh], t: torch.Tensor, axis: int) -> torch.Tensor:
    """The full tensor from every model rank's shard of dictionary ``axis``
    (``shard_dict_slice``'s inverse), on every rank of the model group."""
    if not model_sharded(mesh):
        return t
    return torch.cat(list(model_all_gather(mesh, t).unbind(0)), dim=axis)


def model_all_reduce(mesh: Optional[Mesh], t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` over the model group (``sum``, ``min``
    or ``max``); → ``t``."""
    if model_sharded(mesh):
        dist.all_reduce(t, op=_OPS[op], group=mesh.model_group)
    return t


class _ModelSum(torch.autograd.Function):
    """SUM over the model group forward; identity backward: every model rank
    holds the whole (replicated) loss, so the gradient of its own partial is
    the gradient of the sum."""

    @staticmethod
    def forward(ctx, t, mesh):
        out = t.clone()
        dist.all_reduce(out, op=_OPS["sum"], group=mesh.model_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    """Identity forward; SUM over the model group backward: a replicated
    input that every shard reads gets the sum of the shards' gradients."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=_OPS["sum"], group=ctx.mesh.model_group)
        return g, None


def model_sum(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group (differentiable: identity
    backward); ``t`` itself without a model axis."""
    return _ModelSum.apply(t, mesh) if model_sharded(mesh) else t


def model_copy(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` (differentiable: its gradient summed over the model group);
    ``t`` itself without a model axis."""
    return _ModelCopy.apply(t, mesh) if model_sharded(mesh) else t
