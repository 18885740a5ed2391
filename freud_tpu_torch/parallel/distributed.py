"""Process-group start-up for runs over several cards (torch.distributed).

The port of ``freud_tpu/parallel/distributed.py``. In the port one process
drives one card, so a rank is what a JAX host with one local chip is. Each
process calls ``initialize()`` once, before it builds a mesh
(``parallel/mesh.py``) or calls an entry point (``train``,
``get_activations``, ...); with one process, or without a call, every path
is the single-card path.

``initialize`` maps JAX's arguments onto ``init_process_group``:
``coordinator_address`` ``host:port`` → ``tcp://host:port``,
``num_processes`` → the world size, ``process_id`` → the rank. Left out,
they come from the variables ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend follows the device:
NCCL for a CUDA device, gloo for the CPU. Gloo on CUDA tensors is used only
when the caller names it (``backend="gloo"``): NCCL refuses two ranks on one
card, and that is the only reason to ask for it. As in JAX, a process that
was told it is part of a pod never goes on alone: a failed start-up raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

# the device ``initialize`` bound this process to (``make_mesh`` takes it)
_device: Optional[torch.device] = None


def default_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The caller's ``device``; else the one ``initialize`` bound; else
    ``cuda:LOCAL_RANK``. Never the CPU unless the caller asks for it."""
    if device is not None:
        return resolve_device(device, what="distributed run",
                              hint='pass device="cpu" to run the ranks on the CPU')
    if _device is not None:
        return _device
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}",
                          what="distributed run",
                          hint='pass device="cpu" to run the ranks on the CPU')


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str | torch.device] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group (a no-op when it is already joined, and when
    nothing says this process is part of a pod).

    ``backend``: ``None`` picks NCCL for a CUDA ``device`` and gloo for the
    CPU; ``"gloo"`` on a CUDA device only when named here. ``device``: the
    card this rank drives (default ``cuda:LOCAL_RANK``)."""
    global _device
    if dist.is_initialized():
        return
    env = os.environ
    pod_signals = (coordinator_address, env.get("MASTER_ADDR"),
                   env.get("COORDINATOR_ADDRESS"))
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    if (world is None or int(world) == 1) and not any(pod_signals):
        # single-process: say so (a silent no-op once hid N independent runs)
        print("torch.distributed not initialized (single-process)")
        return
    dev = default_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device; "
                         f"got device {str(dev)!r}")
    kw = {"backend": backend, "timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
        kw["world_size"] = int(world if world is not None else 1)
        kw["rank"] = int(process_id if process_id is not None
                         else env.get("RANK", 0))
    else:
        # torchrun's variables (env://); explicit counts override them
        kw["init_method"] = "env://"
        if world is not None:
            kw["world_size"] = int(world)
        if process_id is not None:
            kw["rank"] = int(process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    # a process told it is part of a pod never proceeds alone: any failure
    # here propagates
    dist.init_process_group(**kw)
    _device = dev


def shutdown() -> None:
    """Leave the process group (the end of a run, or of a test)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def process_info() -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def is_main_process() -> bool:
    """Rank 0, or no process group: the process that writes a run's
    host-side artifacts (checkpoints, TensorBoard, transcripts)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits for the others (a no-op without a process group)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
