"""A fused chunk of K train steps as one CUDA graph: the port's ``lax.scan``
over sample+step (``freud_tpu/train/trainer.py::_build_train_chunk``).

The graph holds the K steps unrolled, each reading its row of a (K, B)
index buffer that the caller fills before the replay, and returns the
(K,) metric stack: one launch a chunk, as JAX's one dispatch, and no host
work between steps. Everything a step reads or updates (the window, the
index buffer, parameters, optimizer moments and count, dead-feature
counters) lives at a fixed address and is updated in place; what a step
allocates comes from the graph's private pool, where each step reuses the
blocks the step before freed.

Kernel launches under replay: a wrapper counts into ``.captured`` while
its stream is capturing (it launches nothing then), and each replay adds
the launches it holds to the wrapper's ``.launches``, for every wrapper
``_native.counted`` marked.

The tensor maps that kernels #1, #2, #4 and #5 build on the host
(``csrc/hopper.cuh``) are kernel parameters, so capture bakes them in with
the operand addresses of the capture. That is correct only because those
operands are allocated inside the captured region, from the graph's
private pool, at the same addresses on every replay.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import profiling
from .._native import COUNTED
from ..data.device_cache import sample_rows


class CapturedChunk:
    def __init__(self, graph: torch.cuda.CUDAGraph, out: dict, launches: dict):
        self.graph = graph
        self.out = out
        self.launches = launches  # wrapper → launches a replay

    def replay(self) -> dict:
        """One replay; → a copy of the (K,) metric stack."""
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return {k: v.clone() for k, v in self.out.items()}


def capture_chunk(step: Callable[[int], dict], n_steps: int, state: list,
                  what: str) -> CapturedChunk:
    """Capture ``step(0) … step(n_steps - 1)`` (each → a dict of 0-dim
    metric tensors) as one CUDA graph.

    Warm-up first, as the PyTorch graph recipe asks: one eager step on a
    side stream loads every kernel and library handle; ``state`` (the
    tensors the step updates in place) is put back as it was, so the warm-up
    trains nothing. A capture that fails raises, naming the step."""
    cur = torch.cuda.current_stream()
    snapshot = [t.detach().clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        step(0)
    cur.wait_stream(side)
    with torch.no_grad():
        for t, s in zip(state, snapshot):
            t.copy_(s)
    del snapshot
    torch.cuda.synchronize()
    # what the warm-up cached in the shared pool is of no use to the
    # graph's private pool
    torch.cuda.empty_cache()
    before = {fn: fn.captured for fn in COUNTED}
    graph = torch.cuda.CUDAGraph()
    i = 0
    try:
        # thread-local: the cache's producer and the checkpoint writer
        # allocate pinned memory and copy on other threads meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            stack = []
            for i in range(n_steps):
                stack.append(step(i))
            out = {k: torch.stack([m[k] for m in stack]) for k in stack[0]}
    except Exception as e:
        raise RuntimeError(
            f"{what}: step {i + 1} of the {n_steps}-step chunk would not capture "
            f"as a CUDA graph ({type(e).__name__}: {e}); the chunk does not "
            "fall back to eager steps (set fused_steps to 0 to train per step)"
        ) from e
    launches = {fn: fn.captured - n for fn, n in before.items() if fn.captured > n}
    return CapturedChunk(graph, out, launches)


def run_chunk(chunks: dict, step: Callable[[torch.Tensor], dict], window: torch.Tensor,
              indices: torch.Tensor, state: list, what: str,
              graph: bool | None = None) -> dict:
    """``step`` (a (B, T, d) device batch → a dict of metric tensors) on the
    window rows ``indices[i]`` for each of the (n_steps, B) index block's
    rows. On a CUDA window the steps run as one replay of a graph captured
    once per (n_steps, B) and window, kept in ``chunks``; the graph reads
    the window and its own index buffer in place, so ``indices`` is copied
    in before each replay. On the CPU, or with ``graph`` False (a step whose
    collectives cannot be captured), they run as a loop of the same body.
    → the per-step metric stack, each metric with a leading n_steps axis."""
    n_steps = indices.shape[0]
    if graph is None:
        graph = window.device.type == "cuda"
    if not graph:
        with profiling.span("chunk_replay"):
            stack = [step(sample_rows(window, indices[i])) for i in range(n_steps)]
            return {k: torch.stack([m[k] for m in stack]) for k in stack[0]}
    key = tuple(indices.shape)
    captured = chunks.get(key)
    if captured is None or captured[0] is not window:
        idx = torch.zeros(key, dtype=torch.int64, device=window.device)
        with profiling.span("chunk_capture"):
            chunk = capture_chunk(lambda i: step(sample_rows(window, idx[i])), n_steps,
                                  state, what)
        captured = chunks[key] = (window, idx, chunk)
    _, idx, chunk = captured
    idx.copy_(indices)
    # the launch of a many-step graph returns only once the card has taken
    # much of its work: this span is the host's wait on the replay
    with profiling.span("chunk_replay"):
        return chunk.replay()
