"""Lightweight tracing/profiling for pipeline stages.

Every hot pipeline stage wraps itself in ``span(name)``, which (a)
accumulates wall-clock per stage into a process-wide table, and (b) pushes an
NVTX range so stages show up on CUDA profiler timelines (``torch.profiler``,
Nsight) when a CUDA build of PyTorch is running. Same table and report as
``freud_tpu.profiling``; ``torch.cuda.nvtx.range`` takes the place of
``jax.profiler.TraceAnnotation``.

Spans time the host: a span around asynchronous CUDA work measures the
enqueue unless the stage itself waits for the device (``d2h_fetch`` does).

``trace(logdir)`` (or ``start_trace``/``stop_trace``) captures a
``torch.profiler`` trace of the host and, with a card, of CUDA into
``logdir`` (TensorBoard's trace layout), where the JAX package captures a
``jax.profiler`` one; a ``None`` logdir is a no-op.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch

_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_durations: dict[str, list[float]] = defaultdict(list)
# Per-call samples kept per span, enough to decompose low-cadence stages
# without unbounded growth on per-batch spans.
_MAX_CALLS_KEPT = 2048
_trace = None  # the running torch.profiler.profile of start_trace


def _annotation(name: str):
    # NVTX exists only in CUDA builds of PyTorch; a CPU build raises on use
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        with _annotation(name):
            yield
    finally:
        # account failed invocations too — a raising stage would otherwise
        # vanish from the report, under-counting exactly what's being
        # debugged
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1
            if len(_durations[name]) < _MAX_CALLS_KEPT:
                _durations[name].append(dt)


def stats() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            k: {"total_s": _totals[k], "count": _counts[k],
                "mean_ms": 1e3 * _totals[k] / max(_counts[k], 1)}
            for k in _totals
        }


def calls(name: str) -> list[float]:
    """Per-call durations for ``name`` (first _MAX_CALLS_KEPT calls)."""
    with _lock:
        return list(_durations.get(name, ()))


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _durations.clear()


def report() -> str:
    lines = ["stage                     total_s   count   mean_ms"]
    for k, v in sorted(stats().items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"{k:<24} {v['total_s']:8.2f} {v['count']:7d} {v['mean_ms']:9.2f}")
    return "\n".join(lines)


def start_trace(logdir: str) -> None:
    global _trace
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    _trace = prof


def stop_trace() -> None:
    global _trace
    prof, _trace = _trace, None
    if prof is None:
        raise RuntimeError("stop_trace without a running trace (start_trace)")
    prof.stop()


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a profiler trace into ``logdir`` (no-op when None)."""
    if logdir is None:
        yield
        return
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
