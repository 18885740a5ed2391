"""Lightweight tracing/profiling for pipeline stages.

Every hot pipeline stage wraps itself in ``span(name)``, which

* accumulates wall-clock per stage into a process-wide table (``stats``,
  ``report``: the same table and report as ``freud_tpu.profiling``);
* keeps a record of each of the newest ``_MAX_CALLS_KEPT`` calls of each
  name (``records``): its ``id``, the ``parent`` id (the innermost span open
  on the same thread when it began, None at the top), its ``thread``
  (``threading.get_native_id()``, the ``tid`` of a profiler trace), its
  ``start_ns`` on ``time.time_ns()`` and its duration ``dur_s``. The
  chrome trace that ``torch.profiler`` exports counts its ``ts`` (µs) on
  the same clock from the trace's ``baseTimeNanoseconds``, so a record
  lines up with the trace's events;
* opens ``torch.profiler.record_function(name)`` while a profiler is
  running (``start_trace``, or one started on this thread): the span is
  then a ``user_annotation`` on the trace's host timeline, beside the
  device's kernels, and a profiler's idle gap can be named after it. Under
  ``torch.autograd.profiler.emit_nvtx()`` the same ranges are NVTX ranges
  for Nsight. Without a profiler the annotation is skipped (a check of
  ~0.1 µs against ~14 µs for ``record_function`` itself), and a span costs
  a few µs of host time, most of it the context manager's own.

Counters (``count(name, value)``) keep the newest ``_MAX_CALLS_KEPT``
readings of each name beside the spans, in the same record scheme (``id``,
the ``parent`` span open on the thread, ``thread``, ``start_ns``) with the
reading as ``value``: any array-like, a ``DeviceFetch`` whose copy is still
in flight included, which is read only when ``counter_values`` asks (so
recording one adds no synchronisation). ``moe.tokens``, a batch's (layer,
router entry) token counts of Uni-MoE-2.0-Omni, is one; ``longcat.routes``,
a batch's (layer, router entry) slot counts of LongCat-Flash-Omni over all
768 entries (held experts, those other cards hold and identity entries), is
another.

Spans time the host: a span around asynchronous CUDA work measures the
enqueue unless the stage itself waits for the device. These wait:
``d2h_fetch`` (the device-to-host copy), ``train_chunk_wait`` (the chunk
through its synchronisation), ``serve.locked`` (it ends with the answer's
copy to the host) and ``chunk_replay``, whose launch of a many-step graph
blocks until the card has taken much of its work.

``trace(logdir)`` (or ``start_trace``/``stop_trace``) captures a
``torch.profiler`` trace of the host, every thread's spans included, and,
with a card, of CUDA into ``logdir`` (TensorBoard's trace layout), where the
JAX package captures a ``jax.profiler`` one; a ``None`` logdir is a no-op.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Any, Iterator, NamedTuple, Optional

import numpy as np
import torch

# Per-call records kept per span: the newest, enough to decompose a
# measured window without unbounded growth on per-batch spans.
_MAX_CALLS_KEPT = 2048


class Record(NamedTuple):
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    dur_s: float


class CounterRecord(NamedTuple):
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    value: Any


_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_records: dict[str, deque] = defaultdict(lambda: deque(maxlen=_MAX_CALLS_KEPT))
_counters: dict[str, deque] = defaultdict(lambda: deque(maxlen=_MAX_CALLS_KEPT))
_ids = itertools.count(1)  # next() of a count is atomic under the GIL
_local = threading.local()  # .stack: ids of the spans open on this thread
_trace = None  # the running torch.profiler.profile of start_trace


def _thread_stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.thread = threading.get_native_id()
    return stack


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    stack = _thread_stack()
    sid = next(_ids)
    parent = stack[-1] if stack else None
    stack.append(sid)
    start_ns = time.time_ns()
    t0 = time.perf_counter()
    try:
        # a profiler started on another thread reads as off here; start_trace
        # profiles every thread
        if _trace is not None or torch._C._autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        # account failed invocations too — a raising stage would otherwise
        # vanish from the report, under-counting exactly what's being
        # debugged
        dt = time.perf_counter() - t0
        stack.pop()
        rec = Record(sid, parent, _local.thread, start_ns, dt)
        with _lock:
            _totals[name] += dt
            _counts[name] += 1
            _records[name].append(rec)


def stats() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            k: {"total_s": _totals[k], "count": _counts[k],
                "mean_ms": 1e3 * _totals[k] / max(_counts[k], 1)}
            for k in _totals
        }


def records(name: str) -> list[Record]:
    """The newest ``_MAX_CALLS_KEPT`` calls of ``name``, oldest first, by
    when they ended."""
    with _lock:
        return list(_records.get(name, ()))


def count(name: str, value: Any) -> None:
    """Record one reading of counter ``name`` (module docstring)."""
    stack = _thread_stack()
    rec = CounterRecord(next(_ids), stack[-1] if stack else None, _local.thread,
                        time.time_ns(), value)
    with _lock:
        _counters[name].append(rec)


def counter_records(name: str) -> list[CounterRecord]:
    """The newest ``_MAX_CALLS_KEPT`` readings of counter ``name``, oldest
    first."""
    with _lock:
        return list(_counters.get(name, ()))


def counter_values(name: str) -> list[np.ndarray]:
    """The readings of ``counter_records(name)`` as numpy arrays (a reading
    whose device copy is in flight waits for that copy alone)."""
    return [np.asarray(r.value) for r in counter_records(name)]


def calls(name: str) -> list[float]:
    """Per-call durations in seconds of ``records(name)``."""
    return [r.dur_s for r in records(name)]


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _records.clear()
        _counters.clear()


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
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
        # every thread's spans, the server's handlers and the cache's
        # producer included: without it only this thread's are kept
        experimental_config=torch.profiler._ExperimentalConfig(profile_all_threads=True))
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
