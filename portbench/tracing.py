"""The traced sub-window: a short steady part of a ``--trace 1`` window run
under ``torch.profiler``, reduced to device intervals.

The profiler's chrome trace gives every kernel, copy and set on the card
(``kernel``, ``gpu_memcpy``, ``gpu_memset``) and the host's operations; the
sub-window is the ``pb.window`` annotation around it. ``busy_s`` is the
union of the device intervals inside the sub-window (overlapping streams
count once), not the sum of kernel times; ``window_s`` is its length. The
profiler slows the host side of what it traces, so time-based metrics come
from the unprofiled rest of the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "pb.window"


@dataclasses.dataclass
class Interval:
    name: str
    base: str
    start_s: float
    dur_s: float

    @property
    def end_s(self) -> float:
        return self.start_s + self.dur_s


@dataclasses.dataclass
class Profile:
    kernels: list          # Interval, device work inside the window
    host: list             # Interval, host operations inside the window
    window_s: float
    busy_s: float
    gaps: list             # (start_s, end_s) device idle inside the window
    units: int = 0         # steps, batches or requests in the window


def base_name(name: str) -> str:
    """"void ns::(anonymous namespace)::name<T>(args)" → "name"."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name) if not name.startswith("Memcpy") else name
    name = name.split("<")[0].split("::")[-1]
    return name.removeprefix("void ").strip()[:80]


def union(intervals: list, lo: float, hi: float) -> tuple[float, list]:
    """(length of the union of ``intervals`` clipped to [lo, hi], the gaps)."""
    spans = sorted((max(i.start_s, lo), min(i.end_s, hi)) for i in intervals)
    busy, gaps, cur = 0.0, [], lo
    for a, b in spans:
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def parse_chrome_trace(path: Path) -> Profile:
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    dev, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        iv = Interval(e.get("name", "?"), base_name(e.get("name", "?")),
                      float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
        if cat in DEVICE_CATS:
            dev.append(iv)
        elif cat == "user_annotation" and iv.name == WINDOW:
            window = iv if window is None or iv.dur_s > window.dur_s else window
        elif cat in HOST_CATS:
            host.append(iv)
    if window is None:
        raise RuntimeError(f"{path}: no {WINDOW} annotation in the trace")
    lo, hi = window.start_s, window.end_s
    inside = [k for k in dev if k.end_s > lo and k.start_s < hi]
    busy, gaps = union(inside, lo, hi)
    host = [h for h in host if h.end_s > lo and h.start_s < hi]
    return Profile(inside, host, hi - lo, busy, gaps)


@contextlib.contextmanager
def profiled(run, units_fn):
    """Profile the block as the run's traced sub-window; ``units_fn()`` →
    the steps, batches or requests the block completed. The block must end
    with the device idle (synchronised)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.stop()
    path = run.tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    p = parse_chrome_trace(path)
    path.unlink()
    p.units = int(units_fn())
    run.profiled = p


def breakdown(p: Profile, top: int = 10, named: int = 200) -> dict:
    """The device operations that took most time in the sub-window, and the
    idle gaps by what the host was doing then (the host operation that
    overlaps the gap most; ties to the shorter, the innermost). The
    ``named`` longest gaps are named; the rest are counted as "shorter
    gaps"."""
    ops: dict[str, float] = {}
    for k in p.kernels:
        ops[k.base] = ops.get(k.base, 0.0) + k.dur_s
    gaps = sorted(p.gaps, key=lambda g: g[0] - g[1])
    idle: dict[str, float] = {}
    rest = sum(b - a for a, b in gaps[named:])
    if rest > 0:
        idle["shorter gaps"] = rest
    for a, b in gaps[:named]:
        best, best_key = None, None
        for h in p.host:
            over = min(b, h.end_s) - max(a, h.start_s)
            if over <= 0:
                continue
            key = (over, -h.dur_s)
            if best_key is None or key > best_key:
                best, best_key = h, key
        name = best.name[:80] if best is not None else "no host operation traced"
        idle[name] = idle.get(name, 0.0) + (b - a)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
