"""Device time of the kernels launched inside the program's spans.

``profiled_spans`` runs a block as the run's traced sub-window, as
``tracing.profiled`` does (the same ``pb.window`` annotation, the same
``Profile`` in ``run.profiled``), and also keeps, for each named span, the
device seconds of the kernels whose launch lies inside one of the span's
calls. The program's spans are ``user_annotation`` events on the trace's
host timeline while a profiler runs (``freud_tpu_torch/profiling.py``); a
kernel's launch (its ``cuda_runtime`` or ``cuda_driver`` event) and the
kernel share a ``correlation`` id. Against a program without the spans
every span reads 0 seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from pathlib import Path

from portbench import tracing

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span_device_s(events: list, spans) -> dict:
    """{span: device seconds of the kernels launched inside its calls}."""
    calls = {s: {} for s in spans}   # span → (pid, tid) → sorted [(start, end)]
    launches, kernels = {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name") in calls:
            key = (e.get("pid"), e.get("tid"))
            calls[e["name"]].setdefault(key, []).append((float(e["ts"]),
                                                         float(e["ts"]) + float(e["dur"])))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), (e.get("pid"), e.get("tid")))
        elif cat == "kernel" and "correlation" in e.get("args", {}):
            kernels.append((e["args"]["correlation"], float(e["dur"])))
    for per in calls.values():
        for iv in per.values():
            iv.sort()
    out = {s: 0.0 for s in spans}
    for corr, dur in kernels:
        if corr not in launches:
            continue
        ts, key = launches[corr]
        for s, per in calls.items():
            iv = per.get(key)
            if not iv:
                continue
            i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                out[s] += dur * 1e-6
                break
    return out


@contextlib.contextmanager
def profiled_spans(run, units_fn, spans, result: dict):
    """``tracing.profiled``, and ``result`` filled with
    ``span_device_s`` of the sub-window's trace for ``spans``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function(tracing.WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.stop()
    path = Path(run.tmp) / "trace_spans.json"
    prof.export_chrome_trace(str(path))
    p = tracing.parse_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    path.unlink()
    p.units = int(units_fn())
    run.profiled = p
    result.update(span_device_s(events, spans))
