"""One run of one cell: find its files by name, set up, measure, check.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
the file ``BENCHMARK.json`` gives) and a traffic mix
(``traffic/<mix>.json``, whose ``kind`` picks the module
``kinds/<kind>.py``). Its output limits are ``limits/<cell>.json``; a
per-layer metric is ``metrics/<metric>.py``, a reader with ``read(r)`` →
a number or None. Nothing here names a cell, a configuration or a metric:
a later change adds them as files and entries.

A kind's module has four functions, called in this order:

* ``setup(run)`` → state: inputs and weights from the seed, the program's
  objects built, every shape the window uses warmed up, the first steps
  the check follows taken;
* ``window(run, state)`` → a ``Window``: the measured work, for
  ``run.seconds``; under ``--trace 1`` a short steady part of it runs under
  the profiler (``run.profiled``);
* ``finish(run, state)`` → pending: after the window has closed and the
  peak memory has been read, whatever the check reads from the program;
  then the program's state is freed;
* ``check(run, pending)`` → ``{name: value}``: the plain reference's
  comparisons, each held to its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

PB_DIR = Path(__file__).resolve().parent
ROOT = PB_DIR.parent
# top-level module names no run may load (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "freud_tpu")


def derive_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed for one use (``tags``) of the run's ``--seed``."""
    import numpy as np

    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for t in tags:
        words.extend(t.encode())
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def resolve_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    pb = root / bench["paths"][0]
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(pb / "traffic" / f"{w['traffic']}.json")
    limits = load_json(pb / "limits" / f"{name}.json")

    def applies(m: dict) -> bool:
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and m["moves"] in reported]
    return Cell(name, w["config"], config, w["traffic"], traffic, limits, e2e, per_layer)


@dataclasses.dataclass
class Window:
    """What a window measured: ``values`` holds every end-to-end metric the
    module can give (the cell reports those ``BENCHMARK.json`` lists for
    it); ``attempted`` and ``failed`` count its steps, files or requests;
    ``reading`` is what the per-layer readers read besides the profile."""
    values: dict
    attempted: int
    failed: int
    reading: dict = dataclasses.field(default_factory=dict)


class Run:
    """One run's context, handed to the kind's module and the readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, tmp: Path, control: bool = False):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.tmp = tmp
        self.control = control
        self.t_start = time.time()
        self.profiled = None        # tracing.Profile of the traced sub-window
        self.memory_peak_bytes = 0
        self.notes: dict = {}       # printed on stderr before the result

    def seed_for(self, *tags: str) -> int:
        return derive_seed(self.seed, *tags)

    def log(self, msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    def stage(self, name: str) -> None:
        """Log a set-up stage's end, in seconds from the run's start."""
        self.log(f"set-up stage {name} done at {time.time() - self.t_start:.3f} s")


def kind_module(kind: str, pb_dir: Path):
    """``kinds/<kind>.py`` of the benchmark folder at ``pb_dir``."""
    return _load_module(pb_dir / "kinds" / f"{kind}.py", f"portbench.kinds.{kind}")


def metric_reader(name: str, pb_dir: Path):
    return _load_module(pb_dir / "metrics" / f"{name}.py", f"portbench.metrics.{name}")


def _load_module(path: Path, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise SystemExit(f"missing benchmark file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is at
    or under it (a missing or non-finite number fails)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    for name in values:
        if name not in limits:
            raise RuntimeError(f"compared number {name!r} has no limit")
    return ok, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, t_start: Optional[float] = None,
             control: bool = False) -> dict:
    """Run cell ``name`` once; → the result line's object. ``device`` is
    ``cuda`` for the benchmark; tests pass ``cpu`` with tiny configurations.
    ``control`` also computes the control's readings (``control.py``)."""
    t_start = time.time() if t_start is None else t_start
    cell = resolve_cell(name, root)
    pb_dir = root / "portbench"
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=base))
    run = Run(cell, seed, seconds, trace, device, tmp, control=control)
    run.t_start = t_start
    kind = kind_module(cell.traffic["kind"], pb_dir)
    try:
        state = kind.setup(run)
        setup_s = time.time() - t_start
        run.log(f"set-up {setup_s:.3f} s")
        win = kind.window(run, state)
        win.values["setup_s"] = setup_s
        run.log(f"window: {win.attempted} attempted, {win.failed} failed; "
                + ", ".join(f"{k} {v:.6g}" for k, v in win.values.items()))
        check_imports()
        run.memory_peak_bytes = _memory_peak(device)
        pending = kind.finish(run, state)
        del state
        t_check = time.time()
        values = kind.check(run, pending)
        run.log(f"check {time.time() - t_check:.3f} s")
        # the reference and the comparisons may load nothing forbidden either
        check_imports()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, checks = judge(values, cell.limits)
    correct = correct and win.failed == 0
    result = {
        "correct": correct,
        "attempted": int(win.attempted),
        "failed": int(win.failed),
        "metrics": {},
        "device": device_record(run, device),
    }
    if trace:
        from . import tracing

        reading = Reading(run, win)
        for m in cell.per_layer:
            v = metric_reader(m["name"], pb_dir).read(reading)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        if run.profiled is not None:
            result["device"]["busy_s"] = run.profiled.busy_s
            result["device"]["window_s"] = run.profiled.window_s
            result["breakdown"] = tracing.breakdown(run.profiled)
    else:
        for m in cell.end_to_end:
            if m["name"] in win.values:
                result["metrics"][m["name"]] = {"value": float(win.values[m["name"]]),
                                                "unit": m["unit"]}
    if control:
        result["control"] = run.notes.get("control")
    result["checks"] = checks
    for k, v in run.notes.items():
        if k != "control":
            run.log(f"{k}: {v}")
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, names: list[str]):
        super().__init__(f"the run loaded {', '.join(names)} (no JAX and no "
                         "freud_tpu may load in a benchmark run)")


def check_imports() -> None:
    """Raise ``ForbiddenImport`` if a forbidden module is loaded."""
    bad = forbidden_loaded()
    if bad:
        raise ForbiddenImport(bad)


def _memory_peak(device: str) -> int:
    if not str(device).startswith("cuda"):
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def device_record(run: Run, device: str) -> dict:
    if not str(device).startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": run.memory_peak_bytes}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": run.memory_peak_bytes}


class Reading:
    """What a per-layer reader reads: the run (configuration, traffic), the
    window's own numbers (``w``), and the profiled sub-window
    (``profile``, None without one)."""

    def __init__(self, run: Run, win: Window):
        self.run = run
        self.config = run.config
        self.traffic = run.traffic
        self.w = win.reading
        self.profile = run.profiled

    def kernel_ms_per_unit(self, keep) -> Optional[float]:
        """Device ms a unit (step, batch, request) of the profiled kernels
        for which ``keep(kernel)`` holds (a ``tracing.Interval``: ``name``,
        ``base``); None without a profile or when none ran."""
        p = self.profile
        if p is None or not p.units:
            return None
        total = sum(k.dur_s for k in p.kernels if keep(k))
        if total <= 0:
            return None
        return 1e3 * total / p.units

    def idle_pct(self) -> Optional[float]:
        p = self.profile
        if p is None or p.window_s <= 0 or p.busy_s <= 0:
            return None
        return 100.0 * (1.0 - p.busy_s / p.window_s)

    @staticmethod
    def median_ms(samples) -> Optional[float]:
        samples = list(samples or ())
        return 1e3 * statistics.median(samples) if samples else None
