"""The omni collection kind (``kinds/collect_lm.py``) and its readers on
the CPU, at toy widths: the cell runs and checks, their per-layer metrics read what the
program recorded (and nothing from a program without it), and kernels are
attributed to spans by their launches."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from helpers import REPO, make_root

from portbench import core, span_kernels, work_omni

OMNI_METRICS = ["lm_moe_ms.collect", "lm_attn_ms.collect", "tower_ms.collect",
                "moe_gemm_roofline_pct.collect", "moe_route_roofline_pct.collect",
                "omni_mfu_pct.collect", "experts_per_token.collect",
                "expert_load_max_pct.collect"]


def _root(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cpu_omni", "source": "test",
                             "file": "portbench/configs/cpu_omni.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append(
        {"name": "cpu_omni.collect_lm", "config": "cpu_omni", "traffic": "cpu_collect_lm",
         "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "collect_rtfx":
            m["workloads"].append("cpu_omni.collect_lm")
    for name in OMNI_METRICS:
        bench["per_layer"].append({"name": name, "unit": "x", "better": "higher",
                                   "source": "program_counter", "layer": "test",
                                   "moves": "collect_rtfx",
                                   "workloads": ["cpu_omni.collect_lm"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, cell, seed=5, seconds=0.5):
    code = ("import json; from portbench import core; "
            f"r = core.run_cell({cell!r}, {seed}, {seconds}, True, device='cpu'); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{REPO}"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_portbench_omni_collect_runs_and_checks(tmp_path):
    r, err = _run(_root(tmp_path), "cpu_omni.collect_lm")
    assert r["correct"], (r["checks"], err[-2000:])
    m = r["metrics"]
    assert 1.0 <= m["experts_per_token.collect"]["value"] <= 2.0
    assert 25.0 <= m["expert_load_max_pct.collect"]["value"] <= 100.0
    assert m["omni_mfu_pct.collect"]["value"] > 0
    assert "path_gap (not compared)" in err


@pytest.mark.parametrize("name", OMNI_METRICS)
def test_portbench_new_readers_read_nothing_without_the_program_records(name):
    """A parent without the spans and the counter: no reading, no raise."""
    from portbench.core import Reading, Run, Window

    cfg = json.loads((REPO / "portbench" / "configs" / "uni_moe_omni.json").read_text())
    cell = core.Cell("x", "uni_moe_omni", cfg, "t", {}, {}, [], [])
    run = Run(cell, 1, 1.0, True, "cpu", REPO)
    run.profiled = None
    w = Window({}, 1, 0, {"files": 3, "seconds": 1.0, "batch": 32, "positions": 232,
                          "span_device_s": {}, "profiled_tokens": [], "window_tokens": [],
                          "spans": {}})
    assert core.metric_reader(name, REPO / "portbench").read(Reading(run, w)) is None


def test_portbench_kernels_attributed_to_the_span_holding_their_launch():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "lm.moe", "ts": 100, "dur": 50,
           "pid": 1, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": "lm.attention", "ts": 10, "dur": 50,
           "pid": 1, "tid": 7},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120, "dur": 2,
           "pid": 1, "tid": 7, "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 20, "dur": 2,
           "pid": 1, "tid": 7, "args": {"correlation": 2}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 2,
           "pid": 1, "tid": 7, "args": {"correlation": 3}},
          {"ph": "X", "cat": "kernel", "name": "grouped_kernel", "ts": 300, "dur": 40,
           "pid": 0, "tid": 0, "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "flash", "ts": 200, "dur": 10,
           "pid": 0, "tid": 0, "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "other", "ts": 400, "dur": 7,
           "pid": 0, "tid": 0, "args": {"correlation": 3}}]
    got = span_kernels.span_device_s(ev, ("lm.moe", "lm.attention", "omni.tower"))
    assert got == pytest.approx({"lm.moe": 40e-6, "lm.attention": 10e-6, "omni.tower": 0.0})


def test_portbench_omni_frozen_counts_match_the_program():
    from freud_tpu_torch import flops

    d, width, rows, tokens = 3584, 18944, 10558.0, 7424
    assert work_omni.moe_gemm_flops(rows, d, width) == pytest.approx(
        flops.moe_gateup_bound(rows, d, width, 4).flops
        + flops.moe_down_bound(rows, d, width, 4).flops)
    assert work_omni.moe_route_bytes(tokens, d, 5, 2, rows) == pytest.approx(
        flops.moe_route_bound(tokens, d, 5, 2, rows).bytes)
    cfg = json.loads((REPO / "portbench" / "configs" / "uni_moe_omni.json").read_text())
    per_clip = work_omni.clip_flops(cfg, 232, [232 * 1.4] * 21)
    assert 5e12 < per_clip < 7e12  # ~2.3 TFLOP tower, ~3.6 LM, 0.08 SAE
    assert np.isfinite(per_clip)


def test_portbench_omni_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.omni; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout))  # noqa: S307 — our own subprocess's list
    assert not tops & {"freud_tpu_torch", *core.FORBIDDEN_MODULES}
