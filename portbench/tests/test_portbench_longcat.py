"""The LongCat collection kind (``kinds/collect_longcat.py``) and its readers
on the CPU, at toy widths: the cell runs and checks, its per-layer metrics
read what the program recorded (and nothing from a program without it),
its frozen counts match the program's, and the reference and the control
load nothing of the program."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from helpers import REPO, make_root

from portbench import core, longcat_data, work_longcat

LC_METRICS = ["lc_mla_ms.collect", "lc_dense_ms.collect", "lc_route_roofline_pct.collect",
              "lc_moe_gemm_roofline_pct.collect", "lc_mfu_pct.collect",
              "lc_ffn_experts_per_token.collect", "lc_held_rows_per_expert.collect"]
# metrics of the Uni-MoE cell whose spans the LongCat model opens too
SHARED_METRICS = ["lm_moe_ms.collect", "tower_ms.collect"]
CELL = "cpu_longcat.collect_longcat"


def _root(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cpu_longcat", "source": "test",
                             "file": "portbench/configs/cpu_longcat.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "cpu_longcat",
                               "traffic": "cpu_collect_longcat", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "collect_rtfx":
            m["workloads"].append(CELL)
    for name in LC_METRICS + SHARED_METRICS:
        bench["per_layer"].append({"name": name, "unit": "x", "better": "higher",
                                   "source": "program_counter", "layer": "test",
                                   "moves": "collect_rtfx", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, seed=5, seconds=0.5, trace=True, control=False):
    code = ("import json; from portbench import core; "
            f"r = core.run_cell({CELL!r}, {seed}, {seconds}, {trace}, device='cpu', "
            f"control={control}); print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=900,
                         env={**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{REPO}"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_portbench_longcat_collect_runs_and_checks(tmp_path):
    r, err = _run(_root(tmp_path), control=True)
    assert r["correct"], (r["checks"], err[-3000:])
    m = r["metrics"]
    # 6 slots a token, 16 routed experts of 24 entries: 4 FFN experts a token
    assert 3.0 <= m["lc_ffn_experts_per_token.collect"]["value"] <= 5.0
    assert m["lc_held_rows_per_expert.collect"]["value"] > 0
    assert m["lc_mfu_pct.collect"]["value"] > 0
    assert "path_gap (not compared)" in err and "the largest margin" in err
    assert r["control"]["layer_out_gap"] > r["checks"]["layer_out_gap"]["value"]


@pytest.mark.parametrize("name", LC_METRICS + SHARED_METRICS)
def test_portbench_longcat_readers_read_nothing_without_the_program_records(name):
    """A parent without the model's spans, kernels and counter: no reading,
    no raise."""
    from portbench.core import Reading, Run, Window

    cfg = json.loads((REPO / "portbench" / "configs" / "longcat_flash_omni.json").read_text())
    cell = core.Cell("x", "longcat_flash_omni", cfg, "t", {}, {}, [], [])
    run = Run(cell, 1, 1.0, True, "cpu", REPO)
    run.profiled = None
    w = Window({}, 1, 0, {"files": 3, "seconds": 1.0, "batch": 32, "positions": 407,
                          "span_device_s": {}, "profiled_tokens": [], "window_tokens": [],
                          "spans": {}})
    assert core.metric_reader(name, REPO / "portbench").read(Reading(run, w)) is None


def test_portbench_longcat_frozen_counts_match_the_program():
    from freud_tpu_torch import flops

    d, width, rows, tokens = 6144, 2048, 3256.0, 13024
    want = sum(b.bound_s for b in flops.moe_held_bounds(rows, 16, d, width))
    assert work_longcat.held_gemm_bound_s(rows, 16, d, width) == pytest.approx(want)
    assert work_longcat.route_topk_bytes(tokens, 768, 12) == pytest.approx(
        flops.moe_route_topk_bound(tokens, 768, 12).bytes)
    cfg = json.loads((REPO / "portbench" / "configs" / "longcat_flash_omni.json").read_text())
    per_clip = work_longcat.clip_flops(cfg, 407, [407 * 8 / 32] * 16)
    # ~2.3 TFLOP tower, ~8.5 LM (16 layers of ~0.53: dense FFNs ~0.37), ~0.45 SAE
    assert 10e12 < per_clip < 13e12 and np.isfinite(per_clip)


def test_portbench_longcat_bias_balances_the_load():
    import torch

    cfg = json.loads((REPO / "portbench" / "configs" / "longcat_flash_omni.json").read_text())
    g = torch.Generator().manual_seed(0)
    p = torch.softmax(torch.randn(1024, 768, generator=g) * 2.25
                      + torch.randn(768, generator=g) * 0.5, -1)
    b = longcat_data.balance_bias(p, cfg)
    assert longcat_data.ffn_experts_per_token(p, b, cfg) == pytest.approx(8.0, abs=0.1)


def test_portbench_longcat_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.longcat, portbench.longcat_data, "
            "portbench.work_longcat; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout))  # noqa: S307 — our own subprocess's list
    assert not tops & {"freud_tpu_torch", *core.FORBIDDEN_MODULES}
