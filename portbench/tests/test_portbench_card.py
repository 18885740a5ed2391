"""On the card (``cuda``): the toy cells' whole runs, their result lines'
shape and ``correct``; and each benchmark cell's control at the cell's own
size, which has to come out not correct."""

import json
import subprocess
import sys

import pytest
from helpers import REPO, make_root

from portbench import core


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cpu_tiny.train", "cpu_whisper.collect",
                                  "cpu_whisper.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_portbench_toy_cell_on_the_card(tmp_path, card, cell, trace):
    root = make_root(tmp_path)
    r = core.run_cell(cell, 11, 0.5, trace, device="cuda", root=root)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
        assert len(r["breakdown"]["device_ops"]) <= 10
    else:
        assert r["metrics"]["setup_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_portbench_control_is_not_correct_at_size(card, cell):
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload", cell,
                          "--seconds", "2", "--seeds", "7"], cwd=REPO, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] and r["control_correct"] is False, r
