"""``correct`` on the CPU's toy cells: sound runs pass, the control (the
reference one precision lower in the program's place) and the program
with a fault planted do not."""

import json
import os
import subprocess
import sys

import pytest
from helpers import REPO, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _control(root, cell, seeds, fault=None):
    cmd = [sys.executable, "portbench/control.py", "--workload", cell, "--device", "cpu",
           "--seconds", "0.3", "--seeds", *map(str, seeds)]
    if fault:
        cmd += ["--fault", fault]
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{REPO}"})
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def _limits(root, cell):
    return json.loads((root / "portbench" / "limits" / f"{cell}.json").read_text())


@pytest.mark.parametrize("cell", ["cpu_tiny.train", "cpu_whisper.collect",
                                  "cpu_whisper.serve"])
def test_portbench_sound_runs_are_correct(root, cell):
    for r in _control(root, cell, [1, 2, 3]):
        assert r["correct"], r


def test_portbench_train_control_is_not_correct(root):
    limits = _limits(root, "cpu_tiny.train")
    for r in _control(root, "cpu_tiny.train", [1, 2, 3]):
        assert set(limits) <= set(r["control"]), r
        assert r["control_correct"] is False, r


@pytest.mark.parametrize("cell,fault", [("cpu_tiny.train", "unchanged"),
                                        ("cpu_tiny.train", "half_batch"),
                                        ("cpu_whisper.collect", "altered_answer"),
                                        ("cpu_whisper.serve", "altered_answer")])
def test_portbench_fault_is_not_correct(root, cell, fault):
    for r in _control(root, cell, [1, 2], fault):
        assert not r["correct"], r
