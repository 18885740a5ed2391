"""The harness on the CPU: cells, mixes and metrics found by name, a cell
and a metric added as files, seeded inputs, frozen counts, the modules a
run loads."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from helpers import PB, REPO, make_root

from portbench import core, data, work

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
WIDTH = re.compile(r"(_dim|_rank|state|head|hidden|intermediate|expansion|^k$)")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_portbench_cell_files_found_by_name(cell):
    c = core.resolve_cell(cell, REPO)
    assert core.kind_module(c.traffic["kind"], PB).setup
    assert c.limits, "a cell's limits file names its compared numbers"
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(core.metric_reader(m["name"], PB).read)


def test_portbench_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def test_portbench_new_cell_and_metric_as_files(tmp_path):
    """A cell (a traffic mix of its own) and a per-layer metric added as
    new files and entries run without an edit to any file already there."""
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    _write(pb / "traffic" / "cpu_train_wide.json",
           {**json.loads((pb / "traffic" / "cpu_train.json").read_text()), "window_files": 6})
    (pb / "metrics" / "steps_in_window.train.py").write_text(
        "def read(r):\n    return r.w.get('steps')\n")
    _write(pb / "limits" / "cpu_tiny.train_wide.json",
           json.loads((pb / "limits" / "cpu_tiny.train.json").read_text()))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cpu_tiny.train_wide", "config": "cpu_tiny",
                               "traffic": "cpu_train_wide", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_steps_per_s":
            m["workloads"].append("cpu_tiny.train_wide")
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "train_steps_per_s",
                               "workloads": ["cpu_tiny.train_wide"]})
    _write(root / "BENCHMARK.json", bench)
    code = ("import json, sys; from portbench import core; "
            "r = core.run_cell('cpu_tiny.train_wide', 3, 0.5, True, device='cpu'); "
            "print(json.dumps(r['metrics']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{REPO}"})
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["steps_in_window.train"]["value"] > 0
    for p, b in before.items():
        assert p.read_bytes() == b, f"{p} was edited"


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_portbench_inputs_deterministic_by_seed(tmp_path, seed):
    p = json.loads((PB / "traffic" / "train_store128_window64.json").read_text())["rows"]

    def rows(s):
        m = data.RowMaker(data.generator("cpu", core.derive_seed(s, "rows")), 3, 5, 8, p, "cpu")
        return m.block(0, 3)

    assert torch.equal(rows(seed), rows(seed))
    assert not torch.equal(rows(seed), rows(seed + 1))
    a = data.wav_corpus(tmp_path / "a", 2, 0.1, core.derive_seed(seed, "clips"))
    b = data.wav_corpus(tmp_path / "b", 2, 0.1, core.derive_seed(seed, "clips"))
    assert [x.read_bytes() for x in a] == [x.read_bytes() for x in b]
    w1 = data.topk_sae_weights(data.generator("cpu", seed), 8, 32, "cpu")
    w2 = data.topk_sae_weights(data.generator("cpu", seed), 8, 32, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


def test_portbench_fingerprint_names_files():
    x = torch.randn(3, 5, 4)
    fp = data.fingerprint(x)
    assert len(set(fp.tolist())) == 3
    assert torch.equal(data.fingerprint(x[[2, 0]]), fp[[2, 0]])
    assert data.fingerprint(x[:, [1, 0, 2, 3, 4]])[0] != fp[0]  # row order counts


def _cells(kind):
    return [w for w in BENCH["workloads"]
            if json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())["kind"] == kind]


@pytest.mark.parametrize("w", _cells("train"), ids=lambda w: w["name"])
def test_portbench_frozen_train_counts(w):
    from freud_tpu_torch import flops

    cfg = json.loads((PB / "configs" / f"{w['config']}.json").read_text())
    d = cfg["whisper"]["n_audio_state"]
    n = d * cfg["sae"]["expansion_factor"]
    rows = cfg["train"]["batch_size"] * cfg["whisper"]["n_audio_ctx"]
    k, k_aux = cfg["sae"]["k"], d // 2
    assert work.topk_sae_forward_bound_s(rows, d, n, k, k_aux) == pytest.approx(
        flops.topk_sae_forward_bound(rows, d, n, k, k_aux).bound_s, rel=1e-12)
    for live in (True, False):
        assert work.sae_topk_step_flops(rows, d, n, live) == flops.sae_topk_step_flops(
            rows, d, n, auxk_live=live)


@pytest.mark.parametrize("w", _cells("collect") + _cells("serve"), ids=lambda w: w["name"])
def test_portbench_frozen_encoder_counts(w):
    """The encoder counted up to the tap: the program's count of a model
    with just the blocks a collection runs."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.audio.filters import mel_filterbank
    from freud_tpu_torch.models.whisper.config import WhisperDims

    cfg = json.loads((PB / "configs" / f"{w['config']}.json").read_text())
    wd, batch = cfg["whisper"], cfg["collect"]["batch_size"]
    blocks = work.tapped_blocks(cfg["layer_name"])
    dims = WhisperDims(**{**wd, "n_audio_layer": blocks})
    assert work.encoder_flops_to_tap(wd["n_mels"], wd["n_audio_state"], wd["n_audio_ctx"],
                                     blocks) == pytest.approx(flops.encoder_flops(dims), rel=1e-12)
    for m in (80, 128):
        assert work.mel_filter_nonzeros(m) == np.count_nonzero(mel_filterbank(m))
    assert work.log_mel_bound_s(batch, wd["n_mels"]) == pytest.approx(
        flops.log_mel_bound(batch, wd["n_mels"]).bound_s, rel=1e-12)
    h = wd["n_audio_head"]
    assert work.whisper_attention_bound_s(batch, h, wd["n_audio_ctx"],
                                          wd["n_audio_state"] // h) == pytest.approx(
        flops.whisper_attention_bound(batch, h, wd["n_audio_ctx"],
                                      wd["n_audio_state"] // h).bound_s, rel=1e-12)


FIXTURE_CELLS = ["cpu_tiny.train", "cpu_whisper.collect", "cpu_whisper.serve"]


@pytest.mark.parametrize("cell", FIXTURE_CELLS)
def test_portbench_run_loads_no_jax(tmp_path, cell):
    """No module a run loads has the top-level name jax, jaxlib, flax or
    freud_tpu (whole names: freud_tpu_torch is the program)."""
    root = make_root(tmp_path)
    code = ("import json, sys; from portbench import core; "
            f"r = core.run_cell({cell!r}, 5, 0.3, True, device='cpu'); "
            "print(json.dumps({'correct': r['correct'], "
            "'tops': sorted({m.split('.')[0] for m in sys.modules})}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{REPO}"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "freud_tpu_torch" in res["tops"]
    assert not set(res["tops"]) & set(core.FORBIDDEN_MODULES)


def test_portbench_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.sae, portbench.reference.whisper, "
            "portbench.reference.judge; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout))  # noqa: S307 — our own subprocess's list
    assert not tops & {"freud_tpu_torch", *core.FORBIDDEN_MODULES}


def test_portbench_run_refuses_without_a_card():
    import torch as t

    if t.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()


def test_portbench_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits nonzero and prints no result."""
    root = tmp_path / "bare"
    root.mkdir()
    import shutil

    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True, text=True,
                         timeout=120, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode != 0 and not out.stdout.strip()
