"""Serving traffic: ``POST /top_features`` to the port's GUI server.

Set-up writes the model's and the SAE's checkpoints and seeded upload WAVs,
builds the server's state (``GuiState`` in fly mode: the Whisper runtime
and the SAE on the card), starts ``create_server`` on a free local port in
a thread of this process, and starts the client (``serve_client.py``) in a
process of its own, so that the two do not share an interpreter lock. The
client sends one request at a time and waits for each answer: one
researcher clicking, against a server that holds one device lock. Set-up
ends with warm-up requests; the window is every request sent in
``--seconds``, the uploads in turn. ``request_p95_ms`` is the 95th
percentile of all of them, timed at the client; a failed request counts
as missing it (infinitely late).

The check: a sample of the window's answers, drawn from the seed, against
the reference's log-mel, encoder and SAE on the same upload and weights:
the root mean square of every error of every sampled answer
(``reference.judge.top_features_errors``). The widest single error does
not separate the program from its control by the factor a limit needs
(2.98 ×, PERF.md §2).
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from portbench import data, tracing
from portbench.reference import judge, pin_f32
from portbench.reference import whisper as ref_whisper

CLIENT = Path(__file__).with_name("serve_client.py")


def _ask(st, line: str) -> dict:
    st["client"].stdin.write(line + "\n")
    st["client"].stdin.flush()
    out = st["client"].stdout.readline()
    if not out:
        raise RuntimeError(f"the serving client ended ({st['client'].poll()})")
    return json.loads(out)


def setup(run) -> dict:
    cfg, tr = run.config, run.traffic
    dev = torch.device(run.device)
    uploads = data.wav_corpus(run.tmp / "uploads", tr["uploads"], tr["clip_seconds"],
                              run.seed_for("uploads"))
    inputs = data.model_inputs(run, dev)
    os.environ["FREUD_WHISPER_DIR"] = str(inputs["whisper_dir"])
    run.stage("uploads and checkpoints written")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    from freud_tpu_torch.server.app import GuiState, create_server

    state = GuiState({"layer_name": cfg["layer_name"], "whisper_model": cfg["model"],
                      "sae_model": str(inputs["sae_path"]),
                      "data_path": str(run.tmp / "uploads"), "batch_size": 1,
                      "device": run.device})
    run.stage("server state built (model and SAE loaded)")
    server = create_server(state, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    client = subprocess.Popen(
        [sys.executable, str(CLIENT), str(port), str(tr["top_n"]), *map(str, uploads)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env={"PATH": os.environ.get("PATH", ""), "PYTHONHASHSEED": "0"})
    order = np.random.default_rng(run.seed_for("order")).permutation(len(uploads))
    st = {"dev": dev, "server": server, "thread": thread, "client": client,
          "inputs": inputs, "uploads": uploads, "state": state, "sent": 0,
          "first": int(order[0]), "window": []}
    warm = _ask(st, f"run {tr['warm_requests']} 0 {st['first']}")
    st["sent"] += len(warm["requests"])
    if any(r[2] != 200 for r in warm["requests"]):
        raise RuntimeError(f"warm-up requests failed: {warm['requests']}")
    return st


def _run(st, n: int, seconds: float) -> list:
    out = _ask(st, f"run {n} {seconds} {st['first'] + st['sent']}")
    reqs = out["requests"]
    base = st["sent"]
    st["sent"] += len(reqs)
    return [(base + i, *r) for i, r in enumerate(reqs)]


def window(run, st):
    from portbench.core import Window

    if run.trace:
        n_prof = run.traffic["profiled_requests"]
        with tracing.profiled(run, lambda: n_prof):
            _run(st, n_prof, 0)
    reqs = _run(st, 0, run.seconds)
    st["window"] = reqs
    lat = [r[2] if r[3] == 200 else math.inf for r in reqs]
    failed = sum(1 for r in reqs if r[3] != 200)
    values = {}
    if lat:
        values["request_p95_ms"] = 1e3 * float(np.quantile(np.asarray(lat), 0.95,
                                                           method="higher"))
    reading = {"latencies_s": [r[2] for r in reqs if r[3] == 200]}
    if reading["latencies_s"]:
        q = np.quantile(reading["latencies_s"], [0.5, 0.9, 0.95, 0.99, 1.0])
        run.log("request ms p50 p90 p95 p99 max: "
                + " ".join(f"{1e3 * v:.2f}" for v in q) + f" (n {len(reqs)})")
    return Window(values, len(reqs), failed, reading)


def finish(run, st) -> dict:
    ok = [r for r in st["window"] if r[3] == 200]
    rng = np.random.default_rng(run.seed_for("sample"))
    n = min(run.traffic["checked_requests"], len(ok))
    picked = [ok[i] for i in sorted(rng.choice(len(ok), n, replace=False))]
    bodies = _ask(st, "bodies " + " ".join(str(r[0]) for r in picked))["bodies"]
    _ask_quit(st)
    st["server"].shutdown()
    st["server"].server_close()
    st["thread"].join(timeout=30)
    pending = {"dev": st["dev"], "inputs": st["inputs"],
               "answers": [(st["uploads"][r[1]], json.loads(bodies[str(r[0])]))
                           for r in picked]}
    st.clear()
    gc.collect()
    if pending["dev"].type == "cuda":
        torch.cuda.empty_cache()
    return pending


def _ask_quit(st) -> None:
    client = st["client"]
    client.stdin.write("quit\n")
    client.stdin.flush()
    client.stdin.close()
    client.wait(timeout=30)
    client.stdout.close()


def _latents(run, pending, path, tf32: bool = False) -> torch.Tensor:
    dev = pending["dev"]
    wd = run.config["whisper"]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        sd = {k: v.to(dev) for k, v in pending["inputs"]["whisper"].items()}
        sae = {k: v.to(dev) for k, v in pending["inputs"]["sae"].items()}
        audio = data.read_wav(path)
        mel = ref_whisper.log_mel(audio, wd["n_mels"], dev)[None]
        x = ref_whisper.encoder_to_block(sd, wd, mel,
                                         ref_whisper.tap_block(run.config["layer_name"]))[0]
        frames = min(int(len(audio) / 16000 / 0.02), x.shape[0])
        return ref_whisper.sae_latents(sae, x[:frames])
    finally:
        pin_f32()


def check(run, pending) -> dict:
    pin_f32()
    k, top_n = run.config["sae"]["k"], run.traffic["top_n"]
    errors, control = [], []
    for path, body in pending["answers"]:
        ref = _latents(run, pending, path)
        errors.append(judge.top_features_errors(body.get("top_indices"),
                                                body.get("top_activations"), ref, k, top_n))
        if run.control:
            low = _latents(run, pending, path, tf32=True)
            kth = torch.topk(low, k, dim=-1).values[:, -1:]
            dense = torch.where(low >= kth, low, torch.zeros_like(low))
            idx = torch.sort(dense.amax(dim=0), descending=True, stable=True).indices[:top_n]
            control.append(judge.top_features_errors(idx.tolist(), dense[:, idx].T.tolist(),
                                                     ref, k, top_n))
    if run.control:
        run.notes["control"] = {"answer_rms": judge.answers_rms(control),
                                "answer_max": max(float(e.max()) for e in control)}
        run.notes["program_answer_max"] = max(float(e.max()) for e in errors
                                              if e is not None)
    return {"answer_rms": judge.answers_rms(errors)}
