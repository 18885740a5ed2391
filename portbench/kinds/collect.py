"""Collection traffic: SAE-attached activation collection, the loop of
``scripts/collect_activations.py::get_activations``.

``get_activations`` builds its model inside and walks a folder once, so
the benchmark composes the same public pieces it composes: the fly loader
(``FlyActivationLoader``: decode and pinned upload on a prefetch thread,
kernel #1, the encoder to the tap, the SAE encode, asynchronous device to
host copies, one batch ahead), the ``d2h_fetch`` wait, and the write-behind
``ActivationStoreWriter`` on its own thread under the ``store_append`` span.
The model and the SAE are built in set-up, from checkpoints the benchmark
wrote from ``--seed`` (OpenAI's layout, found through
``FREUD_WHISPER_DIR``; a FREUD trainer checkpoint).

The corpus is ``clips`` seeded WAVs, listed many times over under other
names (symbolic links), so the loader walks one long folder with no pass
boundary. Set-up runs the first batches (every shape warmed up), and the
window continues the same iterator. A batch counts when its rows are in the
store; the rate is the real (unpadded) audio seconds stored over the
window's seconds.

The check: a sample of the files stored in the window, drawn from the
seed, read back from the store's files, against the reference's encoder and
SAE on the same WAV and weights (``reference.judge.topk_gap``).
"""

from __future__ import annotations

import gc
import os
import queue
import threading
import time

import numpy as np
import torch

from portbench import data, tracing
from portbench.reference import judge, pin_f32
from portbench.reference import whisper as ref_whisper


def setup(run) -> dict:
    cfg, tr = run.config, run.traffic
    dev = torch.device(run.device)
    clips = data.wav_corpus(run.tmp / "clips", tr["clips"], tr["clip_seconds"],
                            run.seed_for("clips"))
    corpus = run.tmp / "corpus"
    data.linked_corpus(corpus, clips, tr["corpus_entries"])
    run.stage("corpus written")
    inputs = data.model_inputs(run, dev)
    os.environ["FREUD_WHISPER_DIR"] = str(inputs["whisper_dir"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    run.stage("checkpoints written")
    from freud_tpu_torch import profiling
    from freud_tpu_torch.data.loaders import FlyActivationLoader
    from freud_tpu_torch.data.store import ActivationStoreWriter

    c = cfg["collect"]
    loader = FlyActivationLoader(
        data_path=str(corpus), whisper_model=cfg["model"],
        sae_checkpoint=str(inputs["sae_path"]), layer_name=cfg["layer_name"],
        batch_size=c["batch_size"],
        compute_dtype=torch.bfloat16 if c["precision"] == "bfloat16" else torch.float32,
        device=dev)
    st = {"dev": dev, "loader": loader, "inputs": inputs, "clips": clips,
          "out": run.tmp / "store", "profiling": profiling,
          "writer_cls": ActivationStoreWriter, "names": [], "window_files": []}
    run.stage("loader built (model and SAE loaded)")
    st["it"] = loader.iter_with_lengths()
    st["writer"] = None
    st["q"] = queue.Queue(maxsize=2)
    st["err"] = []
    for _ in range(tr["warm_batches"]):
        _next_batch(run, st)
    _drain(st)
    return st


def _writer_loop(st) -> None:
    q, profiling = st["q"], st["profiling"]
    while True:
        item = q.get()
        try:
            if item is None:
                return
            with profiling.span("store_append"):
                st["writer"].append_batch(item[0], *item[1], n_frames=item[2])
        except BaseException as e:  # noqa: BLE001 — surfaced on the main thread
            st["err"].append(e)
            return
        finally:
            q.task_done()


def _next_batch(run, st) -> tuple[int, float]:
    """One batch through the loop: fetch (``d2h_fetch``), hand to the writer.
    → (files, real audio seconds)."""
    *arrays, names, n_frames = next(st["it"])
    with st["profiling"].span("d2h_fetch"):
        arrays = [np.asarray(a) for a in arrays]
    if st["writer"] is None:
        loader = st["loader"]
        st["writer"] = st["writer_cls"](
            st["out"], run.config["layer_name"], tensor_shape=arrays[0].shape[1:],
            activation_shape=loader.activation_shape, indexed=True, overwrite=True,
            store_dtype=np.dtype(run.config["collect"]["store_dtype"]))
        st["thread"] = threading.Thread(target=_writer_loop, args=(st,), daemon=True)
        st["thread"].start()
    if st["err"]:
        raise st["err"][0]
    st["q"].put((names, arrays, n_frames))
    st["names"].extend(names)
    return len(names), float(np.sum(n_frames)) * 0.02


def _drain(st) -> None:
    st["q"].join()
    if st["err"]:
        raise st["err"][0]


def window(run, st):
    from portbench.core import Window

    profiling = st["profiling"]
    batch = run.config["collect"]["batch_size"]
    if run.trace:
        n_prof = run.traffic["profiled_batches"]
        with tracing.profiled(run, lambda: n_prof):
            for _ in range(n_prof):
                _next_batch(run, st)
            _drain(st)
    profiling.reset()
    first = len(st["names"])
    t0 = time.perf_counter()
    files, audio_s = 0, 0.0
    while True:
        n, s = _next_batch(run, st)
        files += n
        audio_s += s
        if time.perf_counter() - t0 >= run.seconds:
            break
    _drain(st)
    elapsed = time.perf_counter() - t0
    st["window_files"] = list(range(first, first + files))
    spans = {k: profiling.calls(k) for k in ("decode_batch", "store_append", "d2h_fetch")}
    reading = {"files": files, "seconds": elapsed, "batch": batch, "spans": spans}
    return Window({"collect_rtfx": audio_s / elapsed}, files, 0, reading)


def finish(run, st) -> dict:
    st["it"].close()
    st["q"].put(None)
    st["thread"].join()
    st["writer"].close()
    if st["err"]:
        raise st["err"][0]
    rng = np.random.default_rng(run.seed_for("sample"))
    n = min(run.traffic["checked_files"], len(st["window_files"]))
    rows = np.sort(rng.choice(st["window_files"], n, replace=False))
    pending = {"dev": st["dev"], "inputs": st["inputs"], "rows": rows,
               "names": [st["names"][i] for i in rows], "out": st["out"]}
    st.clear()
    gc.collect()
    if pending["dev"].type == "cuda":
        torch.cuda.empty_cache()
    return pending


def _stored(run, pending) -> tuple[torch.Tensor, torch.Tensor]:
    """The sampled files' (values, indices) as the store holds them on disk."""
    layer = run.config["layer_name"]
    vals = np.load(pending["out"] / f"{layer}_activation_values.npy", mmap_mode="r")
    idx = np.load(pending["out"] / f"{layer}_feature_indices.npy", mmap_mode="r")
    k = run.config["sae"]["k"]
    r = pending["rows"]
    return (torch.from_numpy(np.asarray(vals[r])).reshape(len(r), -1, k),
            torch.from_numpy(np.asarray(idx[r])).reshape(len(r), -1, k))


def reference_latents(run, pending, names, tf32: bool = False) -> torch.Tensor:
    """(files, frames, n_dict) latents of the reference for the named
    files (``tf32``: the control's products in TF32)."""
    dev = pending["dev"]
    wd = run.config["whisper"]
    sd = {k: v.to(dev) for k, v in pending["inputs"]["whisper"].items()}
    sae = {k: v.to(dev) for k, v in pending["inputs"]["sae"].items()}
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        out = []
        block = ref_whisper.tap_block(run.config["layer_name"])
        for name in names:
            audio = data.read_wav(os.path.realpath(name))
            mel = ref_whisper.log_mel(audio, wd["n_mels"], dev)[None]
            x = ref_whisper.encoder_to_block(sd, wd, mel, block)[0]
            out.append(ref_whisper.sae_latents(sae, x))
        return torch.stack(out)
    finally:
        pin_f32()


def check(run, pending) -> dict:
    pin_f32()
    k = run.config["sae"]["k"]
    vals, idx = _stored(run, pending)
    gaps, control = [], []
    for i, name in enumerate(pending["names"]):
        ref = reference_latents(run, pending, [name])[0]
        gaps.append(judge.topk_gap(vals[i].to(ref.device), idx[i].to(ref.device), ref, k))
        if run.control:
            low = reference_latents(run, pending, [name], tf32=True)[0]
            top = torch.topk(low, k, dim=-1)
            control.append(judge.topk_gap(top.values, top.indices, ref, k))
    if run.control:
        run.notes["control"] = {"topk_gap": max(control)}
    return {"topk_gap": max(gaps)}
