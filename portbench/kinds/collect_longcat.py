"""Collection traffic at LongCat-Flash-Omni's language model: SAE-attached
activation collection at ``lm.layers.N`` on one card of an expert-parallel
deployment, the loop of ``scripts/collect_activations.py::get_activations``
composed from the same public pieces as ``kinds/collect.py`` and
``kinds/collect_lm.py`` (the fly loader, the ``d2h_fetch`` wait, the
write-behind ``ActivationStoreWriter``).

Set-up writes the clips, calibrates each layer's router and selection bias
on the first ``calibration_clips`` of them with the reference
(``longcat_data.py``), draws the model's bf16 state dict, the card's share
of the routed experts, on the card from ``--seed`` and hands it to the fly
loader (``model_weights``), the entry the checkpoint reader feeds. The audio
prompt's ids are drawn from the seed too. A batch counts once its rows are
in the store; the rate is the real audio seconds stored over the window's
seconds.

The check, after the window, of ``checked_files`` files drawn from those
the window stored. The program captures, through its own capture path, its
inputs to each double layer, each layer's output, MoE input, router
probabilities and routes for those files (one batch, padded to the
window's shape). Then, layer by layer, the reference draws the layer's
weights from the same seed rule (the same share of the experts) and applies
the layer to the program's own inputs, and once more to its own
straight-through stream from the WAVs:

* ``router_gap``: the largest gap between the program's router
  probabilities and the reference's f32 router applied to the program's
  own MoE input, over the row's largest probability (both f32: only the
  product's rounding shows);
* ``route_flip_margin``: among the (token, layer) routes of every checked
  layer whose selected set differs from the reference's, the 99th
  percentile (``FLIP_QUANTILE``) of the reference's margin at the top-k
  boundary over the spread of the biased scores (``reference/longcat.py::
  route``); 0 with no flip. A percentile and not the largest: bf16 flips
  ~13% of routes near a decision, and the largest of ~14,000 such margins
  wanders from run to run by 2.4x;
* ``layer_out_gap``: the worst layer's RMS gap of the program's output to
  the reference's over the tokens routed alike, relative to the RMS of the
  layer's own update (output less input);
* ``topk_gap``: the stored top-k of the checked files against the
  reference SAE on the program's own tap activations (``judge.topk_gap``).

Shown, not compared (``run.notes``): the flips' count and share, their
largest margin, and ``path_gap``, the program's tap against the reference straight through.
The control (``control_longcat.py``) is the reference with float8 e4m3
products in the program's place.
"""

from __future__ import annotations

import gc
import os
import queue
import time

import numpy as np
import torch

from portbench import data, longcat_data, omni_data, span_kernels
from portbench.kinds import collect as collect_kind
from portbench.kinds import collect_lm
from portbench.reference import judge, pin_f32
from portbench.reference import longcat as ref_longcat
from portbench.reference import whisper as ref_whisper

SPANS = ("omni.tower", "lm.mla", "lm.dense", "lm.moe")
FLIP_QUANTILE = 0.99
COUNTER = "longcat.routes"


def _counter_values(profiling) -> list:
    get = getattr(profiling, "counter_values", None)
    return [] if get is None else get(COUNTER)


def setup(run) -> dict:
    # a program without the model fails here, before any work
    import freud_tpu_torch.models.longcat  # noqa: F401
    from freud_tpu_torch import profiling
    from freud_tpu_torch.data.loaders import FlyActivationLoader
    from freud_tpu_torch.data.store import ActivationStoreWriter

    cfg, tr = run.config, run.traffic
    dev = torch.device(run.device)
    clips = data.wav_corpus(run.tmp / "clips", tr["clips"], tr["clip_seconds"],
                            run.seed_for("clips"))
    corpus = run.tmp / "corpus"
    data.linked_corpus(corpus, clips, tr["corpus_entries"])
    run.stage("corpus written")
    hf = omni_data.hf_config(cfg, omni_data.prompt_ids(
        run.seed_for("prompt"), cfg["vocab_size"], tr["prompt_before"], tr["prompt_after"]))
    pool = cfg["audio_seconds"] * 50 // cfg["audio_tokens"]
    pin_f32()
    with torch.no_grad():
        calib = _reference_input(run, hf, clips[:tr["calibration_clips"]], dev, pool)
        routers = longcat_data.calibrated_routers(run.seed_for, hf, calib)
    del calib
    run.stage("routers calibrated")
    d = cfg["hidden_size"]
    sae = data.topk_sae_weights(data.generator(dev, run.seed_for("sae")), d,
                                d * cfg["sae"]["expansion_factor"], dev)
    sae_path = data.write_sae_checkpoint(run.tmp / "sae.pth", sae, cfg["sae"], d)
    sae = {k: v.cpu() for k, v in sae.items()}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sd = longcat_data.state_dict(run.seed_for, hf, dev, routers)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    run.stage("weights drawn, SAE checkpoint written")
    c = cfg["collect"]
    loader = FlyActivationLoader(
        data_path=str(corpus), whisper_model=cfg["model"], sae_checkpoint=str(sae_path),
        layer_name=cfg["layer_name"], batch_size=c["batch_size"],
        compute_dtype=torch.bfloat16 if c["precision"] == "bfloat16" else torch.float32,
        device=dev, model_weights=(hf, sd))
    del sd
    st = {"dev": dev, "loader": loader, "hf": hf, "sae": sae, "routers": routers,
          "out": run.tmp / "store", "profiling": profiling,
          "writer_cls": ActivationStoreWriter, "names": [], "window_files": [], "pool": pool}
    run.stage("loader built (model and SAE loaded)")
    st["it"] = loader.iter_with_lengths()
    st["writer"] = None
    st["q"] = queue.Queue(maxsize=2)
    st["err"] = []
    for _ in range(tr["warm_batches"]):
        collect_lm._next_batch(run, st)
    collect_kind._drain(st)
    return st


def window(run, st):
    from portbench.core import Window

    profiling = st["profiling"]
    batch = run.config["collect"]["batch_size"]
    span_s, profiled_tables = {}, []
    if run.trace:
        n_prof = run.traffic["profiled_batches"]
        before = len(_counter_values(profiling))
        with span_kernels.profiled_spans(run, lambda: n_prof, SPANS, span_s):
            for _ in range(n_prof):
                collect_lm._next_batch(run, st)
            collect_kind._drain(st)
        profiled_tables = _counter_values(profiling)[before:before + n_prof]
    profiling.reset()
    first = len(st["names"])
    t0 = time.perf_counter()
    files, audio_s = 0, 0.0
    while True:
        n, s = collect_lm._next_batch(run, st)
        files += n
        audio_s += s
        if time.perf_counter() - t0 >= run.seconds:
            break
    collect_kind._drain(st)
    elapsed = time.perf_counter() - t0
    st["window_files"] = list(range(first, first + files))
    spans = {k: profiling.calls(k) for k in ("decode_batch", "store_append", "d2h_fetch")}
    cfg = run.config
    reading = {"files": files, "seconds": elapsed, "batch": batch, "spans": spans,
               "span_device_s": span_s, "profiled_tokens": profiled_tables,
               "window_tokens": _counter_values(profiling),
               "positions": cfg["audio_tokens"] + run.traffic["prompt_before"]
               + run.traffic["prompt_after"]}
    return Window({"collect_rtfx": audio_s / elapsed}, files, 0, reading)


def capture_names(layers: int) -> list:
    names = ["lm.embed"]
    for i in range(layers):
        p = f"lm.layers.{i}"
        names += [p, f"{p}.mlp.input", f"{p}.mlp.router", f"{p}.mlp.route"]
    return names


def _capture(run, st, paths) -> dict:
    """The program's taps for the files at ``paths`` (in order), through
    its own log-mel and capture path, as one batch padded to the window's;
    → CPU tensors, (files, positions, ·)."""
    from freud_tpu_torch.data.audio_dataset import AudioBatchPipeline

    folder = run.tmp / "checked"
    folder.mkdir()
    for i, p in enumerate(paths):
        (folder / f"c_{i:04d}.wav").symlink_to(p)
    runtime = st["loader"].runtime
    batch = run.config["collect"]["batch_size"]
    pipe = AudioBatchPipeline(str(folder), batch, runtime.dims.n_mels, device=st["dev"])
    (mels, _, _), = list(pipe)
    n = mels.shape[0]
    mels = torch.cat([mels, mels.new_zeros((batch - n, *mels.shape[1:]))])
    layer = int(run.config["layer_name"].split(".")[2])
    caps = runtime.capture(mels, capture_names(layer + 1))
    return {k: v.reshape(batch, -1, v.shape[-1])[:n].cpu() for k, v in caps.items()}


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
    names = [st["names"][i] for i in rows]
    caps = _capture(run, st, [os.path.realpath(p) for p in names])
    pending = {k: st[k] for k in ("dev", "hf", "sae", "routers", "out", "pool")}
    pending.update(rows=rows, names=names, caps=caps)
    st.clear()
    gc.collect()
    if pending["dev"].type == "cuda":
        torch.cuda.empty_cache()
    return pending


def _reference_input(run, hf: dict, paths, dev, pool: int) -> torch.Tensor:
    """The reference's LM input straight from the WAVs at ``paths``:
    (files, T, d)."""
    cfg = run.config
    dims = cfg["audio_tower"]
    mels = torch.stack([ref_whisper.log_mel(data.read_wav(p), dims["n_mels"], dev)
                        for p in paths])
    tw = omni_data.tower_f32(run.seed_for, hf, dev)
    enc = ref_longcat.tower(tw, dims, mels)
    del tw
    specs = longcat_data.other_specs(hf)
    o = {n: longcat_data.draw(run.seed_for, n, s, dev, f32=True) for n, s in specs.items()}
    audio = ref_longcat.audio_tokens(enc, o["model.audio_projector.weight"],
                                     o["model.audio_projector.bias"], pool, cfg["audio_tokens"])
    pre = torch.tensor(hf["audio_prompt"]["prefix_ids"], device=dev)
    post = torch.tensor(hf["audio_prompt"]["suffix_ids"], device=dev)
    b = audio.shape[0]
    emb = o["model.embed_tokens.weight"]
    return torch.cat([emb[pre].expand(b, -1, -1), audio, emb[post].expand(b, -1, -1)], dim=1)


def _layer_readings(got: dict, ref: dict, x_in: torch.Tensor, w: dict) -> dict:
    """The compared numbers of one layer: ``got`` (the program's taps, or
    the control's outputs) against ``ref``, the reference on the same
    input."""
    u = got["u"].float()
    p_ref = torch.softmax(u @ w[longcat_data.ROUTER].T, dim=-1)
    router_gap = float(((got["probs"].float() - p_ref).abs().max(1).values
                        / p_ref.max(1).values).max())
    a = torch.sort(got["sel"].to(torch.int64), dim=1).values
    b = torch.sort(ref["sel"], dim=1).values
    flips = (a != b).any(1)
    keep = ~flips.reshape(x_in.shape[:2])
    diff = (got["out"].float() - ref["out"])[keep]
    update = (ref["out"] - x_in)[keep]
    gap = float(diff.pow(2).mean().sqrt() / update.pow(2).mean().sqrt().clamp(min=1e-30))
    return {"router_gap": router_gap, "layer_out_gap": gap, "margins": ref["margin"][flips],
            "flips": int(flips.sum()), "routes": int(flips.numel())}


def _worst(per_layer: list) -> dict:
    """The layers' readings as compared: the worst layer's gaps, and the
    flips' margins pooled over every layer."""
    margins = torch.cat([r["margins"] for r in per_layer])
    out = {k: max(r[k] for r in per_layer) for k in ("router_gap", "layer_out_gap")}
    out["route_flip_margin"] = float(torch.quantile(margins, FLIP_QUANTILE)) \
        if margins.numel() else 0.0
    out["largest_flip_margin"] = float(margins.max()) if margins.numel() else 0.0
    out["flips"] = sum(r["flips"] for r in per_layer)
    out["routes"] = sum(r["routes"] for r in per_layer)
    return out


def check(run, pending) -> dict:
    pin_f32()
    cfg, hf, dev, caps = run.config, pending["hf"], pending["dev"], pending["caps"]
    layers = int(cfg["layer_name"].split(".")[2]) + 1
    start, q = len(hf["audio_prompt"]["prefix_ids"]), cfg["audio_tokens"]
    x_ref = _reference_input(run, hf, [os.path.realpath(n) for n in pending["names"]], dev,
                             pending["pool"])
    prog, ctrl = [], []
    for i in range(layers):
        w = longcat_data.layer_f32(run.seed_for, hf, i, dev, pending["routers"])
        p = f"lm.layers.{i}"
        x_in = caps["lm.embed" if i == 0 else f"lm.layers.{i - 1}"].to(dev).float()
        ref = ref_longcat.layer(w, hf, x_in)
        got = {"u": caps[f"{p}.mlp.input"].to(dev).reshape(-1, x_in.shape[-1]),
               "probs": caps[f"{p}.mlp.router"].to(dev).reshape(-1, ref["probs"].shape[1]),
               "sel": caps[f"{p}.mlp.route"].to(dev).reshape(-1, ref["sel"].shape[1]),
               "out": caps[p].to(dev)}
        prog.append(_layer_readings(got, ref, x_in, w))
        if run.control:
            c = ref_longcat.layer(w, hf, x_in, operand=ref_longcat.fp8)
            ctrl.append(_layer_readings(c, ref, x_in, w))
        x_ref = ref_longcat.layer(w, hf, x_ref)["out"]
        del w, ref, got
    tap = caps[cfg["layer_name"]].to(dev).float()[:, start:start + q]
    ref_tap = x_ref[:, start:start + q]
    path_gap = float((tap - ref_tap).pow(2).mean().sqrt() / ref_tap.pow(2).mean().sqrt())
    sae = {k: v.to(dev) for k, v in pending["sae"].items()}
    k = cfg["sae"]["k"]
    vals, idx = collect_kind._stored(run, pending)
    gaps, cgaps = [], []
    for f in range(tap.shape[0]):
        lat = ref_longcat.sae_latents(sae, tap[f])
        gaps.append(judge.topk_gap(vals[f].to(dev), idx[f].to(dev), lat, k))
        if run.control:
            low = ref_longcat.sae_latents({**sae, "encoder.weight": ref_longcat.fp8(
                sae["encoder.weight"])}, ref_longcat.fp8(tap[f] - sae["b_dec"]) + sae["b_dec"])
            top = torch.topk(low, k, dim=-1)
            cgaps.append(judge.topk_gap(top.values, top.indices, lat, k))
        del lat
    worst = _worst(prog)
    values = {"router_gap": worst["router_gap"], "route_flip_margin": worst["route_flip_margin"],
              "layer_out_gap": worst["layer_out_gap"], "topk_gap": max(gaps)}
    run.notes["route flips (not compared)"] = (
        f"{worst['flips']} of {worst['routes']} routes "
        f"({worst['flips'] / max(worst['routes'], 1):.2e}), the largest margin "
        f"{worst['largest_flip_margin']:.4f}")
    run.notes["path_gap (not compared)"] = path_gap
    run.notes["per-layer readings"] = [{k: round(v, 7) if isinstance(v, float) else v
                                        for k, v in r.items() if k != "margins"} for r in prog]
    if run.control:
        cw = _worst(ctrl)
        run.notes["control"] = {"router_gap": cw["router_gap"],
                                "route_flip_margin": cw["route_flip_margin"],
                                "layer_out_gap": cw["layer_out_gap"], "topk_gap": max(cgaps),
                                "largest_flip_margin": cw["largest_flip_margin"],
                                "flips": cw["flips"]}
    return values
