"""Training traffic: ``SAETrainer.train_chunk`` over a ``DeviceShuffleCache``.

Set-up writes a store of seeded rows (``data.RowMaker``) into the run's
temporary directory in the store's own layout, builds the trainer with the
benchmark's weights and the cache over a window of the store, and takes the
check's steps, each call on explicit window slots (a step's slots drawn
without repeats), at a fixed step count:

1. three steps from the benchmark's weights, one ``train_chunk`` call
   each (a 1-step CUDA graph), so the first gradient shows in Adam's
   first moment;
2. one call of the window's own K-step chunk: the capture of the (K, B)
   graph that every window chunk replays, and its first replay, with the
   cache's producer running as in the window. It takes the trainer past
   the dead threshold, so AuxK is live from there;
3. one more single step, AuxK live, from the program's own state.

The window runs whole K-step chunks, each enqueued, synchronised and its
loss stack fetched as ``train()`` does, until ``--seconds`` have passed;
the cache draws their rows on the device and its producer refreshes the
window meanwhile. The check's steps are all in set-up, so what they read
does not depend on how many steps a window holds.

The check, after the window: the plain reference (``reference/sae.py``)
follows the first three steps from the same weights on the same rows (the
store's files that the program's window slots held, named by their
fingerprints); the chunk from the program's state saved before it, for
the traffic's ``check_steps`` steps (the whole chunk, or its first steps
where following all of them would outlast the window); and the AuxK step
from the program's state before it, which it can only follow from there.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import data, tracing
from portbench.reference import judge, pin_f32
from portbench.reference import sae as ref_sae

LEAVES = ref_sae.LEAVES
PROGRAM_LEAVES = ("encoder_weight", "encoder_bias", "W_dec", "b_dec")
B1 = 0.9
# read after a whole chunk and shown, not compared: the control reads them
# within three times of sound runs (Adam's step hardly depends on the
# gradient's precision; over 100 steps a few percent of the rarely firing
# latents fire on one side alone), so no limit separates the two
SHOWN_ONLY = ("chunk_update_gap", "chunk_dead_gap")


def shapes(cfg: dict) -> dict:
    d = cfg["whisper"]["n_audio_state"]
    sae = cfg["sae"]
    return {"d": d, "n_dict": d * sae["expansion_factor"], "k": sae["k"], "k_aux": d // 2,
            "frames": cfg["whisper"]["n_audio_ctx"], "batch": cfg["train"]["batch_size"]}


def hparams(cfg: dict) -> dict:
    t, sae = cfg["train"], cfg["sae"]
    return {"k": sae["k"], "auxk_alpha": sae["auxk_alpha"],
            "dead_feature_threshold": sae["dead_feature_threshold"], "lr": t["lr"],
            "steps": t["steps"], "scheduler": t["scheduler"],
            "num_warmup_steps": t["scheduler_params"].get("num_warmup_steps", 0),
            "clip_thresh": t["clip_thresh"]}


def _cpu(tensors) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in zip(LEAVES, tensors)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def identify(cache, slots: torch.Tensor, by_print: dict) -> np.ndarray:
    """The store file that each of ``slots`` holds now (same shape), by the
    fingerprints of the window's files; a slot that holds no store file is
    the program's fault (-1)."""
    held = []
    for i in range(0, cache.capacity, 4):
        sl = torch.arange(i, min(i + 4, cache.capacity), device=cache.cache.device)
        fp = data.fingerprint(cache.cache.index_select(0, sl))
        held.extend(by_print.get(int(v), -1) for v in fp.cpu().tolist())
    return np.asarray(held)[slots.cpu().numpy()]


def program_state(trainer) -> dict:
    return {"params": _cpu(getattr(trainer.params, n) for n in PROGRAM_LEAVES),
            "mu": _cpu(trainer.opt.mu), "nu": _cpu(trainer.opt.nu),
            "count": int(trainer.opt.count), "counters":
                trainer.num_frames_since_fired.detach().to("cpu", torch.int64)}


def setup(run) -> dict:
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache
    from freud_tpu_torch.train.trainer import SAETrainer

    cfg, tr = run.config, run.traffic
    sh = shapes(cfg)
    dev = torch.device(run.device)
    layer = cfg["layer_name"]
    maker = data.RowMaker(data.generator(dev, run.seed_for("rows")), tr["store_files"],
                          sh["frames"], sh["d"], tr["rows"], dev)
    store = run.tmp / "store"
    prints = data.write_store(store, layer, maker)
    del maker
    run.stage("store written")
    by_print = {int(v): i for i, v in enumerate(prints)}
    if len(by_print) != len(prints):
        raise RuntimeError("two store files share a fingerprint")
    weights = data.topk_sae_weights(data.generator(dev, run.seed_for("sae")), sh["d"],
                                    sh["n_dict"], dev)
    p0 = {n: w.cpu() for n, w in weights.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        # the peak is the program's: from here to the window's close
        torch.cuda.reset_peak_memory_stats(dev)
    t = cfg["train"]
    trainer = SAETrainer("topk", cfg["sae"], sh["d"], optimizer=t["optimizer"],
                         scheduler=t["scheduler"], scheduler_params=t["scheduler_params"],
                         lr=t["lr"], weight_decay=t["weight_decay"], steps=t["steps"],
                         clip_thresh=t["clip_thresh"], seed=run.seed_for("trainer") % 2**31,
                         amp=t["amp"], device=dev)
    with torch.no_grad():
        for n, pn in zip(LEAVES, PROGRAM_LEAVES):
            getattr(trainer.params, pn).copy_(weights[n])
    del weights
    rows = sh["batch"] * sh["frames"]
    cache = DeviceShuffleCache(
        str(store), layer, tr["window_files"], refresh_files=tr["refresh_files"],
        seed=run.seed_for("cache") % 2**63, cache_dtype="float32", device=dev,
        reserve_bytes=2 * trainer.step_working_bytes(rows) if dev.type == "cuda" else 0)
    run.stage("trainer and cache built")
    st = {"trainer": trainer, "cache": cache, "dev": dev, "sh": sh, "store": store,
          "by_print": by_print, "p0": p0,
          "rng": np.random.default_rng(run.seed_for("check")), "first": []}
    # 1. the first three steps, one train_chunk call a step
    for s in range(3):
        slots = _draw_slots(st, 1)
        m = trainer.train_chunk(cache, sh["batch"], 1, indices=slots)
        st["first"].append({"files": identify(cache, slots, by_print)[0],
                            "loss": float(m["loss"][0])})
        if s == 0:
            st["mu1"] = _cpu(trainer.opt.mu)
    st["p3"] = _cpu(getattr(trainer.params, n) for n in PROGRAM_LEAVES)
    run.stage("first three steps")
    # 2. the window's K-step graph: its capture and first replay
    k_steps, follow = tr["chunk_steps"], tr["check_steps"]
    before = program_state(trainer)
    slots = _draw_slots(st, k_steps)
    m = trainer.train_chunk(cache, sh["batch"], k_steps, indices=slots)
    st["chunk"] = {"files": identify(cache, slots, by_print)[:follow],
                   "loss": m["loss"].cpu().tolist()[:follow], "before": before,
                   "after": program_state(trainer) if follow == k_steps else None}
    _sync(dev)
    run.stage("K-step chunk captured and replayed")
    # 3. one step with AuxK live, from the program's own state
    before = program_state(trainer)
    slots = _draw_slots(st, 1)
    m = trainer.train_chunk(cache, sh["batch"], 1, indices=slots)
    st["last"] = {"files": identify(cache, slots, by_print)[0], "loss": float(m["loss"][0]),
                  "before": before, "after": program_state(trainer)}
    run.stage("AuxK step")
    dead = int((trainer.num_frames_since_fired > cfg["sae"]["dead_feature_threshold"]).sum())
    st["dead_at_start"] = dead
    run.log(f"dead latents at the window's start: {dead} of {sh['n_dict']} "
            f"(after {trainer.step} steps)")
    return st


def _draw_slots(st, n_steps: int) -> torch.Tensor:
    """(n_steps, batch) window slots, each step's without repeats."""
    cap, b = st["cache"].capacity, st["sh"]["batch"]
    slots = np.stack([st["rng"].choice(cap, b, replace=False) for _ in range(n_steps)])
    return torch.as_tensor(slots, dtype=torch.int64, device=st["dev"])


def window(run, st):
    from portbench.core import Window

    trainer, cache, dev, sh = st["trainer"], st["cache"], st["dev"], st["sh"]
    k_steps = run.traffic["chunk_steps"]
    calls: list[float] = []
    failed = 0

    def chunk() -> int:
        t0 = time.perf_counter()
        with torch.profiler.record_function("pb.train_chunk"):
            m = trainer.train_chunk(cache, sh["batch"], k_steps)
        calls.append(time.perf_counter() - t0)
        with torch.profiler.record_function("pb.sync"):
            _sync(dev)
            losses = m["loss"].cpu()
        return int((~torch.isfinite(losses)).sum())

    attempted = 0
    if run.trace:
        n_prof = run.traffic["profiled_chunks"]
        with tracing.profiled(run, lambda: n_prof * k_steps):
            for _ in range(n_prof):
                failed += chunk()
        attempted += n_prof * k_steps
        calls.clear()
    _sync(dev)
    t0 = time.perf_counter()
    steps = 0
    while True:
        failed += chunk()
        steps += k_steps
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    attempted += steps
    values = {"train_steps_per_s": steps / elapsed}
    if dev.type == "cuda":
        values["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    reading = {"chunk_call_s": list(calls), "steps": steps, "seconds": elapsed,
               "rows": sh["batch"] * sh["frames"], "d_in": sh["d"], "n_dict": sh["n_dict"],
               "k": sh["k"], "k_aux": sh["k_aux"], "auxk_live": st["dead_at_start"] > 0}
    return Window(values, attempted, failed, reading)


def finish(run, st) -> dict:
    """What the check reads; then the program's objects are freed."""
    pending = {k: st[k] for k in ("store", "p0", "first", "mu1", "p3", "sh", "chunk", "last")}
    pending["dev"] = st["dev"]
    st["cache"].close()
    st.clear()
    gc.collect()
    if pending["dev"].type == "cuda":
        torch.cuda.empty_cache()
    return pending


def _on(dev, state: dict) -> tuple:
    """A saved program state as the reference's (params, mu, nu, count,
    counters) on ``dev``."""
    def put(leaves):
        return {n: t.to(dev) for n, t in leaves.items()}

    return (put(state["params"]), put(state["mu"]), put(state["nu"]), state["count"],
            state["counters"].to(dev))


def _follow(run, pending, operand=None) -> dict:
    """The reference's outputs for the check's steps (``operand``: the
    control's precision): the three steps from the benchmark's weights on
    the program's rows, the chunk's first ``check_steps`` from the state
    saved before it, then the AuxK step from the program's state."""
    hp = hparams(run.config)
    dev, sh = pending["dev"], pending["sh"]
    # the whole store on the device once: the chunk reads many of its files
    store = torch.from_numpy(data.read_store_files(
        pending["store"], run.config["layer_name"], np.arange(run.traffic["store_files"]),
        sh["frames"], sh["d"])).to(dev)

    def rows(files) -> torch.Tensor:
        return store[torch.as_tensor(files, dtype=torch.int64, device=dev)]

    p0 = {n: t.to(dev) for n, t in pending["p0"].items()}
    zeros = {n: torch.zeros_like(t) for n, t in p0.items()}
    params, mu, nu = p0, zeros, zeros
    counters = torch.zeros(sh["n_dict"], dtype=torch.int64, device=dev)
    losses = []
    for s, step in enumerate(pending["first"]):
        out = ref_sae.topk_step(params, mu, nu, s, counters, rows(step["files"]), hp,
                                operand=operand)
        losses.append(out["loss"])
        if s == 0:
            g1 = out["grads"]
        params, mu, nu, counters = out["params"], out["mu"], out["nu"], out["counters"]
    res = {"loss": losses, "g1": g1, "p3": params}
    params, mu, nu, count, counters = _on(dev, pending["chunk"]["before"])
    chunk_losses = []
    for files in pending["chunk"]["files"]:
        out = ref_sae.topk_step(params, mu, nu, count, counters, rows(files), hp,
                                operand=operand)
        chunk_losses.append(out["loss"])
        params, mu, nu, counters = out["params"], out["mu"], out["nu"], out["counters"]
        count += 1
    res.update(chunk_loss=chunk_losses, chunk_params=params, chunk_counters=counters,
               chunk_g=out["grads"])
    params, mu, nu, count, counters = _on(dev, pending["last"]["before"])
    out = ref_sae.topk_step(params, mu, nu, count, counters, rows(pending["last"]["files"]),
                            hp, operand=operand)
    res.update(last_loss=out["loss"], g=out["grads"], params=out["params"],
               counters=out["counters"])
    return res


def _program(pending) -> dict:
    """The program's outputs in ``_follow``'s form: Adam's first moment
    after a step from zero is 0.1 of the clipped gradient, and after a
    later one μ − 0.9·μ_before."""
    b, a = pending["last"]["before"], pending["last"]["after"]
    c = pending["chunk"]["after"] or {}
    return {"loss": [s["loss"] for s in pending["first"]],
            "g1": {n: m / (1 - B1) for n, m in pending["mu1"].items()}, "p3": pending["p3"],
            "chunk_loss": pending["chunk"]["loss"], "chunk_params": c.get("params"),
            "chunk_counters": c.get("counters"), "last_loss": pending["last"]["loss"],
            "g": {n: (a["mu"][n] - B1 * b["mu"][n]) / (1 - B1) for n in LEAVES},
            "params": a["params"], "counters": a["counters"]}


def _change_gap(dev, got: dict, ref: dict, start: dict, names) -> float:
    """The worst counted leaf's gap of norms of the change from ``start``."""
    start = {n: start[n].to(dev) for n in names}
    return judge.leaf_norm_gap({n: got[n].to(dev) - start[n] for n in names},
                               {n: ref[n] - start[n] for n in names})


def _dead_gap(dev, got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of dead-feature counters that differ."""
    return float((got.to(dev) != ref).double().mean())


def _compare(pending, got: dict, ref: dict) -> dict:
    """The compared numbers of ``got`` (the program's outputs, or the
    control's) against the reference's ``ref``. The chunk's change and
    counters are compared where the reference follows the whole chunk."""
    dev = pending["dev"]
    loss_gaps = [judge.rel_gap(g, r) for g, r in zip(got["loss"], ref["loss"])]
    loss_gaps.append(judge.rel_gap(got["last_loss"], ref["last_loss"]))
    grad_gap = max(judge.leaf_norm_gap(got["g1"], ref["g1"]),
                   judge.leaf_norm_gap(got["g"], ref["g"]))
    update_gap = max(
        _change_gap(dev, got["p3"], ref["p3"], pending["p0"], judge.counted(ref["g1"])),
        _change_gap(dev, got["params"], ref["params"], pending["last"]["before"]["params"],
                    judge.counted(ref["g"])))
    out = {"loss_gap": max(loss_gaps), "grad_gap": grad_gap, "update_gap": update_gap,
           "dead_gap": _dead_gap(dev, got["counters"], ref["counters"]),
           "chunk_loss_gap": max(judge.rel_gap(g, r)
                                 for g, r in zip(got["chunk_loss"], ref["chunk_loss"]))}
    if pending["chunk"]["after"] is not None:
        out["chunk_update_gap"] = _change_gap(
            dev, got["chunk_params"], ref["chunk_params"],
            pending["chunk"]["before"]["params"], judge.counted(ref["chunk_g"]))
        out["chunk_dead_gap"] = _dead_gap(dev, got["chunk_counters"], ref["chunk_counters"])
    return out


def check(run, pending) -> dict:
    pin_f32()
    files = [s["files"] for s in pending["first"]]
    files += [*pending["chunk"]["files"], pending["last"]["files"]]
    if any((f < 0).any() for f in files):
        run.notes["window"] = "a window slot held rows that are no store file's"
        return {name: float("inf") for name in run.cell.limits}
    ref = _follow(run, pending)
    values = _compare(pending, _program(pending), ref)
    if run.control:
        run.notes["control"] = _compare(pending, _follow(run, pending, ref_sae.fp8_operand),
                                        ref)
    for name in SHOWN_ONLY:
        if name in values:
            run.notes[f"{name} (not compared)"] = values.pop(name)
    return values
