"""freud_tpu_torch's SAE training against freud_tpu's: optimizers and
schedules against optax, the trainer step against the JAX trainer on
explicit batches, checkpoints in both directions, the mmap loader, and
``train(**config)`` end to end (checkpoints, TensorBoard tags, resume).

Tolerances: optimizer updates within 1e-5 relative (same formulas, f32
rounding); trainer parameters after 3 steps within 1e-4 of max |ref| in f32
(``amp=False``) and 2e-2 in bf16; a resumed run equal to the uninterrupted
one (CPU, same order of operations)."""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from freud_tpu.data import loaders as jloaders
from freud_tpu.data.store import ActivationStoreWriter
from freud_tpu.train import checkpoint as jckpt
from freud_tpu.train.optim import make_optimizer as jax_make_optimizer
from freud_tpu.train.trainer import SAETrainer as JaxTrainer
from freud_tpu_torch.data import loaders as tloaders
from freud_tpu_torch.models.sae import params_from_jax
from freud_tpu_torch.scripts import train_sae
from freud_tpu_torch.train import checkpoint as tckpt
from freud_tpu_torch.train.optim import make_optimizer, make_schedule
from freud_tpu_torch.train.trainer import SAETrainer, train

LAYER = "encoder.blocks.1"
T, D = 16, 8


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ------------------------------------------------------------ optimizers


@pytest.mark.parametrize("optimizer,scheduler,wd", [
    ("adam", "linear", 0.0), ("radam", "cosine", 0.0), ("radam", "linear", 0.1),
])
def test_optimizer_and_schedule_match_optax(optimizer, scheduler, wd):
    """8 steps of identical gradient sequences (large enough that clipping
    bites, long enough that RAdam's rectification starts at step 6)."""
    steps, lr = 8, 1e-2
    sp = {"num_warmup_steps": 3}
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (5,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx, jsched = jax_make_optimizer(optimizer, scheduler, lr, steps,
                                    weight_decay=wd, clip_thresh=1.0, scheduler_params=sp)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched = make_optimizer(optimizer, scheduler, lr, steps, tp,
                                weight_decay=wd, clip_thresh=1.0, scheduler_params=sp)
    for step in range(steps):
        grads = [rng.standard_normal(s).astype(np.float32) * (3.0 if step % 2 else 0.2)
                 for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for a, b in zip(tp, jp):
            assert _rel(a, b) < 1e-5, step
        assert abs(sched(step) - float(jsched(step))) < 1e-9
    assert sched(0) == (0.0 if scheduler == "linear" else lr)  # optax counts from 0
    # the optimizer state as optax's leaves, in optax's order
    jleaves = jax.tree_util.tree_leaves(state)
    tleaves = opt.state_leaves()
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.shape == b.shape and a.dtype == torch.from_numpy(np.array(b)).dtype
        assert _rel(a, b) < 1e-5


def test_schedule_host_mirror():
    for scheduler in ("cosine", "linear"):
        s = make_schedule(scheduler, 4e-4, 100, {"num_warmup_steps": 10})
        assert s.host is s
        assert abs(s(55) - (4e-4 * 0.5 * (1 + np.cos(np.pi * 0.55)) if scheduler == "cosine"
                            else 4e-4 * 45 / 90)) < 1e-12
    with pytest.raises(ValueError):
        make_schedule("step", 1e-3, 10, {})


# ------------------------------------------------------------ trainer


def _batches(n=3, b=2, seed=0):
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((3, D)).astype(np.float32)
    return [(rng.standard_normal((b, T, 3)) @ basis
             + 0.1 * rng.standard_normal((b, T, D))).astype(np.float32) for _ in range(n)]


TRAINER_CASES = [
    ("l1", {"n_dict_components": 16, "recon_alpha": 100.0}, "radam", "cosine"),
    ("topk", {"expansion_factor": 4, "k": 3, "auxk_alpha": 1 / 32,
              "dead_feature_threshold": 10}, "adam", "linear"),
]


def _trainers(variant, ae_cfg, optimizer, scheduler, amp):
    kw = dict(optimizer=optimizer, scheduler=scheduler,
              scheduler_params={"num_warmup_steps": 1}, lr=1e-2, steps=10,
              clip_thresh=1.0, seed=0, amp=amp)
    jt = JaxTrainer(variant, ae_cfg, D, **kw)
    tt = SAETrainer(variant, ae_cfg, D, **kw, device="cpu")
    src = params_from_jax(variant, jax.tree_util.tree_map(np.asarray, jt.params))
    with torch.no_grad():
        for name, p in tt.params.named_parameters():
            p.copy_(getattr(src, name))
    return jt, tt


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,ae_cfg,optimizer,scheduler", TRAINER_CASES,
                         ids=["l1", "topk"])
def test_trainer_steps_match_jax(variant, ae_cfg, optimizer, scheduler, amp):
    jt, tt = _trainers(variant, ae_cfg, optimizer, scheduler, amp)
    tol = 2e-2 if amp else 1e-4
    for x in _batches():
        jm = jax.device_get(jt.train_step(x))
        tm = tt.train_step(x)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= tol * max(abs(float(jm[k])), 1e-3), k
    for name, p in tt.params.named_parameters():
        assert _rel(p, getattr(jt.params, name)) < tol, name
    if variant == "topk":
        # AuxK ran: latents that did not fire in step 1 were dead after it
        assert float(tm["dead_pct"]) > 0 and float(tm["auxk_loss"]) > 0
        np.testing.assert_array_equal(tt.num_frames_since_fired.numpy(),
                                      np.asarray(jt.num_frames_since_fired))
    assert tt.step == jt.step == 3
    assert tt.current_lr() == pytest.approx(jt.current_lr(), rel=1e-6)


@pytest.mark.parametrize("variant,ae_cfg,optimizer,scheduler", TRAINER_CASES,
                         ids=["l1", "topk"])
def test_validate_files_matches_jax(variant, ae_cfg, optimizer, scheduler):
    """Per-file validation statistics: each file its own batch, so a file's
    total variance is 0 → 1 and its val fvu is its squared error."""
    jt, tt = _trainers(variant, ae_cfg, optimizer, scheduler, amp=True)
    x = _batches(1, b=3, seed=2)[0]
    want = jax.device_get(jt.validate_files(x))
    got = tt.validate_files(x)
    assert set(got) == set(want) - {"sae_out", "sae_out_head"}
    for k, v in got.items():
        assert v.shape == want[k].shape and _rel(v, want[k]) < 1e-5, k
    if variant == "topk":
        sse = [float(np.sum((jax.device_get(want["sae_out"])[i] - x[i]) ** 2)) for i in range(3)]
        np.testing.assert_allclose(got["fvu"], sse, rtol=1e-5)


def test_checkpoints_interchange_both_ways(tmp_path):
    """A JAX checkpoint resumes in the port and a port checkpoint in JAX:
    parameters, optimizer leaves, step and dead counters carry over, and the
    next step agrees."""
    variant, ae_cfg, optimizer, scheduler = TRAINER_CASES[1]
    xs = _batches(4, seed=1)
    for first in ("jax", "torch"):
        jt, tt = _trainers(variant, ae_cfg, optimizer, scheduler, amp=False)
        src, dst = (jt, tt) if first == "jax" else (tt, jt)
        for x in xs[:2]:
            src.train_step(x)
        path = str(tmp_path / f"{first}.pth")
        src.save(path, src.hparams())
        ck = torch.load(path, weights_only=True)  # plain types and tensors only
        assert ck["num_frames_since_fired"].dtype == torch.int32
        dst.load(path)
        assert dst.step == 2
        jl = jax.tree_util.tree_leaves(jt.opt_state)
        for a, b in zip(tt.opt.state_leaves(), jl):
            assert _rel(a, b) < 1e-6
        np.testing.assert_array_equal(tt.num_frames_since_fired.numpy(),
                                      np.asarray(jt.num_frames_since_fired))
        for t in (jt, tt):
            t.train_step(xs[2])
        for name, p in tt.params.named_parameters():
            assert _rel(p, getattr(jt.params, name)) < 1e-4, (first, name)


def test_async_checkpoint_writer_rehomed():
    """The framework-free writer is the JAX package's, method for method."""
    for name in ("__init__", "_run", "_raise_pending", "submit", "flush", "close"):
        assert inspect.getsource(getattr(tckpt.AsyncCheckpointWriter, name)) == \
            inspect.getsource(getattr(jckpt.AsyncCheckpointWriter, name)), name
    assert inspect.getsource(tckpt._np_rng_to_plain) == inspect.getsource(jckpt._np_rng_to_plain)
    w = tckpt.AsyncCheckpointWriter()
    done = []
    w.submit(lambda: done.append(1))
    w.flush()
    w.close()
    assert done == [1]


# ------------------------------------------------------------ loaders


def _make_store(folder, n_files=10, seed=0):
    rng = np.random.default_rng(seed)
    w = ActivationStoreWriter(folder, LAYER, tensor_shape=(T, D), activation_shape=(T, D))
    basis = rng.standard_normal((3, D)).astype(np.float32)
    for i in range(n_files):
        x = (rng.standard_normal((1, T, 3)) @ basis
             + 0.1 * rng.standard_normal((1, T, D))).astype(np.float32)
        w.append_batch([f"f{i}.wav"], x, n_frames=[T - i % 4])
    w.close()
    return str(folder)


def test_mmap_loader_matches_jax(tmp_path):
    store = _make_store(tmp_path / "s")
    kw = dict(subset_size=None, shuffle=True, drop_last=True, seed=3)
    jl = jloaders.MemoryMappedActivationLoader(store, LAYER, 3, **kw)
    tl = tloaders.MemoryMappedActivationLoader(store, LAYER, 3, **kw)
    assert len(tl) == len(jl) and tl.batches_per_epoch == jl.batches_per_epoch
    for pos in (None, 4):
        if pos is not None:
            jl.set_position(pos)
            tl.set_position(pos)
        for _ in range(2):  # two epochs, reshuffled per epoch
            for jb, tb in zip(jl, tl):
                np.testing.assert_array_equal(tb[0], jb[0])
                assert tb[1] == jb[1]
    x = np.random.default_rng(1).standard_normal((3, T, D)).astype(np.float32)
    np.testing.assert_array_equal(
        tloaders.resample_padding_rows(x.copy(), [0, 5, 7], [T, 3, 0], 9),
        jloaders.resample_padding_rows(x.copy(), [0, 5, 7], [T, 3, 0], 9))
    r = tloaders.MemoryMappedActivationLoader(store, LAYER, 4, resample_padding=True)
    assert r.resample_padding
    _, feat, n = tloaders.init_dataloader(True, store, "test:tiny", None, LAYER, 4)
    assert (feat, n) == (D, 10)


# ------------------------------------------------------------ train()


def _config(store, run_dir, variant="topk", **over):
    ae = {"l1": {"n_dict_components": 16, "recon_alpha": 1e2},
          "topk": {"expansion_factor": 2, "k": 3, "auxk_alpha": 1 / 32,
                   "dead_feature_threshold": 20}}[variant]
    cfg = dict(seed=0, train_folder=store, val_folder=store, run_dir=str(run_dir),
               lr=1e-3, weight_decay=0.0, steps=4, clip_thresh=1.0, batch_size=3,
               log_tb_every=1, save_every=2, val_every=2,
               whisper_config={"model": "test:tiny", "layer_name": LAYER},
               optimizer="adam" if variant == "topk" else "radam",
               scheduler="linear" if variant == "topk" else "cosine",
               scheduler_params={"num_warmup_steps": 1},
               autoencoder_variant=variant, autoencoder_config=ae, device="cpu",
               verbose=False)
    cfg.update(over)
    return cfg


TB_TAGS = {  # tests/test_tensorboard_layout.py's reference tag sets
    "l1": {"train/loss", "train/loss_recon", "train/loss_l1", "train/lr",
           "val/loss_recon", "val/loss_l1", "val/mse",
           "val/encoded/num_dead", "val/encoded/percent_dead"},
    "topk": {"train/loss", "train/fvu", "train/auxk_loss", "train/multi_topk_fvu",
             "train/dead_pct", "train/lr", "val/fvu", "val/auxk_loss",
             "val/multi_topk_fvu", "val/mse"},
}


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_train_end_to_end_tensorboard_and_resume(tmp_path, variant):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    store = _make_store(tmp_path / "store")
    full = train(**_config(store, tmp_path / "full", variant))
    assert full["steps"] == 4 and full["steps_per_sec"] > 0
    ck_dir = tmp_path / "full" / "checkpoints"
    assert {p.name for p in ck_dir.iterdir()} == {"step2.pth", "step4.pth", "bestval.pth"}
    ck = torch.load(ck_dir / "step4.pth", weights_only=True)
    assert {"model", "optimizer", "scheduler", "step", "best_val_loss", "hparams",
            "numpy_rng_state", "random_rng_state", "num_frames_since_fired"} <= set(ck)
    assert ck["step"] == 4 and ck["hparams"]["autoencoder_variant"] == variant
    acc = EventAccumulator(str(tmp_path / "full"))
    acc.Reload()
    tags = acc.Tags()
    assert TB_TAGS[variant] <= set(tags["scalars"])
    assert {"val/encoded/magnitude_maxes", "val/encoded/magnitude_stds"} <= set(tags["histograms"])
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2, 3, 4]
    # resume from step 2: the same stream and the same final state
    resumed = train(**_config(store, tmp_path / "resumed", variant,
                              start_checkpoint=str(ck_dir / "step2.pth")))
    assert resumed["steps"] == 4
    ck2 = torch.load(tmp_path / "resumed" / "checkpoints" / "step4.pth", weights_only=True)
    for k, v in ck["model"].items():
        torch.testing.assert_close(ck2["model"][k], v, rtol=1e-6, atol=1e-7)
    # the JAX package resumes the port's checkpoint through its own train()
    from freud_tpu.train.trainer import train as jax_train

    jstats = jax_train(**{**_config(store, tmp_path / "jax", variant, steps=5,
                                    start_checkpoint=str(ck_dir / "step4.pth")),
                          "enable_transcripts": False})
    assert jstats["steps"] == 5


def test_train_cli_and_refusals(tmp_path, capsys, monkeypatch):
    store = _make_store(tmp_path / "store")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_config(store, tmp_path / "cli", steps=2, verbose=True)))
    train_sae.main(["--config", str(path)])
    lines = capsys.readouterr().out.strip().splitlines()
    # the store's files do not load, so no file takes a transcript slot
    assert not any(ln.startswith("transcript logging disabled:") for ln in lines)
    assert json.loads(lines[-1])["steps"] == 2
    # through the device cache: 2 steps as one fused chunk (gcd(2, 2) = 2)
    cached = train(**_config(store, tmp_path / "cached", steps=2, device_cache_files=4))
    assert cached["steps"] == 2
    assert {p.name for p in (tmp_path / "cached" / "checkpoints").iterdir()} == {
        "step2.pth", "bestval.pth"}
    with pytest.raises(ValueError):  # no full batch in the store
        train(**_config(store, tmp_path / "x", batch_size=11))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        train(**_config(store, tmp_path / "x", device="tpu"))
    # an SAE-indexed store is no training input
    w = ActivationStoreWriter(tmp_path / "idx", LAYER, (T, 2), (T, 16), indexed=True)
    w.append_batch(["a.wav"], np.ones((1, T, 2), np.float32), np.zeros((1, T, 2), np.int64))
    w.close()
    with pytest.raises(SystemExit):
        train(**_config(str(tmp_path / "idx"), tmp_path / "x", batch_size=1))


# ------------------------------------------------------------ fly mode


def test_fly_mode_drops_the_ragged_tail_like_jax(tmp_path, monkeypatch):
    """Fly-mode training (``from_disk: false``) over 3 clips at batch 2:
    JAX drops the short last batch (``drop_last``), so both packages take 2
    steps on full (2, 1500, 384) batches, and the port's fly loader counts
    1 batch with ``drop_last`` and 2 without."""
    import wave

    from freud_tpu.train import trainer as jtrainer

    audio = tmp_path / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        with wave.open(str(audio / f"clip{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.standard_normal(16000) * 2000).astype(np.int16).tobytes())
    common = dict(
        seed=0, train_folder=str(audio), val_folder=str(audio), lr=1e-3,
        weight_decay=0.0, steps=2, clip_thresh=1.0, batch_size=2,
        log_tb_every=100, save_every=100, val_every=100,
        whisper_config={"model": "test:tiny", "layer_name": LAYER},
        optimizer="adam", scheduler="linear", scheduler_params={},
        autoencoder_variant="l1",
        autoencoder_config={"n_dict_components": 16, "recon_alpha": 100.0},
        from_disk=False, enable_transcripts=False, verbose=False)
    seen = {"jax": [], "torch": []}
    jstep, tstep = jtrainer.SAETrainer.train_step, SAETrainer.train_step

    def jspy(self, batch, host_local=False):
        seen["jax"].append(tuple(np.shape(batch)))
        return jstep(self, batch, host_local)

    def tspy(self, batch):
        seen["torch"].append(tuple(batch.shape))
        return tstep(self, batch)

    monkeypatch.setattr(jtrainer.SAETrainer, "train_step", jspy)
    monkeypatch.setattr(SAETrainer, "train_step", tspy)
    jstats = jtrainer.train(run_dir=str(tmp_path / "jax"), **common)
    tstats = train(run_dir=str(tmp_path / "torch"), device="cpu", **common)
    assert jstats["steps"] == tstats["steps"] == 2
    assert seen["torch"] == seen["jax"] == [(2, 1500, 384)] * 2
    for drop_last, batches in ((True, 1), (False, 2)):
        loader = tloaders.FlyActivationLoader(str(audio), "test:tiny", None, LAYER, 2,
                                              drop_last=drop_last, device="cpu")
        assert len(loader) == batches and loader.dataset_length == 3
        assert len(loader.pipeline._batches()) == batches
