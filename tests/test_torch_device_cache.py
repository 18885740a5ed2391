"""freud_tpu_torch's GPU-resident training input against freud_tpu's, on the
CPU: the device shuffle cache (``data/device_cache.py``), the fused chunk
``SAETrainer.train_chunk``, ``DeviceValSet`` and ``train()``'s cache
wiring, and the optimizer's device-count form.

Held to JAX on the same numpy stores: the window after the fill bit-equal
(f32 and bf16), the refresh plan (rows and slots) equal, decoder stores'
resampled rows equal; chunks on JAX's own ``jax.random`` index stream land
on JAX's ``train_chunk`` parameters within ``test_trainer_steps_match_jax``'s
tolerances (1e-4 of max |ref| in f32, 2e-2 in bf16); resident validation
equal to streaming validation and within 1e-5 of JAX's ``validate``.
Within the port: ``train_chunk`` equals per-step training bit for bit (the
CPU generator's draws concatenate), and the device-count optimizer and
schedule equal their host forms within 1e-6 relative over 30 updates."""

import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.data.device_cache import DeviceShuffleCache as JaxCache
from freud_tpu.data.store import ActivationStoreWriter
from freud_tpu.train import trainer as jtrainer
from freud_tpu_torch.data import device_cache as dc
from freud_tpu_torch.data.device_cache import DeviceShuffleCache
from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
from freud_tpu_torch.data.store import ActivationStoreReader
from freud_tpu_torch.models.sae import params_from_jax
from freud_tpu_torch.train import trainer as ttrainer
from freud_tpu_torch.train.optim import make_optimizer, make_schedule
from freud_tpu_torch.train.trainer import DeviceValSet, SAETrainer, train, validate

N_FILES, T, D = 20, 4, 6
L1_CFG = {"n_dict_components": 8, "recon_alpha": 1.0}
TOPK_CFG = {"expansion_factor": 2, "k": 2, "auxk_alpha": 1 / 32,
            "dead_feature_threshold": 6}
CFGS = {"l1": L1_CFG, "topk": TOPK_CFG}


def _write_store(folder, layer="L", n_frames=None, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((N_FILES, T, D)).astype(np.float32)
    data[:, 0, 0] = np.arange(N_FILES)  # each file tagged with its index
    w = ActivationStoreWriter(folder, layer, (T, D), (T, D))
    w.append_batch([f"f{i}" for i in range(N_FILES)], data, n_frames=n_frames)
    w.close()
    return str(folder), data


@pytest.fixture()
def store(tmp_path):
    return _write_store(tmp_path / "s")


def _bits(a) -> np.ndarray:
    """Bit patterns of a JAX array or a torch tensor (f32 or bf16)."""
    if torch.is_tensor(a):
        return a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# ------------------------------------------------------------ the cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fill_matches_jax(store, dtype):
    path, _ = store
    kw = dict(capacity_files=8, refresh_files=0, seed=3, start_step=2, cache_dtype=dtype)
    jc, tc = JaxCache(path, "L", **kw), DeviceShuffleCache(path, "L", **kw, device="cpu")
    try:
        assert tc.cache.dtype == dc.CACHE_DTYPES[dtype] and tc.capacity == 8
        assert tc.window_bytes == 8 * T * D * (4 if dtype == "float32" else 2)
        np.testing.assert_array_equal(_bits(tc.cache), _bits(jc.cache))
    finally:
        jc.close()
        tc.close()
    with pytest.raises(ValueError, match="cache_dtype"):
        DeviceShuffleCache(path, "L", capacity_files=4, cache_dtype="float16", device="cpu")
    # a pod rank's stratum (every 2nd file from 1) fills as JAX's does
    kw = {**kw, "capacity_files": 6, "process_shard": (1, 2)}
    jc, tc = JaxCache(path, "L", **kw), DeviceShuffleCache(path, "L", **kw, device="cpu")
    try:
        np.testing.assert_array_equal(tc._files, np.arange(N_FILES)[1::2])
        np.testing.assert_array_equal(_bits(tc.cache), _bits(jc.cache))
    finally:
        jc.close()
        tc.close()
    with pytest.raises(TypeError, match="Mesh"):
        DeviceShuffleCache(path, "L", capacity_files=4, mesh=object())


def test_refresh_plan_matches_jax(store):
    """The first three refresh items (rows and slots) JAX's producer queues,
    with a slot aimed at twice keeping its last row, are the port's; applied
    in order they leave the same window."""
    path, _ = store
    kw = dict(capacity_files=8, refresh_files=6, seed=3)
    jc, tc = JaxCache(path, "L", **kw), DeviceShuffleCache(path, "L", **kw, device="cpu")
    try:
        jwin, twin = jc.cache, tc.cache.clone()
        for _ in range(3):
            jrows, jslots = jc._q.get(timeout=30)
            trows, tslots, event = tc._q.get(timeout=30)
            assert event is None
            want_rows, want_slots = dc._last_of_each_slot(np.asarray(jrows),
                                                          np.asarray(jslots))
            np.testing.assert_array_equal(tslots.numpy(), want_slots)
            np.testing.assert_array_equal(trows.numpy(), want_rows)
            jwin = jwin.at[jslots].set(jrows)
            twin.index_copy_(0, tslots, trows)
            np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    finally:
        jc.close()
        tc.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_samples_are_store_rows(store, dtype):
    path, data = store
    cache = DeviceShuffleCache(path, "L", capacity_files=8, refresh_files=0,
                               cache_dtype=dtype, device="cpu")
    try:
        want = torch.from_numpy(data).to(dc.CACHE_DTYPES[dtype]).float()
        draws = [cache.next_batch(5) for _ in range(4)]
        for batch in draws:
            assert batch.shape == (5, T, D) and batch.dtype == torch.float32
            for row in batch:
                tag = int(row[0, 0])
                assert tag in range(N_FILES)
                torch.testing.assert_close(row, want[tag], rtol=0, atol=0)
        assert any(not torch.equal(draws[0], d) for d in draws[1:])
    finally:
        cache.close()


def test_resume_does_not_reissue_start_indices(store):
    path, _ = store
    draws = {}
    for start in (0, 0, 5):
        cache = DeviceShuffleCache(path, "L", capacity_files=20, refresh_files=0,
                                   start_step=start, device="cpu")
        draws.setdefault(start, []).append(cache.draw(4, 8))
        cache.close()
    assert torch.equal(*draws[0])  # the same start, the same stream
    assert not torch.equal(draws[0][0], draws[5][0])


def test_refresh_brings_new_files(store):
    path, _ = store
    cache = DeviceShuffleCache(path, "L", capacity_files=4, refresh_files=4, device="cpu")
    try:
        first = {int(t) for t in cache.cache[:, 0, 0]}
        seen = set()
        deadline = time.time() + 20
        while time.time() < deadline and not seen - first:
            seen.update(int(t) for t in cache.next_batch(8)[:, 0, 0])
        assert seen - first, f"only saw {sorted(seen)}"
    finally:
        cache.close()


def test_broken_store_surfaces_in_next_batch(store, monkeypatch):
    path, _ = store
    read = ActivationStoreReader.batch
    calls = []

    def fail_after_fill(self, indices):
        calls.append(len(indices))
        if len(calls) > 1:
            raise OSError("store went away")
        return read(self, indices)

    monkeypatch.setattr(ActivationStoreReader, "batch", fail_after_fill)
    cache = DeviceShuffleCache(path, "L", capacity_files=4, refresh_files=2, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="refresh thread died"):
            deadline = time.time() + 20
            while time.time() < deadline:
                cache.next_batch(2)
        assert isinstance(cache._error, OSError)
    finally:
        cache.close()


def test_decoder_store_resampled_rows_match_jax(tmp_path):
    layer = "decoder.blocks.0"
    n_frames = [T - i % 3 for i in range(N_FILES)]
    path, data = _write_store(tmp_path / "d", layer, n_frames=n_frames)
    kw = dict(capacity_files=10, refresh_files=0, seed=4)
    jc, tc = JaxCache(path, layer, **kw), DeviceShuffleCache(path, layer, **kw, device="cpu")
    try:
        assert tc._resample
        np.testing.assert_array_equal(tc.cache.numpy(), np.asarray(jc.cache))
        # padding rows were replaced by valid rows of the same file
        for row in tc.cache.numpy():
            f = int(row[0, 0])
            valid = data[f, : n_frames[f]]
            for t in range(n_frames[f], T):
                assert any(np.array_equal(row[t], v) for v in valid)
    finally:
        jc.close()
        tc.close()


# ------------------------------------------------------------ train_chunk


def _trainers(variant, amp=True, seed=3):
    kw = dict(optimizer="adam", scheduler="linear",
              scheduler_params={"num_warmup_steps": 1}, lr=1e-2, steps=12,
              clip_thresh=1.0, seed=seed, amp=amp)
    jt = jtrainer.SAETrainer(variant, CFGS[variant], D, **kw)
    tt = SAETrainer(variant, CFGS[variant], D, **kw, device="cpu")
    src = params_from_jax(variant, jax.tree_util.tree_map(np.asarray, jt.params))
    with torch.no_grad():
        for name, p in tt.params.named_parameters():
            p.copy_(getattr(src, name))
    return jt, tt


def _rel(a, b) -> float:
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_train_chunk_matches_per_step(store, variant):
    """Two chunks of 3 land where 6 per-step ``next_batch`` steps land, bit
    for bit: the same body, and the CPU generator's (3, 8) draw is three
    consecutive (1, 8) draws."""
    path, _ = store
    out = {}
    for chunked in (False, True):
        trainer = SAETrainer(variant, CFGS[variant], D, optimizer="adam",
                             scheduler="linear", scheduler_params={"num_warmup_steps": 1},
                             lr=1e-2, steps=12, seed=3, device="cpu")
        cache = DeviceShuffleCache(path, "L", capacity_files=20, refresh_files=0, seed=7, device="cpu")
        try:
            if chunked:
                stacks = [trainer.train_chunk(cache, 8, 3) for _ in range(2)]
                metrics = {k: v[-1] for k, v in stacks[-1].items()}
                assert all(v.shape == (3,) for v in stacks[0].values())
            else:
                for _ in range(6):
                    metrics = trainer.train_step(cache.next_batch(8))
        finally:
            cache.close()
        assert trainer.step == 6
        out[chunked] = (trainer._state(), metrics)
    for a, b in zip(out[False][0], out[True][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_train_chunk_matches_jax(store, variant, amp):
    """Chunks on JAX's own index stream (the split/randint chain of
    ``sample_rows``, replayed here from the cache's key) land on JAX's
    ``train_chunk`` parameters; AuxK runs in the TopK chunk."""
    path, _ = store
    jt, tt = _trainers(variant, amp)
    jc = JaxCache(path, "L", capacity_files=20, refresh_files=0, seed=7)
    tc = DeviceShuffleCache(path, "L", capacity_files=20, refresh_files=0, seed=7, device="cpu")
    tol = 2e-2 if amp else 1e-4
    try:
        np.testing.assert_array_equal(tc.cache.numpy(), np.asarray(jc.cache))
        for _ in range(2):
            key, idx = jc._key, []
            for _ in range(3):
                key, sub = jax.random.split(key)
                idx.append(np.asarray(jax.random.randint(sub, (4,), 0, jc.cache.shape[0])))
            jm = jax.device_get(jt.train_chunk(jc, 4, 3))
            tm = tt.train_chunk(tc, 4, 3, indices=torch.from_numpy(np.stack(idx)).long())
            for k in jm:
                np.testing.assert_allclose(tm[k].numpy(), jm[k], rtol=tol,
                                           atol=tol * 1e-3, err_msg=k)
    finally:
        jc.close()
        tc.close()
    for name, p in tt.params.named_parameters():
        assert _rel(p, getattr(jt.params, name)) < tol, name
    assert tt.step == jt.step == 6
    if variant == "topk":
        assert float(tm["auxk_loss"][-1]) > 0
        np.testing.assert_array_equal(tt.num_frames_since_fired.numpy(),
                                      np.asarray(jt.num_frames_since_fired))


def test_pod_chunk_raises(store):
    """The pod chunk is ported: it needs a mesh; on a one-process mesh its
    steps equal per-step pod steps on the same window rows bit for bit (the
    ranks' chunks are tests/test_torch_distributed.py's)."""
    from freud_tpu_torch.parallel.mesh import Mesh

    path, _ = store
    with pytest.raises(ValueError, match="mesh"):
        SAETrainer("l1", L1_CFG, D, device="cpu").train_chunk_pod(None, 4, 2)
    out = {}
    for chunked in (False, True):
        trainer = SAETrainer("topk", TOPK_CFG, D, optimizer="adam", scheduler="linear",
                             scheduler_params={"num_warmup_steps": 1}, lr=1e-2,
                             steps=12, seed=3, mesh=Mesh("cpu"))
        cache = DeviceShuffleCache(path, "L", capacity_files=10, refresh_files=0,
                                   seed=7, process_shard=(0, 2), device="cpu")
        idx = torch.from_numpy(np.random.default_rng(0).integers(0, 10, (3, 4)))
        if chunked:
            metrics = {k: v[-1] for k, v in trainer.train_chunk_pod(cache, 4, 3, idx).items()}
        else:
            for i in range(3):
                metrics = trainer.train_step(dc.sample_rows(cache.cache, idx[i]),
                                             host_local=True)
        assert trainer.step == 3
        out[chunked] = (trainer._state(), metrics)
    for a, b in zip(out[False][0], out[True][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], v, rtol=0, atol=0)


# ------------------------------------------------------------ validation


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_device_val_set_matches_streaming_and_jax(store, variant):
    path, _ = store
    jt, tt = _trainers(variant)
    loader = MemoryMappedActivationLoader(path, "L", 8)
    vs = DeviceValSet(loader, "cpu")
    assert vs.ok and [n for _, n, _ in vs] == [8, 8, 4]
    resident = validate(tt, path, "L", "test:tiny", True, device_set=vs)
    streamed = validate(tt, path, "L", "test:tiny", True, loader=loader)
    jloader = jtrainer.init_dataloader(True, path, "test:tiny", None, "L", 8)[0]
    want = jtrainer.validate(jt, path, "L", "test:tiny", True, False, loader=jloader,
                             device_set=jtrainer.DeviceValSet(jloader))
    for k, v in want[0].items():
        assert resident[0][k] == streamed[0][k]
        if v is None:
            assert resident[0][k] is None
        else:
            assert resident[0][k] == pytest.approx(v, rel=1e-5), k
    for i in (4, 5):  # magnitude maxes and stds
        np.testing.assert_array_equal(resident[i], streamed[i])
        np.testing.assert_allclose(resident[i], want[i], rtol=1e-5, atol=1e-6)
    assert not DeviceValSet(loader, "cpu", max_bytes=8 * T * D * 4 + 1).ok
    # a mesh places the set on its card: the same resident batches
    from freud_tpu_torch.parallel.mesh import Mesh

    on_mesh = DeviceValSet(loader, mesh=Mesh("cpu"))
    assert on_mesh.ok
    for (a, na, fa), (b, nb, fb) in zip(on_mesh, vs):
        assert na == nb and fa == fb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(TypeError, match="Mesh"):
        DeviceValSet(loader, "cpu", mesh=object())


def test_device_val_set_refuses_indexed_store(tmp_path):
    w = ActivationStoreWriter(tmp_path / "idx", "L", (T, 2), (T, 16), indexed=True)
    w.append_batch(["a"], np.ones((1, T, 2), np.float32), np.zeros((1, T, 2), np.int64))
    w.close()
    loader = MemoryMappedActivationLoader(str(tmp_path / "idx"), "L", 8)
    vs = DeviceValSet(loader, "cpu")
    assert not vs.ok and vs.batches == []


# ------------------------------------------------------------ train()


def _config(path, run_dir, variant="l1", **over):
    cfg = dict(seed=0, train_folder=path, val_folder=path, run_dir=str(run_dir),
               lr=1e-3, weight_decay=0.0, steps=4, clip_thresh=1.0, batch_size=4,
               log_tb_every=1, save_every=4, val_every=2,
               whisper_config={"model": "test:tiny", "layer_name": "L"},
               optimizer="adam", scheduler="linear",
               scheduler_params={"num_warmup_steps": 1},
               autoencoder_variant=variant, autoencoder_config=CFGS[variant],
               device="cpu", verbose=False, device_cache_files=8)
    cfg.update(over)
    return cfg


def _spy(monkeypatch):
    calls = []
    chunk, step = SAETrainer.train_chunk, SAETrainer.train_step

    def chunk_spy(self, cache, batch_size, n_steps, indices=None):
        calls.append(("chunk", n_steps))
        return chunk(self, cache, batch_size, n_steps, indices)

    def step_spy(self, batch):
        calls.append(("step", tuple(batch.shape)))
        return step(self, batch)

    monkeypatch.setattr(SAETrainer, "train_chunk", chunk_spy)
    monkeypatch.setattr(SAETrainer, "train_step", step_spy)
    return calls


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_train_through_the_cache(store, tmp_path, monkeypatch, variant):
    """Auto chunks (gcd(4, 2) = 2): every step logged from the chunks'
    stacks, checkpoints and validation on their cadence, the resident
    validation set on; an explicit chunk that does not divide a cadence
    raises; ``fused_steps`` 1 trains per step from the cache."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    path, _ = store
    calls = _spy(monkeypatch)
    vsets = []
    real_vs = ttrainer.DeviceValSet

    def vs_spy(*a, **k):
        vsets.append(real_vs(*a, **k))
        return vsets[-1]

    monkeypatch.setattr(ttrainer, "DeviceValSet", vs_spy)
    stats = train(**_config(path, tmp_path / "auto", variant))
    assert stats["steps"] == 4
    assert calls == [("chunk", 2), ("chunk", 2)]
    assert len(vsets) == 1 and vsets[0].ok
    acc = EventAccumulator(str(tmp_path / "auto"))
    acc.Reload()
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2, 3, 4]
    assert [e.step for e in acc.Scalars("val/mse")] == [2, 4]
    assert {p.name for p in (tmp_path / "auto" / "checkpoints").iterdir()} == {
        "step4.pth", "bestval.pth"}
    with pytest.raises(ValueError, match="must divide save_every=4"):
        train(**_config(path, tmp_path / "bad", variant, fused_steps=3, val_every=3))
    calls.clear()
    vsets.clear()
    train(**_config(path, tmp_path / "per_step", variant, fused_steps=1,
                    val_device_cache=False))
    assert calls == [("step", (4, T, D))] * 4 and vsets == []


def test_train_resume_off_a_chunk_boundary(store, tmp_path, monkeypatch):
    """A resume from step 5 with chunks of 2 runs step 6 per step, then a
    chunk, then the tail step per step."""
    path, _ = store
    train(**_config(path, tmp_path / "first", steps=5, fused_steps=2))
    calls = _spy(monkeypatch)
    stats = train(**_config(path, tmp_path / "resumed", steps=9, fused_steps=2,
                            start_checkpoint=str(tmp_path / "first" / "checkpoints"
                                                 / "step5.pth")))
    assert stats["steps"] == 9
    assert calls == [("step", (4, T, D)), ("chunk", 2), ("step", (4, T, D))]


def test_fly_mode_ignores_the_cache(tmp_path, monkeypatch):
    """Without a collected store there is nothing to cache: fly-mode
    training trains per step, as JAX does (``device_cache_files and
    from_disk``)."""
    import wave

    audio = tmp_path / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        with wave.open(str(audio / f"clip{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.standard_normal(8000) * 2000).astype(np.int16).tobytes())

    def no_cache(*a, **k):
        raise AssertionError("fly mode built a device cache")

    monkeypatch.setattr(ttrainer, "DeviceShuffleCache", no_cache)
    calls = _spy(monkeypatch)
    cfg = _config(str(audio), tmp_path / "fly", steps=1, batch_size=2, save_every=10,
                  val_every=10, from_disk=False, fused_steps=None,
                  whisper_config={"model": "test:tiny", "layer_name": "encoder.blocks.1"})
    assert train(**cfg)["steps"] == 1
    assert calls == [("step", (2, 1500, 384))]


# ------------------------------------------------------------ optimizer


class _HostRAdam(torch.optim.Optimizer):
    """The host form: optax's ``scale_by_radam`` with the count and the
    rectification branch read on the host (the port's earlier per-step
    optimizer)."""

    def __init__(self, params, lr, weight_decay):
        super().__init__(params, dict(lr=lr, betas=(0.9, 0.999), eps=1e-5,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                g = p.grad.add(p, alpha=group["weight_decay"])
                st = self.state[p]
                if not st:
                    st.update(t=0, m=torch.zeros_like(p), v=torch.zeros_like(p))
                st["t"] += 1
                t = st["t"]
                m = st["m"].mul_(b1).add_(g, alpha=1.0 - b1)
                v = st["v"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                b2t = b2 ** t
                ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
                mu_hat = m / (1.0 - b1 ** t)
                if ro >= 5.0:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    upd = r * mu_hat / ((v / (1.0 - b2t)).sqrt() + group["eps"])
                else:
                    upd = mu_hat
                p.add_(upd, alpha=-group["lr"])


@pytest.mark.parametrize("scheduler", ["cosine", "linear"])
@pytest.mark.parametrize("optimizer", ["adam", "radam"])
def test_device_count_optimizer_matches_host_form(optimizer, scheduler):
    """30 updates through the device-count form against the host form (the
    count read on the host: torch Adam, or the RAdam above, with the lr set
    from ``schedule.host`` and the global-norm clip taken on the host),
    from the same
    gradients; RAdam's rectification starts at update 6."""
    steps, lr, wd = 40, 1e-2, (0.1 if optimizer == "radam" else 0.0)
    sp = {"num_warmup_steps": 4}
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (5,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    dev_p = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    host_p = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched = make_optimizer(optimizer, scheduler, lr, steps, dev_p,
                                weight_decay=wd, clip_thresh=1.0, scheduler_params=sp)
    host = (torch.optim.Adam(host_p, lr=lr) if optimizer == "adam"
            else _HostRAdam(host_p, lr=lr, weight_decay=wd))
    for count in range(30):
        assert float(sched.device(torch.tensor(count, dtype=torch.int32))) == \
            pytest.approx(sched.host(count), rel=1e-6, abs=1e-12)
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  * (3.0 if count % 3 else 0.1)) for s in shapes]
        opt.update(grads)
        norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
        for p, g in zip(host_p, grads):  # optax's clip, the norm on the host
            p.grad = g.clone() if norm < 1.0 else g / norm
        for group in host.param_groups:
            group["lr"] = sched.host(count)
        host.step()
        for a, b in zip(dev_p, host_p):
            assert _rel(a, b.detach()) < 1e-6, count
    assert int(opt.count) == 30
    leaves = opt.state_leaves()
    assert leaves[0].dtype == leaves[-1].dtype == torch.int32
    assert int(leaves[0]) == int(leaves[-1]) == 30
    # the leaves load back in place: the same tensors, the same values
    mu0 = opt.mu[0]
    opt.load_state_leaves([t.clone() * 0 if i else t for i, t in enumerate(leaves)])
    assert opt.mu[0] is mu0 and float(mu0.abs().max()) == 0.0
    with pytest.raises(ValueError):
        make_schedule("step", 1e-3, 10, {})
