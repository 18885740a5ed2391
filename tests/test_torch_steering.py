"""Online decoder-layer steering in freud_tpu_torch against freud_tpu's, on
the same weights (JAX's ``init_params`` at ``test:tiny`` geometry carried
across by ``state_dict_from_jax``; SAEs by ``params_from_jax``) and the
same seeded inputs, f32 on the CPU:

* an identity tap leaves the greedy tokens bit-equal; an out-of-range tap
  layer raises ``ValueError``;
* the tapped KV-cached step's logits against the teacher-forced oracle
  (``decoder_forward`` with the tapped block output substituted back; the
  port alone, 2e-3 as tests/test_decoder_steering.py holds JAX), and
  against JAX's ``_decode_step`` with the same affine tap (1e-5 of max);
* the three steering taps (L1, TopK, raw channel) against JAX's on seeded
  x and SAE parameters, in f32 and bf16 x (1e-5 of max); steered greedy
  tokens (TopK at factor 1 and 5, L1, raw) equal to JAX's;
* the trainer: the validation transcripts of a ``decoder.blocks.1`` store,
  steered online by the live SAE, equal to JAX's (streamed and resident),
  with no reconstruction rows fetched (``substitute_rows=False``); a
  ``train()`` that logs the same TensorBoard transcript tags as JAX's; a
  sub-module decoder layer switching transcripts off with JAX's message;
  fly-mode decoder training resampling the EOT-padding rows as JAX's
  ``resample_padding_rows`` does for the same file names and seed.
"""

import dataclasses
import wave
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.analysis import features as jfeat
from freud_tpu.data import loaders as jloaders
from freud_tpu.data.store import ActivationStoreWriter
from freud_tpu.models.sae import l1 as jl1
from freud_tpu.models.sae import topk as jtopk
from freud_tpu.models.sae.config import config_for_variant
from freud_tpu.models.whisper import decoding as jdec
from freud_tpu.models.whisper import runtime as jruntime
from freud_tpu.models.whisper.config import dims_for as jax_dims_for
from freud_tpu.models.whisper.model import init_params
from freud_tpu.models.whisper.tokenizer import special_tokens
from freud_tpu.train import trainer as jtrainer
from freud_tpu_torch.analysis import features as tfeat
from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
from freud_tpu_torch.models.sae import l1 as tl1
from freud_tpu_torch.models.sae import params_from_jax
from freud_tpu_torch.models.sae import topk as ttopk
from freud_tpu_torch.models.whisper import WhisperRuntime, decoder_forward, dims_for
from freud_tpu_torch.models.whisper import decoding as tdec
from freud_tpu_torch.models.whisper import state_dict_from_jax
from freud_tpu_torch.models.whisper.load import decoder_from_state_dict
from freud_tpu_torch.train import trainer as ttrainer

DIMS = dims_for("test:tiny")
JDIMS = jax_dims_for("test:tiny")
ST = special_tokens(DIMS.n_vocab)
MAX_NEW = 8
B = 2
LAYER = "decoder.blocks.1"
TOPK = {"expansion_factor": 2, "k": 8, "auxk_alpha": 1 / 32, "dead_feature_threshold": 20}
L1 = {"n_dict_components": 768, "recon_alpha": 10.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module: the tier-1 run puts several pytest
    workers on one machine, and torch's OpenMP pool at full width in each
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def m():
    params = init_params(JDIMS, seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    decoder = decoder_from_state_dict(state_dict_from_jax(np_params, DIMS), DIMS).eval()
    rng = np.random.default_rng(0)
    encoded = rng.standard_normal((B, 1500, DIMS.n_text_state)).astype(np.float32)
    seq = ST.sot_sequence(lang_index=0, timestamps=True)
    return SimpleNamespace(params=params, np_params=np_params, decoder=decoder,
                           encoded=encoded, prompt=np.tile(np.asarray(seq), (B, 1)),
                           n_prompt=len(seq))


def _identity_tap(tp, x):
    return x


def _affine_tap(tp, x):
    return x * tp["g"] + tp["b"]


def _greedy(m, decoder_tap=None):
    return tdec.greedy_decode(m.decoder, DIMS, torch.from_numpy(m.encoded),
                              torch.from_numpy(m.prompt), m.n_prompt, max_new=MAX_NEW,
                              decoder_tap=decoder_tap)


def test_identity_tap_is_bit_equal(m):
    assert torch.equal(_greedy(m), _greedy(m, (1, _identity_tap, ())))


@pytest.mark.parametrize("layer", [DIMS.n_text_layer, -1])
def test_out_of_range_tap_layer_rejected(m, layer):
    with pytest.raises(ValueError, match="out of range"):
        _greedy(m, (layer, _identity_tap, ()))


def test_tapped_step_matches_oracle_and_jax(m):
    rng = np.random.default_rng(1)
    t = 6
    tokens = rng.integers(0, 200, (B, t))
    enc = torch.from_numpy(m.encoded)
    tp = {"g": torch.tensor(0.9), "b": torch.tensor(0.03)}
    jtp = {"g": jnp.float32(0.9), "b": jnp.float32(0.03)}
    steps = []
    with torch.inference_mode():
        cross = tdec._cross_kv_stacks(m.decoder, DIMS, enc)
        sk, sv = tdec._self_kv(DIMS, B, t, torch.float32, enc.device)
        pos = torch.zeros((), dtype=torch.int64)
        for p in range(t):
            steps.append(tdec._decode_step(
                m.decoder, DIMS, torch.from_numpy(tokens[:, p]), pos, sk, sv, cross,
                tap_layer=0, tap_fn=_affine_tap, tap_params=tp))
            pos += 1
        name = "decoder.blocks.0"
        args = (m.decoder, DIMS, torch.from_numpy(tokens), enc)
        _, caps = decoder_forward(*args, capture=(name,))
        oracle, _ = decoder_forward(*args, substitute={name: _affine_tap(tp, caps[name])})
        plain, _ = decoder_forward(*args)
    got = torch.stack(steps, 1)
    torch.testing.assert_close(got, oracle, atol=2e-3, rtol=2e-3)
    assert (oracle - plain).abs().max() > 1e-3  # the tap changed the computation
    # JAX's step with the same tap, position by position
    jenc = jnp.asarray(m.encoded)
    cross_j = jdec._cross_kv_stacks(m.params, JDIMS, jenc)
    shape = (DIMS.n_text_layer, B, t, DIMS.n_text_state)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    for p in range(t):
        want, jk, jv = jdec._decode_step(m.params, JDIMS, jnp.asarray(tokens[:, p]), p,
                                         jk, jv, cross_j, tap_layer=0,
                                         tap_fn=_affine_tap, tap_params=jtp)
        assert _rel(got[:, p], want) < 1e-5, p


# ------------------------------------------------------- the taps


def _saes(variant: str):
    """(config, JAX parameters, the port's module) of one SAE from JAX's
    init, carried across."""
    raw = L1 if variant == "l1" else TOPK
    cfg = config_for_variant(variant, raw)
    init = jl1.init_l1 if variant == "l1" else jtopk.init_topk
    jp = init(DIMS.n_text_state, cfg, seed=5)
    tp = params_from_jax(variant, jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jp, tp


def _tap_params(variant, jp, tp, feat, factor):
    jscal = (jnp.int32(feat), jnp.float32(factor))
    tscal = (torch.tensor(feat), torch.tensor(factor, dtype=torch.float32))
    if variant == "raw":
        return jscal, tscal
    if variant == "l1":
        jp, tp = jl1.normalize_columns(jp), tl1.normalize_columns(tp)
    return (jp, *jscal), (tp, *tscal)


def _fns(variant, cfg):
    if variant == "raw":
        return jfeat._raw_steer_tap, tfeat._raw_steer_tap
    return jfeat.sae_steer_fn(variant, cfg), tfeat.sae_steer_fn(variant, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.0, 5.0])
@pytest.mark.parametrize("variant", ["l1", "topk", "raw"])
def test_steer_tap_matches_jax(variant, factor, dtype):
    cfg, jp, tp = _saes("topk" if variant == "raw" else variant)
    x = (np.random.default_rng(2).standard_normal((3, 1, DIMS.n_text_state)) * 0.7
         ).astype(np.float32)
    # a feature (a channel) the first row selects, so the factor acts
    if variant == "topk":
        feat = int(np.argmax(np.asarray(jtopk.pre_acts(jp, jnp.asarray(x)))[0, 0]))
    else:
        feat = 11 if variant == "l1" else int(np.argmax(np.abs(x[0, 0])))
    jtap, ttap = _tap_params(variant, jp, tp, feat, factor)
    jfn, tfn = _fns(variant, cfg)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jfn(jtap, jx)
    with torch.inference_mode():
        got = tfn(ttap, tx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got, want) < 1e-5
    if variant == "raw":
        assert float(got[0, 0, feat]) == pytest.approx(float(tx[0, 0, feat]) * factor)


def test_sae_steer_fn_is_one_object_per_k():
    cfg = config_for_variant("topk", TOPK)
    assert tfeat.sae_steer_fn("topk", cfg) is tfeat.sae_steer_fn("topk", cfg)
    assert tfeat.sae_steer_fn("l1", None) is tfeat._l1_steer_tap


@pytest.mark.parametrize("variant,factor", [("topk", 1.0), ("topk", 5.0), ("l1", 0.0),
                                            ("raw", 3.0)])
def test_steered_greedy_tokens_match_jax(m, variant, factor):
    cfg, jp, tp = _saes("topk" if variant == "raw" else variant)
    enc = torch.from_numpy(m.encoded)
    plain = _greedy(m)
    # the feature (or channel) most often selected on the plain decode
    with torch.inference_mode():
        _, caps = decoder_forward(m.decoder, DIMS, plain, enc, capture=(LAYER,))
        acts = caps[LAYER]
        if variant == "l1":
            score = tl1.encode(tp, acts).latent
        elif variant == "topk":
            score = ttopk.pre_acts(tp, acts)
        else:
            score = acts.abs()
        feat = int(torch.bincount(score.argmax(-1).flatten()).argmax())
    jtap, ttap = _tap_params(variant, jp, tp, feat, factor)
    jfn, tfn = _fns(variant, cfg)
    want = jdec.greedy_decode(m.params, JDIMS, jnp.asarray(m.encoded),
                              jnp.asarray(m.prompt, jnp.int32), m.n_prompt,
                              max_new=MAX_NEW, decoder_tap=(1, jfn, jtap))
    got = _greedy(m, (1, tfn, ttap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if variant == "raw" or factor == 1.0:
        return
    # the steering reached the tokens: the steered decode is not the plain one
    assert not torch.equal(got, plain)


# ------------------------------------------------------- the trainer


def _write_wav(path, seconds, seed):
    audio = (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """``tiny`` (JAX's test:tiny weights) in ``$FREUD_WHISPER_DIR``, WAVs,
    and a decoder-layer store of them (one missing file and an undecodable
    one among its files, EOT padding in some rows)."""
    root = tmp_path_factory.mktemp("steering")
    wdir = root / "whisper"
    wdir.mkdir()
    np_params = jax.tree_util.tree_map(np.asarray, init_params(JDIMS, seed=3))
    torch.save({"dims": dataclasses.asdict(DIMS),
                "model_state_dict": state_dict_from_jax(np_params, DIMS)}, wdir / "tiny.pt")
    audio = root / "audio"
    audio.mkdir()
    for i, secs in enumerate((1.0, 2.5, 0.7, 1.7)):
        _write_wav(audio / f"a{i}.wav", secs, i)
    (audio / "bad.wav").write_bytes(b"RIFF, but not a wav file")
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))

    def store(layer, width=DIMS.n_text_state):
        path = root / f"store_{layer}"
        if not path.exists():
            t = 3 + MAX_NEW
            names = ["a0.wav", "missing.wav", "a1.wav", "a2.wav", "bad.wav", "a3.wav"]
            rng = np.random.default_rng(6)
            w = ActivationStoreWriter(path, layer, tensor_shape=(t, width),
                                      activation_shape=(t, width))
            for i, name in enumerate(names):
                w.append_batch([str(audio / name)],
                               rng.standard_normal((1, t, width)).astype(np.float32) * 0.5,
                               n_frames=[t - i % 3])
            w.close()
        return str(path)

    yield SimpleNamespace(root=root, audio=audio, store=store)
    mp.undo()


def _trainers():
    kw = dict(optimizer="adam", scheduler="linear", scheduler_params={"num_warmup_steps": 1},
              lr=1e-3, steps=4, clip_thresh=1.0, seed=3)
    jt = jtrainer.SAETrainer("topk", TOPK, DIMS.n_text_state, **kw)
    tt = ttrainer.SAETrainer("topk", TOPK, DIMS.n_text_state, **kw, device="cpu")
    src = params_from_jax("topk", jax.tree_util.tree_map(np.asarray, jt.params))
    with torch.no_grad():
        for name, p in tt.params.named_parameters():
            p.copy_(getattr(src, name))
    return jt, tt


@pytest.mark.parametrize("resident", [False, True], ids=["streamed", "resident"])
def test_validation_transcripts_steer_like_jax(env, monkeypatch, resident):
    jt, tt = _trainers()
    store = env.store(LAYER)
    jl = jtrainer.init_dataloader(True, store, "tiny", None, LAYER, 4,
                                  resample_padding=True)[0]
    tl = MemoryMappedActivationLoader(store, LAYER, 4, resample_padding=True)
    jset = jtrainer.DeviceValSet(jl, val_batch=4) if resident else None
    tset = ttrainer.DeviceValSet(tl, "cpu", val_batch=4) if resident else None
    jrt = jruntime.WhisperRuntime("tiny", LAYER, max_new_tokens=MAX_NEW)
    trt = WhisperRuntime("tiny", LAYER, max_new_tokens=MAX_NEW, device="cpu")
    jfn = jfeat.sae_steer_fn("topk", jt.cfg)
    tfn = tfeat.sae_steer_fn("topk", tt.cfg)
    flags = []

    def jtranscriber(mels, substitute_values=None):
        if substitute_values is None:
            return jrt.transcribe(mels)
        tap = jfeat.sae_roundtrip_tap_params("topk", jt.params)
        return jrt.transcribe(mels, decoder_tap=(1, jfn, tap))

    def ttranscriber(mels, substitute_values=None):
        flags.append(substitute_values)
        if substitute_values is None:
            return trt.transcribe(mels)
        tap = tfeat.sae_roundtrip_tap_params("topk", tt.params)
        return trt.transcribe(mels, decoder_tap=(1, tfn, tap))

    asked = []
    real = ttrainer.SAETrainer.validate_files

    def spy(self, batch, sae_out=False):
        asked.append(sae_out)
        return real(self, batch, sae_out)

    monkeypatch.setattr(ttrainer.SAETrainer, "validate_files", spy)
    want = jtrainer.validate(jt, store, LAYER, "tiny", True, True, val_batch=4,
                             transcriber=jtranscriber, loader=jl, device_set=jset,
                             substitute_rows=False)
    got = ttrainer.validate(tt, store, LAYER, "tiny", True, True, val_batch=4,
                            transcriber=ttranscriber, loader=tl, device_set=tset,
                            substitute_rows=False)
    assert got[3] == want[3] == [str(env.audio / f"a{i}.wav") for i in range(4)]
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[1]) == ttrainer.N_TRANSCRIPTS
    assert flags == [True, None] and asked and not any(asked)
    for k, v in want[0].items():
        assert (got[0][k] is None) if v is None else got[0][k] == pytest.approx(v, rel=1e-4)


def _train_config(store, run_dir, layer, **over):
    cfg = dict(seed=0, train_folder=store, val_folder=store, run_dir=str(run_dir),
               lr=1e-3, weight_decay=0.0, steps=2, clip_thresh=1.0, batch_size=2,
               log_tb_every=1, save_every=2, val_every=2,
               whisper_config={"model": "tiny", "layer_name": layer},
               optimizer="adam", scheduler="linear", scheduler_params={"num_warmup_steps": 1},
               autoencoder_variant="topk", autoencoder_config=TOPK,
               max_transcript_tokens=4, verbose=False)
    cfg.update(over)
    return cfg


def _tags(run_dir) -> set:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {t for kind in ("tensors", "audio") for t in acc.Tags().get(kind, [])}


def test_train_logs_decoder_transcripts_like_jax(env, tmp_path):
    store = env.store(LAYER)
    jtrainer.train(**_train_config(store, tmp_path / "jax", LAYER))
    assert ttrainer.train(**_train_config(store, tmp_path / "torch", LAYER,
                                          device="cpu"))["steps"] == 2
    got, want = _tags(tmp_path / "torch"), _tags(tmp_path / "jax")
    assert got == want
    for i in range(ttrainer.N_TRANSCRIPTS):
        for kind in ("reconstructed", "base"):
            assert any(t.startswith(f"val/transcripts/{kind}_{i}") for t in got), (kind, i)


def test_submodule_decoder_layer_switches_transcripts_off(env, tmp_path, capsys):
    layer = f"{LAYER}.mlp"
    store = env.store(layer)
    jtrainer.train(**_train_config(store, tmp_path / "jax", layer, steps=1,
                                   val_every=100, verbose=True))
    want = [ln for ln in capsys.readouterr().out.splitlines() if "transcript" in ln]
    ttrainer.train(**_train_config(store, tmp_path / "torch", layer, steps=1,
                                   val_every=100, verbose=True, device="cpu"))
    got = [ln for ln in capsys.readouterr().out.splitlines() if "transcript" in ln]
    assert got == want and len(got) == 1 and "decoder.blocks.N" in got[0]


class _FakeFlyLoader:
    """A fly loader's decoder batches without the model: rows carry their
    file's id in channel 0, EOT-padding rows -1 past n_frames."""

    activation_type = "tensor"

    def __init__(self, t=7, d=4):
        rng = np.random.default_rng(8)
        self.names = [f"/data/clip{i}.wav" for i in range(4)]
        self.n_frames = np.asarray([7, 3, 1, 5], np.int64)
        self.x = rng.standard_normal((4, t, d)).astype(np.float32)
        for i, n in enumerate(self.n_frames):
            self.x[i, :n, 0] = i
            self.x[i, n:, 0] = -1.0
        self.activation_shape = (t, d)
        self.dataset_length = 4
        self.batch_size = 2

    def __len__(self):
        return 2

    def iter_with_lengths(self):
        for lo in (0, 2):
            yield (self.x[lo:lo + 2].copy(), self.names[lo:lo + 2],
                   self.n_frames[lo:lo + 2])


def test_fly_mode_resamples_padding_like_jax(tmp_path, monkeypatch):
    fake = _FakeFlyLoader()
    monkeypatch.setattr(ttrainer, "init_dataloader",
                        lambda *a, **k: (fake, fake.activation_shape[-1], 4))
    seen = []
    real = ttrainer.SAETrainer.train_step

    def spy(self, batch):
        seen.append(np.array(batch))
        return real(self, batch)

    monkeypatch.setattr(ttrainer.SAETrainer, "train_step", spy)
    seed = 5
    ttrainer.train(**_train_config("unused", tmp_path / "fly", "decoder.blocks.0",
                                   seed=seed, steps=2, val_every=100, save_every=100,
                                   from_disk=False, enable_transcripts=False,
                                   device="cpu"))
    assert len(seen) == 2
    for (x, names, n_frames), got in zip(fake.iter_with_lengths(), seen):
        ids = [zlib.crc32(str(n).encode()) for n in names]
        want = jloaders.resample_padding_rows(x, ids, n_frames, seed)
        np.testing.assert_array_equal(got, want)
        assert (got[:, :, 0] >= 0).all()  # no padding row left
