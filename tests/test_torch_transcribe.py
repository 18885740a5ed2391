"""Transcription end to end: freud_tpu_torch's ``WhisperRuntime``, batch
transcribe CLI and the trainer's validation transcripts against
freud_tpu's, on one set of weights (the JAX package's ``init_params`` at
``test:tiny`` geometry, written as an OpenAI-layout ``tiny.pt`` in
``$FREUD_WHISPER_DIR`` through ``state_dict_from_jax``, the pattern of
tests/test_torch_collection.py) and one folder of seeded WAVs, f32 on the
CPU, where both packages take their plain log-mel paths.

Held equal: ``transcribe_folder``'s JSON (greedy, beam search on the
t = 0 rung, and word timestamps with their probabilities within 1e-4), the
t = 0 fallback rung, ``fallback_accepts`` on a grid, the 4 + 4 validation
transcripts of an encoder-layer store (streamed and resident), and the
``--long`` CLI's txt, srt, vtt and tsv files byte for byte (its json up to
the statistics' 1e-4) with both seek loops pinned to t = 0. Without tokenizer assets both packages render text as
``<tok:N>``, so equal text is equal tokens."""

import dataclasses
import json
import wave
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from freud_tpu.data.store import ActivationStoreWriter
from freud_tpu.models.whisper import runtime as jruntime
from freud_tpu.models.whisper.config import dims_for as jax_dims_for
from freud_tpu.models.whisper.model import init_params
from freud_tpu.scripts.transcribe import transcribe_folder as jax_transcribe_folder
from freud_tpu.train import trainer as jtrainer
from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
from freud_tpu_torch.models.sae import params_from_jax
from freud_tpu_torch.models.whisper import WhisperRuntime, dims_for, state_dict_from_jax
from freud_tpu_torch.models.whisper import runtime as truntime
from freud_tpu_torch.scripts import transcribe as tcli
from freud_tpu_torch.train import trainer as ttrainer

MAX_NEW = 8
LAYER = "encoder.blocks.1"
TOPK = {"expansion_factor": 2, "k": 8, "auxk_alpha": 1 / 32, "dead_feature_threshold": 20}


def _write_wav(path, seconds, seed):
    audio = (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several pytest workers on one machine: torch's
    OpenMP pool at full width in each would oversubscribe the cores and
    make these vocabulary-wide passes crawl. One thread here, restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("transcribe")
    wdir = root / "whisper"
    wdir.mkdir()
    dims = dims_for("test:tiny")
    params = init_params(jax_dims_for("test:tiny"), seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    torch.save({"dims": dataclasses.asdict(dims),
                "model_state_dict": state_dict_from_jax(np_params, dims)}, wdir / "tiny.pt")
    audio = root / "audio"
    audio.mkdir()
    for i, secs in enumerate((1.0, 2.5, 0.7, 1.7)):
        _write_wav(audio / f"a{i}.wav", secs, i)
    (audio / "bad.wav").write_bytes(b"RIFF, but not a wav file")
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))
    yield SimpleNamespace(root=root, audio=audio, dims=dims)
    mp.undo()


@pytest.mark.parametrize("beam", [None, 3], ids=["greedy", "beam3"])
def test_transcribe_folder_matches_jax(env, beam):
    """4 clips and an undecodable file at batch 3 (a padded tail batch)."""
    kw = dict(model="tiny", batch_size=3, beam_size=beam, max_new_tokens=MAX_NEW,
              verbose=False)
    want = jax_transcribe_folder(str(env.audio), **kw)
    got = tcli.transcribe_folder(str(env.audio), device="cpu", **kw)
    assert got == want
    assert len(got) == 5 and got[str(env.audio / "bad.wav")] == "<decode-failed>"
    assert all(t.startswith("<tok:") for f, t in got.items() if not f.endswith("bad.wav"))


def test_fallback_t0_rung_and_substitution_match_jax(env):
    mels = (np.random.default_rng(4).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    jrt = jruntime.WhisperRuntime("tiny", max_new_tokens=MAX_NEW)
    trt = WhisperRuntime("tiny", max_new_tokens=MAX_NEW, device="cpu")
    assert trt.transcribe_with_fallback(torch.from_numpy(mels), temperatures=(0.0,)) == \
        jrt.transcribe_with_fallback(mels, temperatures=(0.0,))
    # the encoder splice the validation transcripts use, one (s, d) row
    # broadcast over the batch
    row = (np.random.default_rng(5).standard_normal((1500, 384)) * 0.5).astype(np.float32)
    assert trt.transcribe(torch.from_numpy(mels), substitute_layer=LAYER,
                          substitute_value=row) == \
        jrt.transcribe(mels, substitute_layer=LAYER, substitute_value=row)
    # a full ladder samples: torch's draws are not JAX's, only the shape holds
    texts = trt.transcribe_with_fallback(torch.from_numpy(mels))
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)


def test_fallback_accepts_matches_jax():
    texts = ["", "<tok:1><tok:1><tok:1>", "hello world", "la " * 40, "abc"]
    for text in texts:
        for sum_lp, n_text in ((-3.0, 5), (-40.0, 5), (0.0, 0), (-1.0, 0)):
            for nsp in (0.1, 0.9):
                for thr in ((2.4, -1.0, 0.6), (None, None, None), (1.0, -0.5, None)):
                    args = (text, sum_lp, n_text, nsp, *thr)
                    assert truntime.fallback_accepts(*args) == \
                        jruntime.fallback_accepts(*args), args


# ---------------------------------------------------- validation transcripts


@pytest.fixture(scope="module")
def val_store(env):
    """An encoder-layer store whose files are the WAVs, with one missing
    file and the undecodable one among them (neither takes a slot)."""
    names = ["a0.wav", "missing.wav", "a1.wav", "a2.wav", "bad.wav", "a3.wav"]
    rng = np.random.default_rng(6)
    path = env.root / "store"
    w = ActivationStoreWriter(path, LAYER, tensor_shape=(1500, 384),
                              activation_shape=(1500, 384))
    for name in names:
        w.append_batch([str(env.audio / name)],
                       rng.standard_normal((1, 1500, 384)).astype(np.float32) * 0.5,
                       n_frames=[1500])
    w.close()
    return str(path)


def _trainers():
    kw = dict(optimizer="adam", scheduler="linear", scheduler_params={"num_warmup_steps": 1},
              lr=1e-3, steps=4, clip_thresh=1.0, seed=3)
    jt = jtrainer.SAETrainer("topk", TOPK, 384, **kw)
    tt = ttrainer.SAETrainer("topk", TOPK, 384, **kw, device="cpu")
    src = params_from_jax("topk", jax.tree_util.tree_map(np.asarray, jt.params))
    with torch.no_grad():
        for name, p in tt.params.named_parameters():
            p.copy_(getattr(src, name))
    return jt, tt


def _transcriber(rt):
    def transcribe(mels, substitute_values=None):
        if substitute_values is None:
            return rt.transcribe(mels)
        return rt.transcribe(mels, substitute_layer=LAYER, substitute_value=substitute_values)
    return transcribe


@pytest.mark.parametrize("resident", [False, True], ids=["streamed", "resident"])
def test_validation_transcripts_match_jax(env, val_store, resident):
    """Batches of 4: the slots are a0, a1, a2 (batch 1: its bf16 transport
    head) and a3 (batch 2: the head again when streamed, the f32 rows when
    resident, as the JAX package fetches them)."""
    jt, tt = _trainers()
    jl = jtrainer.init_dataloader(True, val_store, "tiny", None, LAYER, 4)[0]
    tl = MemoryMappedActivationLoader(val_store, LAYER, 4)
    jset = jtrainer.DeviceValSet(jl, val_batch=4) if resident else None
    tset = ttrainer.DeviceValSet(tl, "cpu", val_batch=4) if resident else None
    jrt = jruntime.WhisperRuntime("tiny", LAYER, max_new_tokens=MAX_NEW)
    trt = WhisperRuntime("tiny", LAYER, max_new_tokens=MAX_NEW, device="cpu")
    want = jtrainer.validate(jt, val_store, LAYER, "tiny", True, True, val_batch=4,
                             transcriber=_transcriber(jrt), loader=jl, device_set=jset)
    got = ttrainer.validate(tt, val_store, LAYER, "tiny", True, True, val_batch=4,
                            transcriber=_transcriber(trt), loader=tl, device_set=tset)
    names = [str(env.audio / f"a{i}.wav") for i in range(4)]
    assert got[3] == want[3] == names
    assert len(got[1]) == len(got[2]) == ttrainer.N_TRANSCRIPTS
    assert got[1] == want[1] and got[2] == want[2]
    assert got[1] != got[2]  # the reconstruction changed what was heard
    for k, v in want[0].items():
        assert (got[0][k] is None) if v is None else got[0][k] == pytest.approx(v, rel=1e-4)
    # without log_base_transcripts only the reconstructed ones
    again = ttrainer.validate(tt, val_store, LAYER, "tiny", True, False, val_batch=4,
                              transcriber=_transcriber(trt), loader=tl, device_set=tset)
    assert again[1] == got[1] and again[2] == [] and again[3] == []


def test_train_logs_transcripts(env, val_store, tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cfg = dict(seed=0, train_folder=val_store, val_folder=val_store, run_dir=str(tmp_path),
               lr=1e-3, weight_decay=0.0, steps=2, clip_thresh=1.0, batch_size=2,
               log_tb_every=1, save_every=2, val_every=2,
               whisper_config={"model": "tiny", "layer_name": LAYER},
               optimizer="adam", scheduler="linear", scheduler_params={"num_warmup_steps": 1},
               autoencoder_variant="topk", autoencoder_config=TOPK, device="cpu",
               max_transcript_tokens=4, verbose=False)
    assert ttrainer.train(**cfg)["steps"] == 2
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    tags = set(acc.Tags()["tensors"])
    for i in range(ttrainer.N_TRANSCRIPTS):
        for kind in ("reconstructed", "base"):
            assert any(t.startswith(f"val/transcripts/{kind}_{i}") for t in tags), (kind, i)


# ------------------------------------------------------- entry points, CLI


def test_runtime_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        WhisperRuntime("test:tiny")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["--data_path", "."])


def test_unported_surfaces_raise(env):
    """A decoder layer is steered online (an identity tap changes nothing),
    never by a tensor substitution, which raises pointing to decoder_tap.
    The long-form surfaces answer (they raised until they were ported): a
    second of audio has one window, word timestamps give a word list a
    clip, and an empty text list aligns nothing."""
    rt = WhisperRuntime("test:tiny", "decoder.blocks.0", max_new_tokens=4, device="cpu")
    mels = torch.zeros(1, 80, 3000)
    assert rt.transcribe(mels, decoder_tap=(0, lambda p, x: x, None)) == rt.transcribe(mels)
    with pytest.raises(ValueError, match="decoder_tap"):
        rt.transcribe(mels, substitute_layer="decoder.blocks.0", substitute_value=mels)
    out = rt.transcribe_long(np.zeros(16000, np.float32), temperatures=(0.0,))
    assert set(out) == {"text", "segments", "language"}
    assert {s["seek"] for s in out["segments"]} <= {0}
    texts, words = rt.transcribe_with_word_timestamps(mels)
    assert len(texts) == len(words) == 1
    assert [len(x) for x in rt.align_words(rt.encode(mels), [])] == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="English-only"):
        WhisperRuntime("test:tiny.en", task="translate", device="cpu")
    with pytest.raises(ValueError):
        WhisperRuntime("test:tiny", task="summarize", device="cpu")


def test_cli_main(env, tmp_path, capsys):
    out = tmp_path / "out.json"
    tcli.main(["--data_path", str(env.audio), "--model", "tiny", "--batch_size", "2",
               "--max_new_tokens", "4", "--device", "cpu", "--language", "en",
               "--out", str(out)])
    result = json.loads(out.read_text())
    assert sorted(result) == sorted(str(p) for p in env.audio.iterdir())
    assert result[str(env.audio / "bad.wav")] == "<decode-failed>"
    # the subtitle formats need --long's timed segments (JAX's refusal)
    with pytest.raises(SystemExit):
        tcli.main(["--data_path", str(env.audio), "--device", "cpu",
                   "--output_format", "srt"])
    assert "needs the timed segments of --long" in capsys.readouterr().err
    # batch word timestamps and --output_format txt
    tcli.main(["--data_path", str(env.audio), "--model", "tiny", "--batch_size", "2",
               "--max_new_tokens", "4", "--device", "cpu", "--word_timestamps",
               "--output_format", "txt", "--output_dir", str(tmp_path / "txt"),
               "--out", str(out)])
    result = json.loads(out.read_text())
    assert set(result[str(env.audio / "a0.wav")]) == {"text", "words"}
    text = result[str(env.audio / "a0.wav")]["text"]
    assert (tmp_path / "txt" / "a0.txt").read_text() == text.strip() + "\n"


# --------------------------------------------------------------- long form


@pytest.fixture(scope="module")
def long_audio_dir(env):
    folder = env.root / "long"
    folder.mkdir()
    _write_wav(folder / "l20.wav", 20.0, 20)
    _write_wav(folder / "l45.wav", 45.0, 45)
    return folder


@pytest.fixture()
def t0_long(monkeypatch):
    """Both packages' seek loops at t = 0 with 8 history slots: the CLI and
    the server take transcribe_long's defaults, whose sampled rungs draw
    from different generators in the two packages."""
    import functools

    from freud_tpu.models.whisper import long_audio as jla
    from freud_tpu_torch.models.whisper import long_audio as tla

    for mod in (jla, tla):
        monkeypatch.setattr(mod, "transcribe_long", functools.partial(
            mod.transcribe_long, temperatures=(0.0,), history_budget=8))


def _json_close(got, want):
    """Equal structure, strings and ints; floats within 1e-4 (the decode's
    statistics are sums in another order)."""
    if isinstance(want, float):
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _json_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _json_close(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("fmt, extra", [
    ("txt", []), ("srt", ["--word_timestamps", "--max_line_width", "12"]),
    ("vtt", ["--word_timestamps", "--highlight_words"]), ("tsv", []),
    ("json", ["--word_timestamps"])])
def test_cli_long_output_formats_match_jax(env, long_audio_dir, t0_long, tmp_path,
                                           monkeypatch, fmt, extra):
    """``--long --output_format``: the txt, srt, vtt and tsv files are
    byte-identical to JAX's CLI's; the json file (and ``--out``) equal up to
    the statistics' float tolerance."""
    import sys

    from freud_tpu.scripts import transcribe as jcli

    args = ["--data_path", str(long_audio_dir), "--model", "tiny", "--long",
            "--max_new_tokens", "6", "--output_format", fmt, *extra]
    monkeypatch.setattr(sys, "argv", ["transcribe", *args, "--output_dir",
                                      str(tmp_path / "jax"), "--out", str(tmp_path / "j.json")])
    jcli.main()
    tcli.main([*args, "--device", "cpu", "--output_dir", str(tmp_path / "torch"),
               "--out", str(tmp_path / "t.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    _json_close(got, want)
    assert len(got[str(long_audio_dir / "l45.wav")]["segments"]) >= 2
    for stem in ("l20", "l45"):
        tfile = (tmp_path / "torch" / f"{stem}.{fmt}").read_text(encoding="utf-8")
        jfile = (tmp_path / "jax" / f"{stem}.{fmt}").read_text(encoding="utf-8")
        if fmt == "json":
            _json_close(json.loads(tfile), json.loads(jfile))
        else:
            assert tfile == jfile, stem


def test_transcribe_folder_long_decode_failed(env, tmp_path):
    from freud_tpu.scripts.transcribe import transcribe_folder_long as jax_long

    folder = tmp_path / "bad"
    folder.mkdir()
    (folder / "x.wav").write_bytes(b"RIFF, but not a wav file")
    kw = dict(model="tiny", max_new_tokens=MAX_NEW, verbose=False)
    assert tcli.transcribe_folder_long(str(folder), device="cpu", **kw) == \
        jax_long(str(folder), **kw) == {str(folder / "x.wav"): "<decode-failed>"}


def test_transcribe_folder_word_timestamps_matches_jax(env):
    """Batch ``word_timestamps`` at batch 3 (a padded tail batch): the same
    texts and words (times equal, probabilities within 1e-4); combined with
    beam search or the ladder it is refused, as in JAX."""
    kw = dict(model="tiny", batch_size=3, max_new_tokens=MAX_NEW, verbose=False,
              word_timestamps=True)
    want = jax_transcribe_folder(str(env.audio), **kw)
    got = tcli.transcribe_folder(str(env.audio), device="cpu", **kw)
    _json_close(got, want)
    assert got[str(env.audio / "bad.wav")] == "<decode-failed>"
    assert any(v["words"] for f, v in got.items() if not f.endswith("bad.wav"))
    for bad in (dict(beam_size=2), dict(fallback=True)):
        with pytest.raises(SystemExit, match="word_timestamps"):
            tcli.transcribe_folder(str(env.audio), device="cpu", **kw, **bad)
