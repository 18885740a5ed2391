"""Long-form transcription: freud_tpu_torch's ``long_audio`` and
``WhisperRuntime.transcribe_long`` against freud_tpu's, on one set of
weights (the JAX package's ``init_params`` at ``test:tiny`` geometry,
written as an OpenAI-layout ``tiny.pt`` in ``$FREUD_WHISPER_DIR`` through
``state_dict_from_jax``) and seeded numpy audio of 0.005, 20, 45 and 65 s,
f32 on the CPU.

Tolerances: ``full_log_mel`` within the log-mel gate (max |Δ| < 2e-3, and
fewer than 1e-5 of the bins off by more than 3e-4), across the 30-s chunk
seams of JAX's computation too; a left-padded prompt with ``start`` gives
the unpadded prompt's tokens, its statistics within 1e-5; ``transcribe_long``
at ``temperatures=(0.0,)``, greedy and beam 2: segments' ``seek``,
``start``, ``end``, ``tokens`` and ``text`` equal, ``avg_logprob``,
``compression_ratio`` and ``no_speech_prob`` within 1e-4. Sampled rungs
draw from a ``torch.Generator`` (JAX folds the rung into a PRNG key), so
the ladder's control flow is held with the decode scripted in both
packages, and real sampled runs by the rungs they take and by determinism
from the seed. Without tokenizer assets text renders as ``<tok:N>``, so
equal text is equal tokens."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.models.whisper import decoding as jdec
from freud_tpu.models.whisper import long_audio as jla
from freud_tpu.models.whisper import runtime as jruntime
from freud_tpu.models.whisper import tokenizer as jtok
from freud_tpu.models.whisper.config import dims_for as jax_dims_for
from freud_tpu.models.whisper.model import encoder_forward as jax_encoder_forward
from freud_tpu.models.whisper.model import init_params
from freud_tpu_torch.constants import N_SAMPLES
from freud_tpu_torch.models.whisper import decoding as tdec
from freud_tpu_torch.models.whisper import dims_for, state_dict_from_jax
from freud_tpu_torch.models.whisper import long_audio as tla
from freud_tpu_torch.models.whisper import runtime as truntime
from freud_tpu_torch.models.whisper import tokenizer as ttok
from freud_tpu_torch.models.whisper.load import decoder_from_state_dict

MAX_NEW = 6
T0 = (0.0,)
STAT_TOL = 1e-4
MEL_MAX, MEL_BIN, MEL_FRAC = 2e-3, 3e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module: the tier-1 run puts several pytest
    workers on one machine, and a full-width OpenMP pool in each would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("long_audio")
    dims = dims_for("test:tiny")
    params = init_params(jax_dims_for("test:tiny"), seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_jax(np_params, dims)
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": sd}, wdir / "tiny.pt")
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))
    yield SimpleNamespace(
        dims=dims, params=params, sd=sd,
        jrt=jruntime.WhisperRuntime("tiny", max_new_tokens=MAX_NEW),
        trt=truntime.WhisperRuntime("tiny", max_new_tokens=MAX_NEW, device="cpu"),
        a20=_audio(20, 20), a45=_audio(45, 45), a65=_audio(65, 65))
    mp.undo()


def assert_results_equal(got, want):
    """Segments equal in their exact fields, statistics within STAT_TOL."""
    assert got["language"] == want["language"]
    assert got["text"] == want["text"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert set(g) == set(w)
        for key in ("id", "seek", "start", "end", "tokens", "text", "temperature"):
            assert g[key] == w[key], (key, g[key], w[key])
        for key in ("avg_logprob", "compression_ratio", "no_speech_prob"):
            assert abs(g[key] - w[key]) < STAT_TOL, (key, g[key], w[key])
        for gw, ww in zip(g.get("words", []), w.get("words", [])):
            assert (gw["word"], gw["start"], gw["end"]) == (ww["word"], ww["start"], ww["end"])
            assert abs(gw["probability"] - ww["probability"]) <= 1e-5 * max(ww["probability"], 1e-30) + 1e-12
        assert len(g.get("words", [])) == len(w.get("words", []))


# ------------------------------------------------------------- full_log_mel


def _gate(got, want):
    d = np.abs(got - want)
    assert d.max() < MEL_MAX, d.max()
    assert (d > MEL_BIN).mean() < MEL_FRAC, (d > MEL_BIN).mean()


@pytest.mark.parametrize("seconds", [0.005, 20, 45, 65])
def test_full_log_mel_matches_jax(seconds):
    """The whole recording, within the log-mel gate; a 65-s recording has
    two of JAX's 30-s chunk seams (frames 3000 and 6000), held on their own
    too."""
    audio = _audio(seconds, 7)
    want = jla.full_log_mel(audio, 80)
    got = tla.full_log_mel(audio, 80).numpy()
    assert got.shape == want.shape == (80, (max(len(audio), 201) + N_SAMPLES) // 160)
    assert got.dtype == np.float32
    _gate(got, want)
    for seam in range(3000, want.shape[1], 3000):
        _gate(got[:, seam - 10:seam + 10], want[:, seam - 10:seam + 10])


def test_full_log_mel_block_size_does_not_matter(monkeypatch):
    """One 30-s window a ``framed_log10_mel`` call gives what blocks of 16
    give, within the gate (only the matmul blocking differs)."""
    audio = _audio(65, 8)
    blocked = tla.full_log_mel(audio, 128).numpy()
    monkeypatch.setattr(tla, "WINDOWS_PER_CALL", 1)
    _gate(tla.full_log_mel(audio, 128).numpy(), blocked)


# ------------------------------------------------- the left-padded prompt


def test_left_padded_prompt_with_start_equals_unpadded(env):
    """A left-padded prompt buffer with a start offset decodes as the
    unpadded prompt (pad positions masked, positions renumbered), in the
    port and in JAX, and the two packages agree."""
    dims, st = env.dims, ttok.special_tokens(env.dims.n_vocab)
    decoder = decoder_from_state_dict(env.sd, dims).eval()
    mels = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    encoded = np.array(jax_encoder_forward(env.params, jax_dims_for("test:tiny"),
                                             jnp.asarray(mels))[0])
    enc_t = torch.from_numpy(encoded)
    base = [st.sot_prev, 100, 101, st.sot, st.lang_base, st.transcribe]
    plain = np.tile(np.asarray(base, np.int64), (2, 1))
    pad_n = 5
    padded = np.tile(np.asarray([st.sot_prev] * pad_n + base, np.int64), (2, 1))
    start = np.full((2,), pad_n)
    with torch.inference_mode():
        tok_a, lp_a, nt_a, nsp_a = tdec.sample_decode(
            decoder, dims, enc_t, torch.from_numpy(plain), len(base), max_new=10,
            early_exit=False)
        steps = tdec.sample_decode.steps
        tok_b, lp_b, nt_b, nsp_b = tdec.sample_decode(
            decoder, dims, enc_t, torch.from_numpy(padded), len(base) + pad_n,
            max_new=10, start=torch.from_numpy(start), early_exit=False)
    # the step loop begins at min(start): the pad costs no step
    assert tdec.sample_decode.steps - steps == len(base) + 10 - 1
    np.testing.assert_array_equal(tok_a.numpy(), tok_b.numpy()[:, pad_n:])
    np.testing.assert_allclose(lp_a.numpy(), lp_b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nt_a.numpy(), nt_b.numpy())
    np.testing.assert_allclose(nsp_a.numpy(), nsp_b.numpy(), rtol=1e-5, atol=1e-7)
    jtok_b, jlp_b, jnt_b, jnsp_b = jdec.sample_decode(
        env.params, jax_dims_for("test:tiny"), jnp.asarray(encoded),
        jnp.asarray(padded.astype(np.int32)), len(base) + pad_n, max_new=10,
        start=jnp.asarray(start.astype(np.int32)))
    np.testing.assert_array_equal(tok_b.numpy(), np.asarray(jtok_b))
    np.testing.assert_allclose(lp_b.numpy(), np.asarray(jlp_b), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nt_b.numpy(), np.asarray(jnt_b))


# ------------------------------------------------------ the seek loop (t = 0)


@pytest.mark.parametrize("beam, budget", [(None, None), (2, 16)], ids=["greedy", "beam2"])
def test_transcribe_long_matches_jax(env, beam, budget):
    """45 s conditioned on the previous windows' text (the left-padded
    prompt buffer with ``start`` from the second window on: its full
    n_text_ctx − max_new slots greedy, 16 history slots with beam search),
    at t = 0."""
    kw = dict(temperatures=T0, beam_size=beam, history_budget=budget)
    want = env.jrt.transcribe_long(env.a45, **kw)
    got = env.trt.transcribe_long(env.a45, **kw)
    assert len(got["segments"]) >= 2
    assert_results_equal(got, want)


def test_options_match_jax(env, monkeypatch):
    """65 s restricted by ``clip_timestamps``; a budgeted history without
    conditioning on earlier text; and an initial prompt carried into every
    window (``encode_text`` monkeypatched in both packages: without
    tokenizer assets it encodes nothing)."""
    for kw in (dict(clip_timestamps="5,20,40,55", condition_on_previous_text=False),
               dict(clip_timestamps=[40.0], history_budget=3)):
        assert_results_equal(env.trt.transcribe_long(env.a65, temperatures=T0, **kw),
                             env.jrt.transcribe_long(env.a65, temperatures=T0, **kw))
    for mod in (jtok, ttok):
        monkeypatch.setattr(mod, "encode_text", lambda *a, **k: [701, 702, 703])
    for carry in (False, True):
        kw = dict(temperatures=T0, initial_prompt="seed words", carry_initial_prompt=carry,
                  history_budget=8)
        assert_results_equal(env.trt.transcribe_long(env.a20, **kw),
                             env.jrt.transcribe_long(env.a20, **kw))


def test_empty_audio_and_the_warning_match_jax(env):
    audio = _audio(0.005, 1)  # 80 samples: no content frame
    got = env.trt.transcribe_long(audio)
    assert got == env.jrt.transcribe_long(audio) == \
        {"text": "", "segments": [], "language": None}
    with pytest.warns(UserWarning, match="word_timestamps"):
        env.trt.transcribe_long(audio, hallucination_silence_threshold=2.0)


# ------------------------------------------------------------ the ladder


def _scripted(st, record):
    """A decode of one window per call: rungs below t = 0.6 fail the
    logprob gate, t = 0.6 and above pass; every window closes one segment
    at 15 s (a timestamp pair, no single ending: the seek advances 1500
    frames) whose text token names the rung."""
    ts0 = st.timestamp_begin

    def decode(prompt, n_prompt, temperature, max_new, start):
        row = [int(t) for t in np.asarray(prompt)[0]]
        record.append((temperature, row, None if start is None
                       else int(np.asarray(start).reshape(-1)[0])))
        gen = [ts0, 300 + int(temperature * 10), ts0 + 750, ts0 + 750]
        toks = row + gen + [st.eot] * (max_new - len(gen))
        slp = -0.5 if temperature >= 0.6 else -100.0
        return np.asarray([toks]), np.asarray([slp]), np.asarray([3.0]), np.asarray([0.0])
    return decode


def test_fallback_ladder_control_flow_matches_jax(env, monkeypatch):
    """The decode scripted in both packages: the same rungs are taken in the
    same order, every window passes the same prompt and ``start``, the
    history resets after a rung past 0.5 (so the next window is
    unconditioned), and the results are equal."""
    st = ttok.special_tokens(env.dims.n_vocab)
    records = {"jax": [], "torch": []}
    jfake = _scripted(st, records["jax"])
    tfake = _scripted(st, records["torch"])

    def jax_sample(params, dims, encoded, prompt, n_prompt, max_new=224,
                   temperature=0.0, key=None, start=None, compute_dtype=None):
        out = jfake(prompt, n_prompt, float(temperature), max_new, start)
        return tuple(jnp.asarray(a) for a in out)

    def torch_sample(decoder, dims, encoded, prompt, n_prompt, max_new=224,
                     temperature=0.0, generator=None, start=None, **kw):
        out = tfake(prompt.cpu(), n_prompt, float(temperature), max_new,
                    None if start is None else start.cpu())
        return tuple(torch.from_numpy(a) for a in out)

    monkeypatch.setattr(jdec, "sample_decode", jax_sample)
    monkeypatch.setattr(truntime, "sample_decode", torch_sample)
    ladder = (0.0, 0.2, 0.6, 1.0)
    want = env.jrt.transcribe_long(env.a45, temperatures=ladder)
    got = env.trt.transcribe_long(env.a45, temperatures=ladder)
    assert records["torch"] == records["jax"]
    temps = [t for t, _, _ in records["torch"]]
    assert temps == [0.0, 0.2, 0.6] * 3
    assert all(s is None for _, _, s in records["torch"])  # history reset each time
    assert [s["temperature"] for s in got["segments"]] == [0.6] * 3
    assert_results_equal(got, want)
    # permissive gates: t = 0 is taken at once, and the history conditions
    # the next window through the left-padded buffer
    records["jax"].clear()
    records["torch"].clear()
    kw = dict(temperatures=ladder, logprob_threshold=None)
    assert_results_equal(env.trt.transcribe_long(env.a45, **kw),
                         env.jrt.transcribe_long(env.a45, **kw))
    assert records["torch"] == records["jax"]
    assert [t for t, _, _ in records["torch"]] == [0.0] * 3
    assert records["torch"][1][2] is not None


def test_sampled_ladder_rungs_and_seed(env):
    """Real sampled rungs on 20 s: random weights fail the logprob gate on
    every rung, so both packages end every window on the last rung; the
    port's run repeats exactly from its seed."""
    ladder = (0.0, 0.5, 1.0)
    want = env.jrt.transcribe_long(env.a20, temperatures=ladder)
    got = env.trt.transcribe_long(env.a20, temperatures=ladder, seed=5)
    assert {s["temperature"] for s in got["segments"]} == \
        {s["temperature"] for s in want["segments"]} == {1.0}
    assert env.trt.transcribe_long(env.a20, temperatures=ladder, seed=5) == got
    for s in got["segments"]:
        assert s["avg_logprob"] < -1.0 and 0.0 <= s["no_speech_prob"] <= 1.0


# ------------------------------------------- the hallucination heuristics


def _scripted_window(st, gen_of_window, nsp_of_window=None, slp_of_window=None):
    """``_decode_window_with_fallback`` scripted per window, for either
    package (the JAX test's fakes)."""
    windows = []

    def fake(runtime, encoded, prompt, n_prompt, start, *a, **k):
        windows.append(len(windows))
        w = len(windows)
        base = [int(t) for t in np.asarray(prompt)[0]]
        gen = gen_of_window(w)
        row = base + gen + [st.eot] * (n_prompt + 8 - len(base) - len(gen))
        nsp = nsp_of_window(w) if nsp_of_window else 0.0
        slp = slp_of_window(w) if slp_of_window else -1.0
        return np.asarray([row]), slp, 3.0, nsp, 0.0, 1.0
    return fake


@pytest.mark.parametrize("case", ["surrounded", "leading_gap"])
def test_hallucination_silence_threshold_matches_jax(env, monkeypatch, case):
    """Scripted decode and alignment (random weights cannot be steered into
    an anomaly): an anomalous segment surrounded by silence is dropped; a
    leading anomaly after a gap longer than the threshold drops the window
    and seeks over the gap; without the threshold the segments stay. The
    port's results equal JAX's in each case."""
    st = ttok.special_tokens(env.dims.n_vocab)
    ts0 = st.timestamp_begin
    audio = np.zeros(int(16000 * 35), np.float32)
    if case == "surrounded":
        gens = lambda w: [ts0, 100, ts0 + 100, ts0 + 100] if w == 1 else []  # noqa: E731
        nsps = lambda w: 0.0 if w == 1 else 0.99  # noqa: E731
        slps = lambda w: -1.0 if w == 1 else -50.0  # noqa: E731
        times = (0.0, 3.0)
    else:
        gens, nsps, slps = (lambda w: [ts0 + 500, 100, ts0 + 650, ts0 + 650]), None, None
        times = (10.0, 13.0)

    def fake_align(encoded, text_tokens, lang_idx=0, num_frames=None):
        n = len(text_tokens)
        return (np.full(n, times[0]), np.full(n, times[1]),
                [f"<tok:{t}>" for t in text_tokens], np.full(n, 0.01))

    out = {}
    for name, la, rt in (("jax", jla, env.jrt), ("torch", tla, env.trt)):
        monkeypatch.setattr(rt, "align_words", fake_align)
        for thr in (None, 2.0):
            fake = _scripted_window(st, gens, nsps, slps)
            monkeypatch.setattr(la, "_decode_window_with_fallback", fake)
            out[name, thr] = rt.transcribe_long(
                audio, word_timestamps=True, condition_on_previous_text=False,
                hallucination_silence_threshold=thr)
    for thr in (None, 2.0):
        assert_results_equal(out["torch", thr], out["jax", thr])
    assert out["torch", None]["segments"]
    assert out["torch", 2.0]["segments"] == []
