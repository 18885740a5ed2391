"""Word timestamps: freud_tpu_torch's alignment pass, ``align_words``,
``transcribe_with_word_timestamps`` and the long-form loop's word lists
against freud_tpu's, on one set of weights (the JAX package's
``init_params`` at ``test:tiny`` geometry, a ``tiny.pt`` in
``$FREUD_WHISPER_DIR`` through ``state_dict_from_jax``), f32 on the CPU.

The alignment weights are held first, within 1e-5 of their max (the
teacher-forced next-token probabilities within 1e-5 relative), then the
words: text and start/end times equal (the times are DTW path indices
over 20-ms frames, so equal weights up to rounding give the same path;
both packages' ``timing`` is the same file), probabilities within 1e-5
relative. Where a near-tie in DTW could flip a path, JAX's ``timing`` fed
the port's weights gives the port's times: only the weights could differ.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.models.whisper import runtime as jruntime
from freud_tpu.models.whisper import timing as jtiming
from freud_tpu.models.whisper.config import dims_for as jax_dims_for
from freud_tpu.models.whisper.model import init_params
from freud_tpu_torch.models.whisper import dims_for, state_dict_from_jax
from freud_tpu_torch.models.whisper import runtime as truntime
from freud_tpu_torch.models.whisper import timing as ttiming

MAX_NEW = 8
W_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module: the tier-1 run puts several pytest
    workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("word_timestamps")
    dims = dims_for("test:tiny")
    params = init_params(jax_dims_for("test:tiny"), seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    torch.save({"dims": dataclasses.asdict(dims),
                "model_state_dict": state_dict_from_jax(np_params, dims)}, wdir / "tiny.pt")
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))
    jrt = jruntime.WhisperRuntime("tiny", max_new_tokens=MAX_NEW)
    trt = truntime.WhisperRuntime("tiny", max_new_tokens=MAX_NEW, device="cpu")
    mels = (np.random.default_rng(2).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    encoded = np.array(jrt.encode(mels))
    yield SimpleNamespace(wdir=wdir, dims=dims, jrt=jrt, trt=trt, mels=mels, encoded=encoded)
    mp.undo()


def _weights_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= W_TOL * np.abs(want).max()


def _probs_close(got, want):
    np.testing.assert_allclose(got, want, rtol=W_TOL, atol=0)


def _words_equal(got, want):
    assert [(w["word"], w["start"], w["end"]) for w in got] == \
        [(w["word"], w["start"], w["end"]) for w in want]
    _probs_close(np.array([w["probability"] for w in got]),
                 np.array([w["probability"] for w in want]))


def _row(env, n_text=5, lang=0):
    st = env.trt._st
    base = st.sot_sequence(lang_index=lang, timestamps=False)
    text = list(np.random.default_rng(1).integers(300, 5000, n_text))
    return base, [int(t) for t in text], st


def test_alignment_forward_matches_jax(env):
    """The curated planes (the upper half of the decoder layers without a
    table: layer 1's 6 heads) and the next-token probabilities of two
    teacher-forced rows."""
    base, text, st = _row(env)
    rows = np.array([base + text + [st.eot] * 3, base + text[::-1] + [st.eot] * 3])
    jw, jp = env.jrt._alignment_forward(jnp.asarray(rows.astype(np.int32)),
                                        jnp.asarray(env.encoded))
    tw, tp = env.trt._alignment_forward(torch.from_numpy(rows), torch.from_numpy(env.encoded))
    assert tw.shape == (2, 6, rows.shape[1], 1500)
    _weights_close(tw, jw)
    assert tp.shape == jp.shape == (2, rows.shape[1] - 1)
    _probs_close(tp, jp)


def test_align_words_matches_jax(env):
    """One window's clean notimestamps row, padded with EOT to the fixed
    length, with and without a trimmed frame count; an empty text list
    aligns nothing."""
    _, text, _ = _row(env, n_text=6)
    for enc, nf in ((env.encoded[:1], None), (env.encoded[1:], 600)):
        want = env.jrt.align_words(jnp.asarray(enc), text, num_frames=nf)
        got = env.trt.align_words(torch.from_numpy(enc), text, num_frames=nf)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        _probs_close(got[3], want[3])
    empty = env.trt.align_words(torch.from_numpy(env.encoded[:1]), [])
    assert [len(x) for x in empty] == [0, 0, 0, 0]


def test_word_times_depend_only_on_the_weights(env):
    """JAX's timing fed the port's alignment weights gives the port's
    times (the two ``timing`` files are one code)."""
    base, text, st = _row(env, n_text=7)
    row = np.array([base + text + [st.eot]])
    tw, _ = env.trt._alignment_forward(torch.from_numpy(row), torch.from_numpy(env.encoded[:1]))
    rows = list(range(len(base) - 1, len(base) + len(text)))
    for nf in (None, 900):
        got = ttiming.token_times(tw[0], rows, nf)
        want = jtiming.token_times(tw[0], rows, nf)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_transcribe_with_word_timestamps_matches_jax(env):
    for nf in (None, np.array([1500, 750])):
        want = env.jrt.transcribe_with_word_timestamps(env.mels, num_frames=nf)
        got = env.trt.transcribe_with_word_timestamps(torch.from_numpy(env.mels),
                                                      num_frames=nf)
        assert got[0] == want[0]
        assert len(got[1]) == 2 and any(got[1])
        for g, w in zip(got[1], want[1]):
            _words_equal(g, w)


def test_alignment_heads_table_mid_process(env):
    """A curated table that appears mid-process takes effect at the next
    call in both packages, and the planes stay equal."""
    base, text, st = _row(env)
    row = np.array([base + text + [st.eot]])
    table = env.wdir / "alignment_heads.json"
    table.write_text(json.dumps({"tiny": [[1, 0], [0, 3], [1, 5]]}))
    try:
        jw, _ = env.jrt._alignment_forward(jnp.asarray(row.astype(np.int32)),
                                           jnp.asarray(env.encoded[:1]))
        tw, _ = env.trt._alignment_forward(torch.from_numpy(row),
                                           torch.from_numpy(env.encoded[:1]))
    finally:
        table.unlink()
    assert tw.shape[1] == 3
    _weights_close(tw, jw)
    tw6, _ = env.trt._alignment_forward(torch.from_numpy(row), torch.from_numpy(env.encoded[:1]))
    assert tw6.shape[1] == 6


def test_bf16_runtime_aligns_in_f32(env):
    """A bf16 runtime's alignment pass runs f32 weights, as JAX's runs its
    f32 parameters: on the same (bf16-valued) encoded audio the two agree
    within the f32 bound."""
    jrt = jruntime.WhisperRuntime("tiny", max_new_tokens=MAX_NEW, compute_dtype=jnp.bfloat16)
    trt = truntime.WhisperRuntime("tiny", max_new_tokens=MAX_NEW, device="cpu",
                                  compute_dtype=torch.bfloat16)
    assert trt.decoder.token_embedding.weight.dtype == torch.bfloat16
    assert trt.align_decoder.token_embedding.weight.dtype == torch.float32
    enc = torch.from_numpy(env.encoded[:1]).to(torch.bfloat16)
    base, text, st = _row(env)
    row = np.array([base + text + [st.eot]])
    jw, jp = jrt._alignment_forward(jnp.asarray(row.astype(np.int32)),
                                    jnp.asarray(enc.float().numpy()).astype(jnp.bfloat16))
    tw, tp = trt._alignment_forward(torch.from_numpy(row), enc)
    _weights_close(tw, jw)
    _probs_close(tp, jp)


def test_long_form_words_match_jax(env):
    """The seek loop with word timestamps on 45 s at t = 0: every window's
    alignment pass, its words split per segment and shifted by the window's
    seek, and the word-informed seek."""
    audio = (np.random.default_rng(9).standard_normal(16000 * 45) * 0.1).astype(np.float32)
    kw = dict(temperatures=(0.0,), word_timestamps=True, history_budget=8)
    want = env.jrt.transcribe_long(audio, **kw)
    got = env.trt.transcribe_long(audio, **kw)
    assert [s["seek"] for s in got["segments"]] == [s["seek"] for s in want["segments"]]
    assert sum(len(s["words"]) for s in got["segments"]) > 0
    for g, w in zip(got["segments"], want["segments"]):
        assert (g["start"], g["end"], g["tokens"]) == (w["start"], w["end"], w["tokens"])
        _words_equal(g["words"], w["words"])
