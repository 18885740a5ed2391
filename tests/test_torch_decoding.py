"""freud_tpu_torch's Whisper text decoder and KV-cached decoding against
freud_tpu's, on the same weights (the JAX package's ``init_params`` carried
across by ``state_dict_from_jax``) and the same seeded encoded audio, at
``test:tiny`` geometry (d 384, 6 heads, 2 decoder layers, n_vocab 51,865,
448 positions), f32 on the CPU.

Tolerances: teacher-forced and KV-cached logits within 1e-4 of the
reference's max |logit|; ``_apply_rules`` with the same -inf pattern and
finite values within 1e-6; statistics (sum_logprob, no_speech_prob) within
1e-4 relative. Tokens are equal up to the first step whose JAX top-two
post-rules margin is under ``NEAR_TIE``, and every test asserts that no such
step comes before n_prompt + 8, so a flipped near-tie shows as a failure,
not a pass. Beam search is held token for token over the whole decode.
Sampled tokens differ from JAX's by construction (a torch.Generator, not
``fold_in``): they are held to the rules and to their own statistics. bf16
is held to the port's own f32 decode, as the JAX package's bf16 test holds
its own."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from freud_tpu.models.whisper import decoding as jdec
from freud_tpu.models.whisper import dims_for, init_params
from freud_tpu.models.whisper.model import decoder_forward as jax_decoder_forward
from freud_tpu.models.whisper.tokenizer import special_tokens
from freud_tpu_torch.models.whisper import decoding as tdec
from freud_tpu_torch.models.whisper import state_dict_from_jax
from freud_tpu_torch.models.whisper.load import decoder_from_state_dict
from freud_tpu_torch.models.whisper.model import decoder_forward

DIMS = dims_for("test:tiny")
ST = special_tokens(DIMS.n_vocab)
TS0 = ST.timestamp_begin
MAX_NEW = 12
NEAR_TIE = 1e-4
B = 3


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
def m():
    params = init_params(DIMS, seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    decoder = decoder_from_state_dict(state_dict_from_jax(np_params, DIMS), DIMS).eval()
    rng = np.random.default_rng(0)
    encoded = rng.standard_normal((B, 1500, DIMS.n_text_state)).astype(np.float32)
    seq = ST.sot_sequence(lang_index=0, timestamps=True)
    return SimpleNamespace(params=params, decoder=decoder, encoded=encoded,
                           prompt=np.tile(np.asarray(seq, np.int32), (B, 1)),
                           n_prompt=len(seq))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rule_state(row, n_prompt, p):
    """(token, prev, max_ts) that the decode carries into step ``p`` of a
    row decoded without ``start``."""
    max_ts = max([int(t) for t in row[n_prompt:p + 1] if t >= TS0], default=0)
    return int(row[p]), int(row[p - 1]) if p else 0, max_ts


def first_near_tie(params, encoded, tokens, n_prompt) -> int:
    """The first position whose token JAX chose by a top-two post-rules
    margin under NEAR_TIE (teacher-forced along ``tokens``), else the
    decode's length; rows stop at their first EOT."""
    tokens = np.asarray(tokens)
    logits, _ = jax_decoder_forward(params, DIMS, jnp.asarray(tokens), jnp.asarray(encoded))
    logits = np.asarray(logits)
    sup, blank = jdec._suppress_tables(DIMS)
    first = tokens.shape[1]
    for r, row in enumerate(tokens):
        for p in range(n_prompt - 1, tokens.shape[1] - 1):
            if p >= n_prompt and row[p] == ST.eot:
                break
            tok, prev, max_ts = _rule_state(row, n_prompt, p)
            ruled = np.asarray(jdec._apply_rules(
                jnp.asarray(logits[r, p][None]), jnp.asarray([tok]), jnp.asarray([prev]),
                jnp.asarray([max_ts]), p + 1 == n_prompt, ST, sup, blank,
                at_second=p + 1 == n_prompt + 1))[0]
            top2 = np.sort(ruled)[-2:]
            if np.isfinite(top2[0]) and top2[1] - top2[0] < NEAR_TIE:
                first = min(first, p + 1)
                break
    return first


def _assert_tokens_equal(got, want, params, encoded, n_prompt):
    upto = first_near_tie(params, encoded, want, n_prompt)
    assert upto >= n_prompt + 8, f"a JAX near-tie at position {upto}"
    np.testing.assert_array_equal(np.asarray(got)[:, :upto], np.asarray(want)[:, :upto])


# ---------------------------------------------------------------- logits


def test_teacher_forced_logits_match_jax(m):
    rng = np.random.default_rng(1)
    text = rng.integers(0, ST.eot, (B, 9))
    text[:, 0] = TS0 + 3
    tokens = np.concatenate([m.prompt, text], axis=1)
    want, _ = jax_decoder_forward(m.params, DIMS, jnp.asarray(tokens), jnp.asarray(m.encoded))
    with torch.inference_mode():
        got, caps = decoder_forward(m.decoder, DIMS, _t(tokens).long(), _t(m.encoded))
    assert got.shape == (B, tokens.shape[1], DIMS.n_vocab) and got.dtype == torch.float32
    assert caps == {}
    assert _rel(got, want) < 1e-4
    with pytest.raises(ValueError):
        decoder_forward(m.decoder, dims_for("test:base"), _t(tokens).long(), _t(m.encoded))


def test_kv_step_matches_teacher_forced(m):
    """The KV-cached step, fed the same tokens one position at a time, gives
    the teacher-forced rows (the port's and JAX's), with and without a
    left-crop ``start``; the step writes its K/V in place."""
    rng = np.random.default_rng(2)
    tokens = np.concatenate([m.prompt, rng.integers(0, ST.eot, (B, 7))], axis=1)
    t = tokens.shape[1]
    enc = _t(m.encoded)
    with torch.inference_mode():
        want, _ = decoder_forward(m.decoder, DIMS, _t(tokens).long(), enc)
        jwant, _ = jax_decoder_forward(m.params, DIMS, jnp.asarray(tokens), jnp.asarray(m.encoded))
        cross = tdec._cross_kv_stacks(m.decoder, DIMS, enc)
        self_k, self_v = tdec._self_kv(DIMS, B, t, torch.float32, enc.device)
        rows = []
        for p in range(t):
            pos = torch.tensor(p)
            rows.append(tdec._decode_step(m.decoder, DIMS, _t(tokens[:, p]).long(), pos,
                                          self_k, self_v, cross))
        got = torch.stack(rows, dim=1)
        assert bool(self_k[:, :, :, t - 1].abs().sum() > 0)
        assert _rel(got, want) < 1e-4 and _rel(got, jwant) < 1e-4
        # the same rows shifted right by `pad` inside a longer buffer,
        # left-cropped by start = pad
        pad = 3
        self_k, self_v = tdec._self_kv(DIMS, B, t + pad, torch.float32, enc.device)
        start = torch.full((B,), pad)
        shifted = np.concatenate([np.full((B, pad), ST.sot_prev), tokens], axis=1)
        for p in range(t + pad):
            row = tdec._decode_step(m.decoder, DIMS, _t(shifted[:, p]).long(),
                                    torch.tensor(p), self_k, self_v, cross, start=start)
            assert torch.isfinite(row).all()
            if p >= pad:
                assert _rel(row, want[:, p - pad]) < 1e-4


# ----------------------------------------------------------------- rules


def test_suppress_tables_match_jax():
    sup, blank = tdec._suppress_tables(DIMS)
    jsup, jblank = jdec._suppress_tables(DIMS)
    np.testing.assert_array_equal(sup.numpy(), np.asarray(jsup))
    np.testing.assert_array_equal(blank.numpy(), np.asarray(jblank))


_SUP = None


def _tables():
    global _SUP
    if _SUP is None:
        _SUP = (tdec._suppress_tables(DIMS), jdec._suppress_tables(DIMS))
    return _SUP


token_ids = hs.one_of(hs.integers(0, ST.eot - 1), hs.integers(TS0, DIMS.n_vocab - 1),
                      hs.just(ST.sot), hs.just(ST.eot))


@settings(max_examples=30, deadline=None)
@given(seed=hs.integers(0, 2 ** 32 - 1), scale=hs.sampled_from([0.1, 1.0, 5.0, 30.0]),
       rows=hs.lists(hs.tuples(token_ids, token_ids, hs.integers(0, DIMS.n_vocab - 1)),
                     min_size=1, max_size=4),
       at_first=hs.booleans(), at_second=hs.booleans(),
       ts_bias=hs.sampled_from([0.0, 8.0]))
def test_apply_rules_matches_jax(seed, scale, rows, at_first, at_second, ts_bias):
    """Hypothesis-drawn (logits, token, prev, max_ts, at_first, at_second):
    the same -inf pattern, finite values within 1e-6. ``ts_bias`` lifts the
    timestamp band so the timestamp-mass rule fires both ways."""
    (sup, blank), (jsup, jblank) = _tables()
    logits = (np.random.default_rng(seed).standard_normal((len(rows), DIMS.n_vocab))
              * scale).astype(np.float32)
    logits[:, TS0:] += ts_bias
    token, prev, max_ts = (np.asarray(c, np.int64) for c in zip(*rows))
    got = tdec._apply_rules(_t(logits), _t(token), _t(prev), _t(max_ts), at_first, ST,
                            sup, blank, at_second=at_second).numpy()
    want = np.asarray(jdec._apply_rules(
        jnp.asarray(logits), jnp.asarray(token, jnp.int32), jnp.asarray(prev, jnp.int32),
        jnp.asarray(max_ts, jnp.int32), at_first, ST, jsup, jblank, at_second=at_second))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def test_top_k_takes_lower_index_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, -0.0, 0.0, float("-inf")]])
    vals, idx = tdec._top_k(x, 8)
    assert idx.tolist() == [[1, 2, 4, 0, 6, 5, 3, 7]]  # XLA: -0.0 < +0.0
    jvals, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# ------------------------------------------------------- greedy and beam


def _jax_prompt_and_port(m, lang):
    prompt = m.prompt.copy()
    if lang == "detect":
        jl = np.asarray(jdec.detect_language(m.params, DIMS, jnp.asarray(m.encoded)))
        tl = tdec.detect_language(m.decoder, DIMS, _t(m.encoded)).numpy()
        np.testing.assert_array_equal(tl, jl)
        prompt[:, 1] = ST.lang_base + jl
    return prompt


@pytest.mark.parametrize("lang", ["en", "detect"])
def test_greedy_matches_jax(m, lang):
    prompt = _jax_prompt_and_port(m, lang)
    want = jdec.sample_decode(m.params, DIMS, jnp.asarray(m.encoded), jnp.asarray(prompt),
                              m.n_prompt, max_new=MAX_NEW)
    got = tdec.sample_decode(m.decoder, DIMS, _t(m.encoded), _t(prompt), m.n_prompt,
                             max_new=MAX_NEW)
    assert got[0].shape == (B, m.n_prompt + MAX_NEW)
    _assert_tokens_equal(got[0], want[0], m.params, m.encoded, m.n_prompt)
    if (got[0].numpy() == np.asarray(want[0])).all():
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-4)
    np.testing.assert_array_equal(
        tdec.greedy_decode(m.decoder, DIMS, _t(m.encoded), _t(prompt), m.n_prompt,
                           max_new=MAX_NEW).numpy(), got[0].numpy())


def test_greedy_with_left_padded_prompts_matches_jax(m):
    """``start``: each row's prompt begins ``start`` positions into a
    left-padded buffer (the conditioned-prompt mechanism)."""
    n_buf = m.n_prompt + 3
    start = np.array([3, 0, 1], np.int32)
    rng = np.random.default_rng(5)
    prompt = np.full((B, n_buf), ST.sot_prev, np.int32)
    for r in range(B):
        prompt[r, start[r]:start[r] + m.n_prompt] = m.prompt[r]
        prompt[r, start[r] + m.n_prompt:] = rng.integers(0, ST.eot, n_buf - start[r] - m.n_prompt)
    # a row's text beyond its SOT sequence is conditioning it continues from
    want = jdec.sample_decode(m.params, DIMS, jnp.asarray(m.encoded), jnp.asarray(prompt),
                              n_buf, max_new=MAX_NEW, start=jnp.asarray(start))
    got = tdec.sample_decode(m.decoder, DIMS, _t(m.encoded), _t(prompt), n_buf,
                             max_new=MAX_NEW, start=_t(start))
    # the near-tie rule on each row's cropped sequence
    wt = np.asarray(want[0])
    for r in range(B):
        upto = first_near_tie(m.params, m.encoded[r:r + 1], wt[r:r + 1, start[r]:],
                              n_buf - start[r])
        assert upto >= n_buf - start[r] + 8, (r, upto)
    np.testing.assert_array_equal(got[0].numpy(), wt)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_beam_one_equals_greedy(m):
    greedy = tdec.greedy_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                                max_new=MAX_NEW)
    tokens, sum_lp, n_text, nsp = tdec.beam_decode(
        m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt, max_new=MAX_NEW,
        beam_size=1)
    np.testing.assert_array_equal(tokens.numpy(), greedy.numpy())
    assert ((0.0 <= nsp) & (nsp <= 1.0)).all()


@pytest.mark.parametrize("beam", [3, 5])
def test_beam_matches_jax(m, beam):
    want = jdec.beam_decode(m.params, DIMS, jnp.asarray(m.encoded), jnp.asarray(m.prompt),
                            m.n_prompt, max_new=MAX_NEW, beam_size=beam)
    before = tdec.beam_decode.steps
    got = tdec.beam_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                           max_new=MAX_NEW, beam_size=beam)
    assert 0 < tdec.beam_decode.steps - before <= m.n_prompt + MAX_NEW - 1
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-4)


# ------------------------------------------------ scripted logits, exact ties

TEXT0 = 100


def _script(pos, token, n, xp):
    """Logits with exact ties: six text tokens and four timestamps tied, a
    token-dependent bonus that makes beams differ, and EOT first from
    position 7."""
    logits = xp.full((n, DIMS.n_vocab), -10.0, dtype=xp.float32)
    if xp is torch:
        logits[:, TEXT0:TEXT0 + 6] = 3.0
        logits[:, TS0 + 1:TS0 + 5] = 3.0
        logits[:, ST.eot] = torch.where(pos >= 7, 6.0, -10.0)
        logits[torch.arange(n), TEXT0 + token % 3] += 0.5
        return logits
    logits = logits.at[:, TEXT0:TEXT0 + 6].set(3.0)
    logits = logits.at[:, TS0 + 1:TS0 + 5].set(3.0)
    logits = logits.at[:, ST.eot].set(jnp.where(pos >= 7, 6.0, -10.0))
    return logits.at[jnp.arange(n), TEXT0 + token % 3].add(0.5)


@pytest.fixture()
def scripted(monkeypatch):
    def jax_stub(params, dims, token, pos, self_k, self_v, cross_kv, start=None, **tap):
        return _script(pos, token, token.shape[0], jnp), self_k, self_v

    def torch_stub(decoder, dims, token, pos, self_k, self_v, cross_kv, start=None,
                   vocab=None, **tap):
        return _script(pos, token, token.shape[0], torch)

    jdec._sample_decode_impl.clear_cache()
    jdec.beam_decode.clear_cache()
    monkeypatch.setattr(jdec, "_decode_step", jax_stub)
    monkeypatch.setattr(tdec, "_decode_step", torch_stub)
    yield
    jdec._sample_decode_impl.clear_cache()
    jdec.beam_decode.clear_cache()


@pytest.mark.parametrize("beam", [None, 2, 3])
def test_exact_ties_match_jax_bit_for_bit(m, scripted, beam):
    args = (DIMS, m.encoded[:2], m.prompt[:2], m.n_prompt)
    if beam is None:
        want = jdec.sample_decode(m.params, DIMS, jnp.asarray(args[1]), jnp.asarray(args[2]),
                                  m.n_prompt, max_new=MAX_NEW)
        got = tdec.sample_decode(m.decoder, DIMS, _t(args[1]), _t(args[2]), m.n_prompt,
                                 max_new=MAX_NEW)
    else:
        want = jdec.beam_decode(m.params, DIMS, jnp.asarray(args[1]), jnp.asarray(args[2]),
                                m.n_prompt, max_new=MAX_NEW, beam_size=beam)
        got = tdec.beam_decode(m.decoder, DIMS, _t(args[1]), _t(args[2]), m.n_prompt,
                               max_new=MAX_NEW, beam_size=beam)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    first = got[0].numpy()[:, m.n_prompt]
    assert ((TS0 + 1 <= first) & (first <= TS0 + 4)).all()  # a tied timestamp
    if beam is None:
        assert (first == TS0 + 1).all()  # greedy takes the lowest of them


def test_early_exit_equals_full_budget(m, scripted):
    """The scripted decode finishes at position 8 of a 224-token budget:
    early exit stops within EXIT_EVERY steps of it, with the same output."""
    before = tdec.sample_decode.steps
    fast = tdec.sample_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                              max_new=224)
    ran = tdec.sample_decode.steps - before
    full = tdec.sample_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                              max_new=224, early_exit=False)
    assert ran <= 8 + tdec.EXIT_EVERY
    assert tdec.sample_decode.steps - before - ran == m.n_prompt + 224 - 1
    for a, b in zip(fast, full):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (fast[0].numpy()[:, 8:] == ST.eot).all()


# --------------------------------------------------------------- sampling


def _replayed_logprob(decoder, encoded, tokens, n_prompt):
    """Σ post-rules log-probabilities of each row's sampled tokens through
    its first EOT, and its count of non-EOT tokens, replayed teacher-forced."""
    sup, blank = tdec._suppress_tables(DIMS)
    with torch.inference_mode():
        logits, _ = decoder_forward(decoder, DIMS, _t(tokens).long(), _t(encoded))
    sums, counts = [], []
    for r, row in enumerate(tokens):
        total, n = 0.0, 0
        for p in range(n_prompt - 1, len(row) - 1):
            tok, prev, max_ts = _rule_state(row, n_prompt, p)
            ruled = tdec._apply_rules(logits[r, p][None], torch.tensor([tok]),
                                      torch.tensor([prev]), torch.tensor([max_ts]),
                                      p + 1 == n_prompt, ST, sup, blank,
                                      at_second=p + 1 == n_prompt + 1)
            total += float(torch.log_softmax(ruled.double(), -1)[0, row[p + 1]])
            if row[p + 1] == ST.eot:
                break
            n += 1
        sums.append(total)
        counts.append(n)
    return np.array(sums), np.array(counts)


def _assert_rules(tokens, n_prompt):
    for row in tokens:
        gen = [int(t) for t in row[n_prompt:]]
        assert TS0 <= gen[0] <= TS0 + 50  # the first sampled token
        if ST.eot in gen:
            assert all(t == ST.eot for t in gen[gen.index(ST.eot):])
            gen = gen[:gen.index(ST.eot)]
        ts = [t for t in gen if t >= TS0]
        assert ts == sorted(ts)
        for banned in (ST.sot, ST.sot_prev, ST.no_speech, ST.no_timestamps,
                       ST.transcribe, ST.translate):
            assert banned not in gen
        for i in range(2, len(gen)):  # <ts><ts> is followed by text
            if gen[i - 1] >= TS0 and gen[i - 2] >= TS0:
                assert gen[i] < ST.eot


def test_sampled_decode_obeys_rules_and_statistics(m):
    g = torch.Generator().manual_seed(11)
    tokens, sum_lp, n_text, nsp = tdec.sample_decode(
        m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt, max_new=MAX_NEW,
        temperature=0.8, generator=g)
    tokens = tokens.numpy()
    _assert_rules(tokens, m.n_prompt)
    want_sum, want_n = _replayed_logprob(m.decoder, m.encoded, tokens, m.n_prompt)
    np.testing.assert_array_equal(n_text.numpy(), want_n)
    np.testing.assert_allclose(sum_lp.numpy(), want_sum, rtol=1e-4, atol=1e-4)
    assert ((0 <= nsp) & (nsp <= 1)).all()
    again = tdec.sample_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                               max_new=MAX_NEW, temperature=0.8,
                               generator=torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(again[0].numpy(), tokens)
    greedy = tdec.greedy_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                                max_new=MAX_NEW).numpy()
    assert (tokens != greedy).any()  # the temperature was applied
    _assert_rules(greedy, m.n_prompt)


# ------------------------------------------------------------------- bf16


def test_bf16_against_port_f32(m):
    enc = _t(m.encoded)
    f32 = tdec.sample_decode(m.decoder, DIMS, enc, _t(m.prompt), m.n_prompt, max_new=MAX_NEW)
    b16 = tdec.sample_decode(m.decoder, DIMS, enc, _t(m.prompt), m.n_prompt, max_new=MAX_NEW,
                             compute_dtype=torch.bfloat16)
    assert b16[1].dtype == b16[3].dtype == torch.float32
    assert torch.isfinite(b16[1]).all()
    agree = (b16[0] == f32[0]).float().mean().item()
    assert agree >= 0.75, agree
    _assert_rules(b16[0].numpy(), m.n_prompt)
    beam = tdec.beam_decode(m.decoder, DIMS, enc, _t(m.prompt), m.n_prompt, max_new=8,
                            beam_size=2, compute_dtype=torch.bfloat16)
    assert beam[0].shape == (B, m.n_prompt + 8) and torch.isfinite(beam[1]).all()
    with torch.inference_mode():
        tokens = _t(f32[0].numpy()).long()
        lf, _ = decoder_forward(m.decoder, DIMS, tokens, enc)
        lb, _ = decoder_forward(m.decoder, DIMS, tokens, enc, torch.bfloat16)
    assert lb.dtype == torch.float32 and _rel(lb, lf) < 5e-2
    assert m.decoder.token_embedding.weight.dtype == torch.float32  # not changed


def test_decoder_tap_raises(m):
    """A tap on a layer the decoder does not have raises, as JAX's does
    (tests/test_torch_steering.py holds the taps themselves)."""
    with pytest.raises(ValueError, match="out of range"):
        tdec.greedy_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                           max_new=4, decoder_tap=(DIMS.n_text_layer, lambda p, x: x, None))
    with pytest.raises(ValueError, match="positions"):
        tdec.greedy_decode(m.decoder, DIMS, _t(m.encoded), _t(m.prompt), m.n_prompt,
                           max_new=DIMS.n_text_ctx)
