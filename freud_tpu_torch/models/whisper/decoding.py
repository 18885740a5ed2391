"""KV-cached Whisper decoding with whisper's rules: greedy, sampled, beam.

The port of ``freud_tpu/models/whisper/decoding.py`` (without its probe-only
int8 K/V knob). Cross-attention K/V are computed from the encoded audio
once; self-attention K/V live in buffers preallocated at the decode's fixed
length ``ctx = n_prompt + max_new`` (≤ n_text_ctx) and are written in place
at each step; a Python loop of ``ctx - 1`` steps does prefill and
generation, post-EOT positions are EOT and every statistic freezes once a
row has finished. ``_decode_step`` takes its position as a device scalar and
reads nothing on the host, so a later change can capture it as a CUDA graph.

``sample_decode`` and ``greedy_decode`` take ``decoder_tap=(layer, fn,
fn_params)``, online steering of a decoder block: the step applies
``fn(fn_params, x)`` to the block's output at every position, before the
later blocks read it (``_decode_step``); the SAE taps are in
``analysis/features.py``. Beam search takes none, as in JAX.

Three decoders share the rules (SuppressTokens, SuppressBlank,
ApplyTimestampRules — ``_apply_rules``): ``greedy_decode``;
``sample_decode`` (a temperature, and the sum-logprob / length /
no-speech statistics whisper.transcribe's fallback ladder reads); and
``beam_decode``, whisper's BeamSearchDecoder in the JAX package's
fixed-shape formulation (the beams fold into the batch of the step).

Numerics follow the JAX package: q and k each scaled by dh^-¼ before the
product; attention scores and vocabulary logits are f32 products of the
compute-dtype operands (``model.attend``); the rules, the statistics and
the ranking run in f32. Two choices the JAX package did not need:

* ties: ``jax.lax.top_k`` and ``jnp.argmax`` take the lowest index among
  equal values. ``torch.argmax`` does too; ``torch.topk`` promises no order
  among ties, so beam search's top-k calls go through ``_top_k``, a
  ``torch.topk`` over int64 keys made unique by the index.
* sampling: JAX draws ``categorical(fold_in(key, pos), …)``, which torch
  cannot reproduce. Here a ``torch.Generator`` on the decode's device draws
  Gumbel noise (argmax of logits / t + Gumbel is a draw from
  softmax(logits / t)), so sampled tokens differ from JAX's by
  construction; the rules and the statistics are the same.

Beam search attends the (b·beam) queries to the (b, …) cross K/V planes
(clip j's beams are rows j·beam … j·beam + beam − 1), a broadcast where the
JAX package repeats the planes per beam (≈ 20 GB at large-v3, batch 8,
beam 5, f32).

A left-padded prompt (``start``) begins its step loop at the first
position any row reads, ``min(start)`` (``_pad_skip``): the positions
before it are masked out of every later step's attention, so skipping them
changes no output, and a long-form window's fixed prompt buffer costs only
the steps of its real prompt.

The early-exit test (``all(finished)``, or beam search's full pools) is a
device → host read, so it runs every ``EXIT_EVERY`` steps; the tokens and
statistics after a row finished are fixed by the contract, so the output is
the same as testing before every step. ``sample_decode.steps`` and
``beam_decode.steps`` count the steps run (plain integers, like the kernel
wrappers' launch counts).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import WhisperDims
from .model import (
    TextDecoder,
    attend,
    cast_module,
    decoder_forward,
    merge_heads,
    split_heads,
)
from .tokenizer import blank_token_id, special_tokens, suppress_token_ids

NEG_INF = float("-inf")
EXIT_EVERY = 8  # steps between early-exit tests (each a device → host read)

Tensors = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _unpack_tap(dims: WhisperDims, decoder_tap) -> tuple:
    """``decoder_tap`` → (tap_layer, tap_fn, tap_params), the layer checked
    here, once a decode: an out-of-range layer would make the tap a silent
    no-op (e.g. an SAE trained on decoder.blocks.5 served against a 4-layer
    model)."""
    tap_layer, tap_fn, tap_params = decoder_tap or (None, None, None)
    if tap_layer is not None and not (0 <= tap_layer < dims.n_text_layer):
        raise ValueError(
            f"decoder_tap layer {tap_layer} out of range for a model with "
            f"{dims.n_text_layer} decoder layers")
    return tap_layer, tap_fn, tap_params


def _cast_decode_inputs(decoder: TextDecoder, encoded: torch.Tensor,
                        compute_dtype: torch.dtype) -> tuple[TextDecoder, torch.Tensor]:
    """Serving precision: the decoder's weights (a cast copy when they
    differ) and ``encoded`` in ``compute_dtype``; the K/V buffers follow.
    Attention scores, vocabulary logits, rules and statistics stay f32."""
    return cast_module(decoder, compute_dtype), encoded.to(compute_dtype)


def precompute_cross_kv(decoder: TextDecoder, dims: WhisperDims,
                        encoded: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer cross-attention (k, v) of the encoded audio — computed once."""
    return [(b.cross_attn.key(encoded), b.cross_attn.value(encoded))
            for b in decoder.blocks]


def _cross_kv_stacks(decoder: TextDecoder, dims: WhisperDims,
                     encoded: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, v) stacks (L, b, h, s, dh) of the cross-attention planes, filled
    layer by layer: k already scaled by dh^-¼ (as the JAX step scales it)
    and held in f32 — the values of the compute dtype, so the score product
    is the f32 product of the compute-dtype operands with no per-step cast —
    and v in ``encoded``'s dtype."""
    heads = dims.n_text_head
    b, s, d = encoded.shape
    scale = (d // heads) ** -0.25
    shape = (len(decoder.blocks), b, heads, s, d // heads)
    k = torch.empty(shape, dtype=torch.float32, device=encoded.device)
    v = torch.empty(shape, dtype=encoded.dtype, device=encoded.device)
    for i, (ki, vi) in enumerate(precompute_cross_kv(decoder, dims, encoded)):
        k[i] = split_heads(ki * scale, heads)
        v[i] = split_heads(vi, heads)
    return k, v


def _self_kv(dims: WhisperDims, n: int, ctx: int, dtype: torch.dtype,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed self-attention buffers (L, n, h, ctx, dh): k (scaled) in f32,
    v in the compute dtype."""
    heads = dims.n_text_head
    shape = (dims.n_text_layer, n, heads, ctx, dims.n_text_state // heads)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _decode_step(decoder: TextDecoder, dims: WhisperDims, token: torch.Tensor,
                 pos: torch.Tensor, self_k: torch.Tensor, self_v: torch.Tensor,
                 cross_kv: tuple[torch.Tensor, torch.Tensor],
                 start: Optional[torch.Tensor] = None,
                 vocab: Optional[torch.Tensor] = None,
                 tap_layer: Optional[int] = None, tap_fn=None,
                 tap_params=None) -> torch.Tensor:
    """One decoder step at position ``pos`` (a 0-dim int64 tensor on the
    decode's device): (N,) tokens → (N, vocab) f32 logits. This position's
    self-attention k and v are written into ``self_k``/``self_v``
    ((L, N, h, ctx, dh), see ``_self_kv``) in place. ``cross_kv`` holds the
    (L, b, h, s, dh) planes of ``_cross_kv_stacks`` with b dividing N: the
    N / b consecutive rows of a clip (its beams) attend to that clip's
    planes. ``vocab`` is the f32 copy of the token embedding (made here when
    not given).

    ``start`` ((N,) int64, optional) left-crops each row's sequence: buffer
    positions < start are masked out of attention and the position
    embedding is taken at ``pos − start`` — one buffer shape serves every
    prompt length. A step may always attend to itself, also inside the pad
    region: a fully masked softmax row would be NaN and poison the next
    layers' K/V through 0·NaN.

    ``tap_layer``/``tap_fn``/``tap_params`` (optional): online steering.
    After block ``tap_layer`` adds its MLP residual, ``x ← tap_fn(tap_params,
    x)`` (x (N, 1, d), the result cast back to x's dtype), before the later
    blocks read x, so the tapped value enters their K/V buffers at this
    position — the step-by-step form of ``decoder_forward`` with the tapped
    block's output substituted. The tap must read nothing on the host."""
    heads = dims.n_text_head
    d = dims.n_text_state
    scale = (d // heads) ** -0.25
    n = token.shape[0]
    ctx = self_k.shape[-2]
    ck, cv = cross_kv
    b = ck.shape[1]
    cols = torch.arange(ctx, device=token.device)
    emb = decoder.token_embedding(token)
    if start is None:
        x = emb + decoder.positional_embedding.index_select(0, pos.view(1))
        keep = cols <= pos  # broadcasts to (N, h, 1, ctx)
    else:
        posn = (pos - start).clamp(min=0)
        x = emb + decoder.positional_embedding.index_select(0, posn)
        keep = ((cols[None, :] <= pos)
                & ((cols[None, :] >= start[:, None]) | (cols == pos))
                )[:, None, None, :]
    x = x[:, None, :]  # (N, 1, d)
    at = pos.view(1)
    for i, block in enumerate(decoder.blocks):
        a = block.attn
        h = block.attn_ln(x)
        q = split_heads(a.query(h), heads) * scale
        self_k[i].index_copy_(2, at, (split_heads(a.key(h), heads) * scale).float())
        self_v[i].index_copy_(2, at, split_heads(a.value(h), heads))
        x = x + a.out(merge_heads(attend(q, self_k[i], self_v[i], keep)))

        c = block.cross_attn
        h = block.cross_attn_ln(x)
        q = split_heads(c.query(h), heads) * scale  # (N, h, 1, dh)
        q = q.reshape(b, n // b, heads, d // heads).transpose(1, 2)  # (b, h, g, dh)
        o = attend(q, ck[i], cv[i]).transpose(1, 2).reshape(n, 1, d)
        x = x + c.out(o)

        x = x + block.mlp(block.mlp_ln(x))
        if tap_fn is not None and i == tap_layer:
            x = tap_fn(tap_params, x).to(x.dtype)
    x = decoder.ln(x)
    if vocab is None:
        vocab = decoder.token_embedding.weight.float()
    return torch.matmul(x[:, 0].float(), vocab.T)


def detect_language(decoder: TextDecoder, dims: WhisperDims, encoded: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(b,) language indices: one decoder step from <|sot|>, argmax over the
    language-token band (whisper's ``language=None`` detection)."""
    st = special_tokens(dims.n_vocab)
    with torch.inference_mode():
        dec, encoded = _cast_decode_inputs(decoder, encoded, compute_dtype)
        cross_kv = _cross_kv_stacks(dec, dims, encoded)
        b, dev = encoded.shape[0], encoded.device
        self_k, self_v = _self_kv(dims, b, 1, encoded.dtype, dev)
        token = torch.full((b,), st.sot, dtype=torch.int64, device=dev)
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        logits = _decode_step(dec, dims, token, pos, self_k, self_v, cross_kv)
        return logits[:, st.lang_base:st.lang_base + st.n_langs].argmax(dim=-1)


def _suppress_tables(dims: WhisperDims, device: torch.device | str = "cpu"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(suppress, suppress_blank) additive (-inf) vocabulary rows.

    Whisper's default suppression (the non-speech list when the BPE assets
    exist, plus the task and SOT specials) with <|notimestamps|> added
    (ApplyTimestampRules); SuppressBlank masks " " and EOT at the first
    sampled position only."""
    st = special_tokens(dims.n_vocab)
    sup = np.zeros((dims.n_vocab,), np.float32)
    sup[list(suppress_token_ids(dims.n_vocab))] = -np.inf
    sup[st.no_timestamps] = -np.inf
    blank_row = np.zeros((dims.n_vocab,), np.float32)
    blank = blank_token_id(dims.n_vocab)
    if blank is not None:
        blank_row[blank] = -np.inf
    blank_row[st.eot] = -np.inf
    return (torch.from_numpy(sup).to(device), torch.from_numpy(blank_row).to(device))


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """log_softmax over the last axis as x − logsumexp(x): within 1e-7 of
    f64 on a vocabulary row, where ``torch.log_softmax``'s CPU kernel is
    ~3e-5 off (measured on 51,865-wide rows), enough to reorder
    near-equal beam scores against the JAX package's."""
    return x - torch.logsumexp(x, dim=-1, keepdim=True)


def _apply_rules(logits: torch.Tensor, token: torch.Tensor, prev: torch.Tensor,
                 max_ts: torch.Tensor, at_first, st, suppress: torch.Tensor,
                 suppress_blank: torch.Tensor, at_second=False) -> torch.Tensor:
    """whisper's SuppressTokens + SuppressBlank + ApplyTimestampRules on a
    flat (N, vocab) f32 logits block; ``token``/``prev``/``max_ts`` are
    (N,), ``at_first``/``at_second`` bools or 0-dim bool tensors."""
    dev = logits.device
    ts0 = st.timestamp_begin
    vocab_ids = torch.arange(logits.shape[-1], device=dev)
    is_ts = vocab_ids >= ts0
    max_initial = ts0 + 50  # max_initial_timestamp 1.0 s → 50 frames
    at_first = torch.as_tensor(at_first, device=dev)
    at_second = torch.as_tensor(at_second, device=dev)

    logits = logits + suppress
    last_was_ts = (token >= ts0)[:, None]
    # penultimate_was_timestamp is TRUE while fewer than two tokens were
    # sampled: after the forced initial timestamp comes text, not a second
    # timestamp
    penult_was_ts = (prev >= ts0)[:, None] | at_second
    logits = torch.where(at_first, logits + suppress_blank, logits)
    # paired timestamps: <ts> <ts> → text next; a lone <ts> → ts or eot next
    text_mask = ~is_ts & (vocab_ids != st.eot)
    logits = logits.masked_fill(last_was_ts & penult_was_ts & is_ts, NEG_INF)
    open_seg = last_was_ts & ~penult_was_ts
    logits = logits.masked_fill(open_seg & text_mask, NEG_INF)
    # monotonic timestamps: ≥ the last one while its segment is open,
    # strictly greater once it closed (no zero-length segments)
    no_ts_yet = (max_ts < ts0)[:, None]
    min_allowed = torch.where(
        no_ts_yet, ts0, torch.where(open_seg, max_ts[:, None], max_ts[:, None] + 1))
    logits = logits.masked_fill(is_ts & (vocab_ids < min_allowed), NEG_INF)
    # the first sampled token is a timestamp, at most max_initial
    logits = logits.masked_fill(at_first & ~is_ts, NEG_INF)
    logits = logits.masked_fill(at_first & (vocab_ids > max_initial), NEG_INF)
    # timestamp mass above the best text token forces a timestamp
    logprobs = _log_softmax(logits)
    ts_mass = torch.logsumexp(logprobs.masked_fill(~is_ts, NEG_INF), dim=-1)
    max_text = logprobs.masked_fill(is_ts, NEG_INF).amax(dim=-1)
    force_ts = (ts_mass > max_text)[:, None]
    return logits.masked_fill(force_ts & ~is_ts, NEG_INF)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis of f32 ``x``: the k largest values,
    descending, equal values by lower index first (and -0.0 below +0.0, as
    XLA's total order has it), on every device. One ``torch.topk`` over
    int64 keys that cannot tie: the value's order-preserving bits (the sign
    flips the rest) above, the complemented index below."""
    bits = x.view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(x.shape[-1], device=x.device)
    _, pick = torch.topk(bits * (1 << 32) + ((1 << 32) - 1 - idx), k, dim=-1)
    return x.gather(-1, pick), pick


def _pad_skip(prompt: torch.Tensor, start: Optional[torch.Tensor], ts0: int
              ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """Where a decode's step loop begins: ``s0 = min(start)`` (0 without
    ``start``). → (s0, the token before position s0 (zeros at s0 = 0), the
    largest timestamp token among prompt positions 1..s0 (0 for none)), the
    state the loop would hold after stepping through positions < s0, whose
    K/V no later step reads (they are below every row's ``start``)."""
    b = prompt.shape[0]
    s0 = 0 if start is None else int(torch.as_tensor(start).min())
    zeros = torch.zeros((b,), dtype=torch.int64, device=prompt.device)
    if s0 == 0:
        return 0, zeros, zeros
    forced = prompt[:, 1:s0 + 1]
    max_ts = torch.where(forced >= ts0, forced, 0).amax(dim=1)
    return s0, prompt[:, s0 - 1].clone(), max_ts


def _prepare(decoder, dims, encoded, prompt, n_prompt, max_new, compute_dtype):
    if n_prompt + max_new > dims.n_text_ctx:
        raise ValueError(
            f"n_prompt + max_new = {n_prompt + max_new} exceeds the decoder's "
            f"{dims.n_text_ctx} positions")
    dec, encoded = _cast_decode_inputs(decoder, encoded, compute_dtype)
    dev = encoded.device
    return (dec, encoded, _cross_kv_stacks(dec, dims, encoded),
            _suppress_tables(dims, dev), dec.token_embedding.weight.float(),
            torch.as_tensor(prompt).to(dev, torch.int64))


def sample_decode(
    decoder: TextDecoder,
    dims: WhisperDims,
    encoded: torch.Tensor,
    prompt: torch.Tensor,  # (b, n_prompt) token ids
    n_prompt: int,
    max_new: int = 224,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    start: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
    early_exit: bool = True,
    decoder_tap: tuple | None = None,
) -> Tensors:
    """Decode token ids, greedy at ``temperature`` 0, else sampled from
    softmax(post-rules logits / temperature) with Gumbel noise from
    ``generator`` (a ``torch.Generator`` on ``encoded``'s device; seeded 0
    when not given).

    → ``(tokens (b, n_prompt + max_new) int64 EOT-padded, sum_logprob (b,),
    n_text (b,), no_speech_prob (b,))`` on ``encoded``'s device, as the JAX
    package defines them: sum_logprob adds the post-rules log-probability
    of every sampled token up to and including the first EOT, n_text
    counts the sampled non-EOT tokens (whisper's avg_logprob is
    sum_logprob / (n_text + 1)), no_speech_prob is the raw-logits softmax
    mass of <|nospeech|> at the SOT step. ``start`` ((b,) int, optional)
    marks where each row's prompt begins inside a left-padded prompt (see
    ``_decode_step``). ``early_exit=False`` runs the whole budget; the
    output is the same. ``decoder_tap=(layer_idx, fn, fn_params)`` applies
    ``fn(fn_params, x)`` to block ``layer_idx``'s output at every position,
    online (see ``_decode_step``); ``fn_params`` holds device tensors, read
    afresh at every step."""
    tap_layer, tap_fn, tap_params = _unpack_tap(dims, decoder_tap)
    st = special_tokens(dims.n_vocab)
    b = encoded.shape[0]
    ctx = n_prompt + max_new
    sampling = float(temperature) > 0.0
    with torch.inference_mode():
        dec, encoded, cross_kv, (suppress, suppress_blank), vocab, prompt = _prepare(
            decoder, dims, encoded, prompt, n_prompt, max_new, compute_dtype)
        dev = encoded.device
        if sampling and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if start is not None:
            start = torch.as_tensor(start).to(dev, torch.int64)
        self_k, self_v = _self_kv(dims, b, ctx, encoded.dtype, dev)
        s0, prev, max_ts = _pad_skip(prompt, start, st.timestamp_begin)
        tokens = torch.full((b, ctx), st.eot, dtype=torch.int64, device=dev)
        tokens[:, :s0 + 1] = prompt[:, :s0 + 1]
        token = prompt[:, s0].clone()
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        sum_lp = torch.zeros((b,), dtype=torch.float32, device=dev)
        n_text = torch.zeros((b,), dtype=torch.int32, device=dev)
        nsp = torch.zeros((b,), dtype=torch.float32, device=dev)
        pos = torch.full((), s0, dtype=torch.int64, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        for step in range(s0, ctx - 1):
            if early_exit and step % EXIT_EVERY == 0 and step and bool(finished.all()):
                break
            sample_decode.steps += 1
            logits = _decode_step(dec, dims, token, pos, self_k, self_v, cross_kv,
                                  start=start, vocab=vocab, tap_layer=tap_layer,
                                  tap_fn=tap_fn, tap_params=tap_params)
            # no_speech from the RAW logits at the SOT step (keyed on the
            # token: a conditioned prompt puts SOT after its history)
            nsp = torch.where(token == st.sot,
                              torch.softmax(logits, dim=-1)[:, st.no_speech], nsp)
            nxt = pos + 1
            logits = _apply_rules(logits, token, prev, max_ts, nxt == n_prompt, st,
                                  suppress, suppress_blank, at_second=nxt == n_prompt + 1)
            if sampling:
                u = torch.rand(logits.shape, generator=generator, device=dev)
                gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
                chosen = (logits / float(temperature) + gumbel).argmax(dim=-1)
            else:
                chosen = logits.argmax(dim=-1)
            is_prompt = nxt < n_prompt
            forced = prompt.index_select(1, nxt.clamp(max=n_prompt - 1).view(1))[:, 0]
            next_tok = torch.where(is_prompt, forced, chosen).masked_fill(finished, st.eot)
            # whisper's sum_logprobs: log_softmax of the post-rules logits
            # of each freely sampled token while alive, the EOT included
            tok_lp = _log_softmax(logits).gather(1, next_tok[:, None])[:, 0]
            live = ~finished & ~is_prompt
            sum_lp = sum_lp + torch.where(live, tok_lp, 0.0)
            n_text = n_text + (live & (next_tok != st.eot)).int()
            finished = finished | ((next_tok == st.eot) & ~is_prompt)
            max_ts = torch.where((next_tok >= st.timestamp_begin) & ~finished,
                                 torch.maximum(max_ts, next_tok), max_ts)
            prev, token = token, next_tok
            tokens.index_copy_(1, nxt.view(1), next_tok[:, None])
            pos += 1
    return tokens, sum_lp, n_text, nsp


sample_decode.steps = 0


def greedy_decode(
    decoder: TextDecoder,
    dims: WhisperDims,
    encoded: torch.Tensor,
    prompt: torch.Tensor,
    n_prompt: int,
    max_new: int = 224,
    compute_dtype: torch.dtype = torch.float32,
    decoder_tap: tuple | None = None,
) -> torch.Tensor:
    """Greedy-decode token ids: (b, n_prompt + max_new), EOT-padded;
    ``decoder_tap`` as in ``sample_decode``."""
    return sample_decode(decoder, dims, encoded, prompt, n_prompt, max_new,
                         compute_dtype=compute_dtype, decoder_tap=decoder_tap)[0]


def beam_decode(
    decoder: TextDecoder,
    dims: WhisperDims,
    encoded: torch.Tensor,
    prompt: torch.Tensor,
    n_prompt: int,
    max_new: int = 224,
    beam_size: int = 5,
    start: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Tensors:
    """Batched beam search, whisper's BeamSearchDecoder semantics in the JAX
    package's fixed-shape formulation.

    Each step takes the top 2·beam of the (beam × vocab) continuations,
    routes accepted EOT-ending candidates into a finished pool of ``beam``
    slots (first come, kept by monotone insertion keys, so a full pool
    never changes), refills all ``beam`` live slots from the non-EOT
    candidates, and reorders the self-attention buffers and histories by
    parent. A candidate past its parent's (beam+1)-th is invisible (whisper
    takes each parent's top beam+1), and an EOT candidate is accepted only
    while fewer than ``beam`` live candidates rank before it. The result is
    whisper's MaximumLikelihoodRanker (length_penalty None): the best
    sum_logprob / n_text of the finished pool, with the best live beams
    filling it up when fewer than ``beam`` finished. ``start`` as in
    ``sample_decode``. → ``(tokens, sum_logprob, n_text, no_speech_prob)``
    of the winners."""
    st = special_tokens(dims.n_vocab)
    b = encoded.shape[0]
    bs = beam_size
    vsz = dims.n_vocab
    ctx = n_prompt + max_new
    eot, ts0 = st.eot, st.timestamp_begin
    with torch.inference_mode():
        dec, encoded, cross_kv, (suppress, suppress_blank), vocab, prompt = _prepare(
            decoder, dims, encoded, prompt, n_prompt, max_new, compute_dtype)
        dev = encoded.device
        start_rep = (None if start is None else
                     torch.as_tensor(start).to(dev, torch.int64).repeat_interleave(bs))
        self_k, self_v = _self_kv(dims, b * bs, ctx, encoded.dtype, dev)
        i64 = dict(dtype=torch.int64, device=dev)
        beam_iota = torch.arange(bs, device=dev).expand(b, bs)
        rank = torch.arange(2 * bs, device=dev)
        row_base = (torch.arange(b, device=dev) * bs)[:, None]

        def gather_beam(t, idx):  # (b, n, …) by (b, k) indices along axis 1
            return torch.take_along_dim(t, idx.view(*idx.shape, *[1] * (t.ndim - 2)), dim=1)

        s0, prev, max_ts = _pad_skip(prompt, start, ts0)
        token = prompt[:, s0:s0 + 1].expand(b, bs).clone()
        prev = prev[:, None].expand(b, bs).clone()
        max_ts = max_ts[:, None].expand(b, bs).clone()
        cum = torch.where(beam_iota == 0, 0.0, NEG_INF).to(torch.float32)
        n_text = torch.zeros((b, bs), dtype=torch.int32, device=dev)
        seq = torch.full((b, bs, ctx), eot, **i64)
        seq[:, :, :s0 + 1] = prompt[:, None, :s0 + 1]
        fin_key = torch.full((b, bs), float("inf"), device=dev)
        fin_score = torch.full((b, bs), NEG_INF, device=dev)
        fin_ntext = torch.zeros((b, bs), dtype=torch.int32, device=dev)
        fin_seq = torch.full((b, bs, ctx), eot, **i64)
        nsp = torch.zeros((b,), dtype=torch.float32, device=dev)
        pos = torch.full((), s0, **i64)
        for step in range(s0, ctx - 1):
            if (step % EXIT_EVERY == 0 and step
                    and bool((torch.isfinite(fin_key).sum(dim=1) == bs).all())):
                break  # every pool is full: the result cannot change
            beam_decode.steps += 1
            logits = _decode_step(dec, dims, token.reshape(-1), pos, self_k, self_v,
                                  cross_kv, start=start_rep, vocab=vocab)
            # the SOT step's <|nospeech|> mass, raw logits; every beam is
            # the same during the prompt, so beam 0 stands for the clip
            logits0 = logits.view(b, bs, vsz)[:, 0]
            nsp = torch.where(token[:, 0] == st.sot,
                              torch.softmax(logits0, dim=-1)[:, st.no_speech], nsp)
            nxt = pos + 1
            logits = _apply_rules(logits, token.reshape(-1), prev.reshape(-1),
                                  max_ts.reshape(-1), nxt == n_prompt, st, suppress,
                                  suppress_blank, at_second=nxt == n_prompt + 1)
            cand = cum[..., None] + _log_softmax(logits).view(b, bs, vsz)

            vals2, idx2 = _top_k(cand.view(b, bs * vsz), 2 * bs)
            par2, tok2 = idx2 // vsz, idx2 % vsz
            is_eot = tok2 == eot
            same_parent = par2[:, :, None] == par2[:, None, :]
            occ = (same_parent & (rank[None, None, :] <= rank[None, :, None])).sum(dim=-1)
            visible = occ <= bs + 1
            live_cand = visible & ~is_eot
            live_before = live_cand.int().cumsum(dim=1) - live_cand.int()
            top_val, pick = _top_k(vals2.masked_fill(~live_cand, NEG_INF), bs)
            parent = par2.gather(1, pick)
            new_tok = tok2.gather(1, pick)

            is_prompt = nxt < n_prompt
            parent = torch.where(is_prompt, beam_iota, parent)
            forced = prompt.index_select(1, nxt.clamp(max=n_prompt - 1).view(1))
            new_tok = torch.where(is_prompt, forced.expand(b, bs), new_tok)
            new_cum = torch.where(is_prompt, cum, top_val)

            # the finished pool: first come in candidate-rank order, kept by
            # monotone insertion keys (a full pool never admits a later one)
            accepted = is_eot & visible & (live_before < bs) & ~is_prompt
            cand_key = torch.where(accepted, pos.float() * (2 * bs) + rank,
                                   float("inf"))
            all_keys = torch.cat([fin_key, cand_key], dim=1)
            all_scores = torch.cat([fin_score, vals2.masked_fill(~accepted, NEG_INF)], dim=1)
            all_ntext = torch.cat([fin_ntext, n_text.gather(1, par2)], dim=1)
            all_seq = torch.cat([fin_seq, gather_beam(seq, par2)], dim=1)
            neg_keys, keep = _top_k(-all_keys, bs)
            fin_key = -neg_keys
            fin_score = all_scores.gather(1, keep)
            fin_ntext = all_ntext.gather(1, keep)
            fin_seq = gather_beam(all_seq, keep)

            # the live beams follow their parents
            prev = token.gather(1, parent)
            max_ts = max_ts.gather(1, parent)
            n_text = n_text.gather(1, parent)
            seq = gather_beam(seq, parent)
            if step + 1 >= n_prompt:  # in the prompt every parent is itself
                flat = (parent + row_base).reshape(-1)
                self_k.copy_(self_k.index_select(1, flat))
                self_v.copy_(self_v.index_select(1, flat))
            n_text = n_text + (~is_prompt).int()  # live picks are not EOT
            max_ts = torch.where(new_tok >= ts0, torch.maximum(max_ts, new_tok), max_ts)
            seq.index_copy_(2, nxt.view(1), new_tok[:, :, None])
            token, cum = new_tok, new_cum
            pos += 1

        # MaximumLikelihoodRanker, length_penalty None: sum_logprob / length;
        # with n finished, the best (beam − n) live beams join the ranking
        valid = torch.isfinite(fin_key)
        n_fin = valid.sum(dim=1, keepdim=True)
        live_ok = beam_iota < (bs - n_fin)
        live_score = torch.where(live_ok, cum / n_text.float().clamp(min=1.0), NEG_INF)
        fin_avg = torch.where(valid, fin_score / fin_ntext.float().clamp(min=1.0), NEG_INF)
        best = torch.cat([fin_avg, live_score], dim=1).argmax(dim=1, keepdim=True)
        tokens = gather_beam(torch.cat([fin_seq, seq], dim=1), best)[:, 0]
        sum_lp = torch.cat([fin_score, cum], dim=1).gather(1, best)[:, 0]
        n_best = torch.cat([fin_ntext, n_text], dim=1).gather(1, best)[:, 0]
    return tokens, sum_lp, n_best, nsp


beam_decode.steps = 0


def decision_margins(decoder: TextDecoder, dims: WhisperDims, encoded: torch.Tensor,
                     tokens: torch.Tensor, n_prompt: int,
                     compute_dtype: torch.dtype = torch.float32,
                     decoder_tap: tuple | None = None) -> np.ndarray:
    """(b, T) top-two margins of the post-rules logits that chose each
    token of decoded rows (teacher-forced along ``tokens``, rows decoded
    without ``start``); inf at the prompt's positions, after a row's first
    EOT and where only one token was allowed. Where two decodes of the same
    rows (two devices, two packages) first differ, a small margin says the
    flip was a near-tie, not a fault. With ``decoder_tap`` the rows were
    steered: the margins are those of the teacher-forced oracle, the tapped
    block's output substituted back."""
    st = special_tokens(dims.n_vocab)
    with torch.inference_mode():
        tokens = torch.as_tensor(tokens).to(encoded.device, torch.int64)
        args = (decoder, dims, tokens, encoded, compute_dtype)
        substitute = None
        if decoder_tap is not None:
            layer, fn, fn_params = _unpack_tap(dims, decoder_tap)
            name = f"decoder.blocks.{layer}"
            _, caps = decoder_forward(*args, capture=(name,))
            substitute = {name: fn(fn_params, caps[name])}
        logits, _ = decoder_forward(*args, substitute=substitute)
        suppress, blank = _suppress_tables(dims, encoded.device)
        rows = tokens.cpu().numpy()
        out = np.full(rows.shape, np.inf)
        for r, row in enumerate(rows):
            max_ts = 0
            for p in range(n_prompt - 1, rows.shape[1] - 1):
                if p >= n_prompt:
                    if row[p] == st.eot:
                        break
                    if row[p] >= st.timestamp_begin:
                        max_ts = max(max_ts, int(row[p]))
                prev = int(row[p - 1]) if p else 0
                ruled = _apply_rules(
                    logits[r, p][None], tokens[r, p:p + 1],
                    torch.tensor([prev], device=encoded.device),
                    torch.tensor([max_ts], device=encoded.device), p + 1 == n_prompt, st,
                    suppress, blank, at_second=p + 1 == n_prompt + 1)
                top2 = ruled[0].topk(2).values.double().cpu().numpy()
                out[r, p + 1] = top2[0] - top2[1] if np.isfinite(top2[1]) else np.inf
    return out
