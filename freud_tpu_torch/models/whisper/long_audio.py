"""Arbitrary-length transcription: whisper.transcribe's 30-s seek loop.

The port of ``freud_tpu/models/whisper/long_audio.py``:

* ``full_log_mel`` — the log-mel of the WHOLE recording, on the runtime's
  device. whisper computes one STFT over audio + 30 s of trailing zeros and
  floors the dynamic range against the GLOBAL max. The stream (a 200-sample
  reflection at the real start, the audio, the zero tail) is framed once as
  a strided view, so every frame sees its true neighbour samples, and the
  frames go through ``audio/mel.py::framed_log10_mel`` in blocks of
  ``WINDOWS_PER_CALL`` 30-s windows; the floor and the ``(x + 4) / 4``
  affine follow over the whole recording. This is not the log-mel kernel
  (#1): that kernel floors per clip and reflects each clip's own edges.
  f32 on the card means f32: the runtime pins TF32 off.
* ``transcribe_long`` — the seek loop: encode a (1, n_mels, 3000) window,
  decode it through the temperature ladder, split the tokens on consecutive
  timestamp pairs into segments, advance ``seek`` (in mel frames) to the
  last closed timestamp or over the whole window, repeat; with
  ``word_timestamps`` one teacher-forced alignment pass a window
  (``WhisperRuntime.align_words``) and whisper's word-informed seek.

The host logic (segment parsing, the hallucination heuristics, the prompt
buffer) is the JAX module's, line for line. The conditioning prompt lives
in a fixed left-padded buffer with a per-row ``start`` (positions before it
are masked out of attention and position numbering, ``decoding.py``'s
``_decode_step``), as in the JAX package. One difference by design: rung
``i`` of window ``seek`` samples from a ``torch.Generator`` seeded from
(seed·1009 + seek, i), where JAX folds ``i`` into ``PRNGKey(seed·1009 +
seek)``: a run is deterministic from its seed, and its sampled rungs are
not JAX's.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ... import profiling
from ...audio.mel import frame_signal, framed_log10_mel
from ...constants import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES
from .tokenizer import LANGUAGES, decode_text, special_tokens

_TIME_PRECISION = 0.02          # seconds per timestamp token
_FRAMES_PER_TICK = 2            # mel frames per timestamp token
WINDOWS_PER_CALL = 16           # 30-s windows of frames a framed_log10_mel call


def full_log_mel(audio: np.ndarray, n_mels: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Whole-recording whisper log-mel → (n_mels, total_frames) float32 on
    ``device``, where total_frames = (len(audio) + N_SAMPLES) // HOP_LENGTH
    (whisper's trailing 30 s of zero padding is included, its frames too)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if len(audio) < N_FFT // 2 + 1:  # the 200-sample reflect prefix needs
        audio = np.pad(audio, (0, N_FFT // 2 + 1 - len(audio)))  # ≥201 samples
    total_frames = (len(audio) + N_SAMPLES) // HOP_LENGTH
    pad = N_FFT // 2
    stream = np.concatenate([audio[pad:0:-1], audio,
                             np.zeros(N_SAMPLES + N_FFT, np.float32)])
    with profiling.span("full_log_mel"), torch.inference_mode():
        frames = frame_signal(torch.from_numpy(stream).to(device), total_frames)
        block = WINDOWS_PER_CALL * N_FRAMES
        log_spec = torch.cat([framed_log10_mel(frames[r0:r0 + block], n_mels)
                              for r0 in range(0, total_frames, block)])
        log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
        log_spec = (log_spec + 4.0) / 4.0
        return log_spec.T.contiguous()


def _parse_segments(gen: np.ndarray, st, seek_time: float, window_s: float):
    """Split one window's generated tokens on paired timestamps.

    → (segments ``[{"start", "end", "text_tokens"}]``, seek_advance_frames,
    single_timestamp_ending). whisper transcribe.py's rule set: consecutive
    timestamp tokens close a segment; a window ENDING on a lone timestamp
    means no speech after it — the final piece is emitted and the whole
    window is consumed; otherwise the unfinished trailing piece is dropped
    and seek moves to the last closed timestamp so that audio is
    re-decoded.
    """
    ts0 = st.timestamp_begin
    toks = [int(t) for t in gen]
    if st.eot in toks:
        toks = toks[: toks.index(st.eot)]
    is_ts = [t >= ts0 for t in toks]
    consecutive = [i + 1 for i in range(len(toks) - 1) if is_ts[i] and is_ts[i + 1]]
    single_ending = len(toks) >= 2 and is_ts[-1] and not is_ts[-2]

    segments = []
    if consecutive:
        slices = list(consecutive)
        if single_ending:
            slices.append(len(toks))
        last_slice = 0
        for boundary in slices:
            piece = toks[last_slice:boundary]
            start_ts = piece[0] - ts0 if piece and is_ts[last_slice] else 0
            end_ts = piece[-1] - ts0
            segments.append({
                "start": seek_time + start_ts * _TIME_PRECISION,
                "end": seek_time + end_ts * _TIME_PRECISION,
                "text_tokens": [t for t in piece if t < st.eot],
            })
            last_slice = boundary
        if single_ending:
            advance = N_FRAMES
        else:
            # drop the unfinished trailing piece; seek to the last CLOSED
            # timestamp so that audio is re-decoded next window
            advance = max((toks[last_slice - 1] - ts0) * _FRAMES_PER_TICK, 1)
    else:
        # no closed segment in this window: whole window, one segment; its
        # end comes from the last timestamp when one was produced
        ts = [t - ts0 for t, f in zip(toks, is_ts) if f]
        end = window_s
        if ts and ts[-1] != 0:
            end = ts[-1] * _TIME_PRECISION
        text = [t for t in toks if t < st.eot]
        if text:
            segments.append({"start": seek_time, "end": seek_time + end,
                             "text_tokens": text})
        advance = N_FRAMES
    return segments, advance, single_ending


def _get_end(segments: list[dict]) -> float | None:
    """whisper transcribe.py ``get_end``: the last word end over segments
    that carry words (None when none do)."""
    for s in reversed(segments):
        if s.get("words"):
            return s["words"][-1]["end"]
    return None


def _next_words_segment(segments: list[dict]) -> dict | None:
    return next((s for s in segments if s.get("words")), None)


def _word_anomaly_score(word: dict) -> float:
    """whisper transcribe.py's hallucination heuristic per word: low
    teacher-forced probability, implausibly short, or implausibly long."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(segment: dict | None) -> bool:
    """whisper's segment-level call: score the first 8 non-punctuation words;
    anomalous when the total reaches 3 or ~1 per word."""
    from .timing import APPEND_PUNCTUATIONS, PREPEND_PUNCTUATIONS

    if segment is None or not segment.get("words"):
        return False
    punct = PREPEND_PUNCTUATIONS + APPEND_PUNCTUATIONS
    words = [w for w in segment["words"] if w["word"] not in punct][:8]
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def _decode_window_with_fallback(
    runtime, encoded, prompt, n_prompt, start, temperatures, beam_size,
    compression_ratio_threshold, logprob_threshold, no_speech_threshold,
    st, key_base,
):
    """whisper transcribe.py's ``decode_with_fallback`` for ONE window.

    Walks the temperature ladder; a rung is accepted when its zlib
    compression ratio ≤ threshold AND avg_logprob ≥ threshold — except that
    confident silence (no_speech_prob > threshold) accepts the current rung
    at once (``runtime.fallback_accepts``, the rule the batched ladder
    applies too). The t = 0 rung is beam search when ``beam_size`` is set.
    → (tokens (1, n) numpy, sum_lp, n_text, nsp, temperature_used,
    compression_ratio)."""
    from .runtime import fallback_accepts

    out = None
    for ti, t in enumerate(temperatures):
        generator = None
        if t > 0:  # one seed per (key_base, rung) pair
            generator = torch.Generator(device=runtime.device).manual_seed((key_base << 16) + ti)
        tokens_h, sum_lp, n_text, nsp = runtime._decode(
            encoded, prompt, n_prompt, temperature=float(t),
            beam_size=beam_size if t == 0.0 else None, generator=generator,
            start=start)
        slp = float(sum_lp.reshape(-1)[0])
        ntx = float(n_text.reshape(-1)[0])
        nsp_h = float(nsp.reshape(-1)[0])
        gen = tokens_h[0, n_prompt:]
        text = decode_text([int(x) for x in gen if x < st.eot], runtime.dims.n_vocab)
        accept, ratio, _ = fallback_accepts(
            text, slp, ntx, nsp_h, compression_ratio_threshold,
            logprob_threshold, no_speech_threshold)
        out = (tokens_h, slp, ntx, nsp_h, float(t), ratio)
        if accept or ti == len(temperatures) - 1:
            break
    return out


def transcribe_long(
    runtime,
    audio: np.ndarray,
    verbose: bool = False,
    temperatures: tuple = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    beam_size: Optional[int] = None,
    compression_ratio_threshold: Optional[float] = 2.4,
    no_speech_threshold: Optional[float] = 0.6,
    logprob_threshold: Optional[float] = -1.0,
    condition_on_previous_text: bool = True,
    history_budget: Optional[int] = None,
    initial_prompt: Optional[str] = None,
    word_timestamps: bool = False,
    clip_timestamps: str | list = "0",
    carry_initial_prompt: bool = False,
    prepend_punctuations: Optional[str] = None,
    append_punctuations: Optional[str] = None,
    hallucination_silence_threshold: Optional[float] = None,
    seed: int = 0,
) -> dict:
    """→ {"text", "segments": [{"id", "seek", "start", "end", "text",
    "tokens", "temperature", "avg_logprob", "compression_ratio",
    "no_speech_prob"[, "words"]}, …], "language"} for a waveform of any
    length (whisper transcribe.py's result record; the language is detected
    on the first window and pinned).

    Every window decodes through the temperature ladder
    (``_decode_window_with_fallback``); a window that escalates past
    t = 0.5 resets the conditioning history (whisper's
    ``prompt_reset_since``). A window whose SOT-step <|nospeech|>
    probability exceeds ``no_speech_threshold`` is skipped unless its
    avg_logprob beats ``logprob_threshold``.

    ``condition_on_previous_text`` threads the previous windows' text into
    the prompt as ``<|startofprev|> history… <|sot|>…``; ``initial_prompt``
    seeds that history, or with ``carry_initial_prompt`` re-prefixes every
    window's conditioning. The prompt lives in a fixed buffer of
    ``n_text_ctx − max_new_tokens`` slots (at most ``history_budget`` + 1
    history slots beyond the SOT sequence), left-filled with
    ``<|startofprev|>`` and carried with a ``start`` offset.

    ``word_timestamps`` adds whisper's per-word timing to every segment and
    its word-informed seek; ``hallucination_silence_threshold`` (seconds;
    needs word timestamps, warns without them) drops anomalous segments
    surrounded by silence. ``clip_timestamps`` ("start,end,…" seconds, or a
    list) restricts decoding to those ranges: a window crossing its clip's
    end is zero-padded past it."""
    if hallucination_silence_threshold is not None and not word_timestamps:
        # the heuristic runs on word alignments; without them it is a no-op
        # (whisper transcribe.py warns in the same combination)
        warnings.warn(
            "hallucination_silence_threshold requires word_timestamps=True; "
            "the option has no effect without it", stacklevel=2)

    dims = runtime.dims
    dev = runtime.device
    st = special_tokens(dims.n_vocab)
    orig_len = int(np.asarray(audio).reshape(-1).shape[0])
    mel = full_log_mel(audio, dims.n_mels, device=dev)
    # whisper transcribe.py: content_frames = mel frames of audio + 30-s pad
    # minus one window; ≤ 0 (sub-10 ms recordings) decodes nothing. Taken
    # from the ORIGINAL length: full_log_mel's minimum pad for the reflect
    # prefix must not mint a content frame whisper would not have.
    content_frames = (orig_len + N_SAMPLES) // HOP_LENGTH - N_FRAMES

    segments: list[dict] = []
    history: list[int] = []  # previous windows' text tokens
    lang_pinned = None
    last_speech_timestamp = 0.0  # across windows AND clips (whisper's init)
    init_ids: list[int] = []
    if initial_prompt:
        from . import tokenizer

        ids = tokenizer.encode_text(" " + initial_prompt.strip(), dims.n_vocab)
        if ids:  # a no-op without tokenizer assets (whisper needs them too)
            init_ids = list(ids)
            if not carry_initial_prompt:
                # one-shot conditioning: the prompt tokens live in the
                # ordinary history and vanish on the first reset
                history.extend(init_ids)
    # whisper's clip_timestamps: "start,end,start,end,…" seconds (or a
    # list); a trailing start closes at the recording end; "0" = everything
    if isinstance(clip_timestamps, str):
        clip_list = ([float(t) for t in clip_timestamps.split(",")]
                     if clip_timestamps else [])
    else:
        clip_list = [float(t) for t in (clip_timestamps or [])]
    pts = [round(t * 100) for t in clip_list]  # seconds → mel frames
    if not pts:
        pts = [0]
    if len(pts) % 2 == 1:
        pts.append(content_frames)
    seek_clips = [(max(s, 0), min(e, content_frames))
                  for s, e in zip(pts[::2], pts[1::2])]

    clip_idx = 0
    seek = seek_clips[0][0] if seek_clips else 0  # in mel frames (10 ms each)
    while clip_idx < len(seek_clips):
        clip_start, clip_end = seek_clips[clip_idx]
        if seek < clip_start:
            seek = clip_start
        if seek >= clip_end:
            clip_idx += 1
            if clip_idx < len(seek_clips):
                seek = seek_clips[clip_idx][0]
            continue
        # seek < content_frames ⇒ the window is full-width (the 30-s zero
        # tail is part of the mel); a window crossing its CLIP end is
        # zero-padded past it (whisper's pad_or_trim of the clipped segment)
        segment_size = min(N_FRAMES, clip_end - seek)
        win = mel[:, seek: seek + N_FRAMES]
        if segment_size < N_FRAMES:
            win = win.clone()
            win[:, segment_size:] = 0.0
        with profiling.span("window_encode"):
            encoded = runtime.encode(win[None])
        # whisper.transcribe detects the language once (first window), pins it
        prompt, n_prompt = runtime._prompt(encoded, lang_idx=lang_pinned)
        base = prompt[0].tolist()
        if lang_pinned is None and runtime._st.multilingual:
            lang_pinned = base[1] - runtime._st.lang_base
        start = None
        carried = init_ids if carry_initial_prompt else []
        if (condition_on_previous_text or initial_prompt) and (history or carried):
            buf_len = dims.n_text_ctx - runtime.max_new_tokens
            if history_budget is not None:
                buf_len = min(buf_len, len(base) + 1 + history_budget)
            budget = buf_len - len(base) - 1
            if budget > 0:  # max_new_tokens near n_text_ctx can leave no room
                if carried:
                    # carry_initial_prompt: the initial prompt re-prefixes
                    # every window's conditioning; history fills the rest
                    room = max(budget - len(carried), 0)
                    tail = carried + (history[-room:] if room else [])
                    tail = tail[-budget:]  # init_ids alone may exceed budget
                else:
                    tail = history[-budget:]
                seq = [st.sot_prev] + tail + base
                pad_n = buf_len - len(seq)  # ≥ 0 by the budget cap above
                prompt = torch.tensor([[st.sot_prev] * pad_n + seq],
                                      dtype=torch.int64, device=dev)
                n_prompt = buf_len
                start = torch.tensor([pad_n], dtype=torch.int64, device=dev)
        tokens, slp, ntx, nsp, used_t, ratio = _decode_window_with_fallback(
            runtime, encoded, prompt, n_prompt, start, temperatures,
            beam_size, compression_ratio_threshold, logprob_threshold,
            no_speech_threshold, st, key_base=seed * 1009 + seek)
        avg_lp = slp / (ntx + 1.0)
        if no_speech_threshold is not None and nsp > no_speech_threshold:
            if logprob_threshold is None or avg_lp < logprob_threshold:
                seek += N_FRAMES  # silent window: skip it entirely
                continue
        gen = tokens[0][n_prompt:]
        window_s = segment_size * 0.01
        segs, advance, single_ts_ending = _parse_segments(gen, st, seek * 0.01, window_s)
        if not condition_on_previous_text:
            # whisper resets the prompt after every window in this mode (the
            # initial_prompt still conditioned the FIRST window above)
            history.clear()
        aligned = None
        if word_timestamps and segs:
            # one teacher-forced alignment pass over the window's text
            # tokens (the clean notimestamps sequence, whisper
            # find_alignment), then words split per segment by token spans;
            # times shift by the window's seek offset
            window_tokens = [t for s in segs for t in s["text_tokens"]]
            aligned = runtime.align_words(
                encoded, window_tokens, lang_idx=(lang_pinned or 0),
                num_frames=segment_size // 2)
        tok_cursor = 0
        for s in segs:
            toks = s.pop("text_tokens")
            # whisper's new_segment record: seek is the window's mel-frame
            # origin (ids are assigned at commit time below — the
            # hallucination heuristics may still drop trailing segments)
            s["seek"] = seek
            s["text"] = decode_text(toks, dims.n_vocab)
            s["tokens"] = toks
            s["temperature"] = used_t
            s["avg_logprob"] = avg_lp
            s["compression_ratio"] = ratio
            s["no_speech_prob"] = nsp
            if aligned is not None:
                from .timing import (APPEND_PUNCTUATIONS, PREPEND_PUNCTUATIONS,
                                     group_words, merge_punctuations)

                starts_w, ends_w, pieces_w, probs_w = aligned
                n_tok = min(len(toks), len(pieces_w) - tok_cursor)
                sl = slice(tok_cursor, tok_cursor + n_tok)
                s["words"] = [
                    {"word": wd["word"],
                     "start": wd["start"] + seek * 0.01,
                     "end": wd["end"] + seek * 0.01,
                     "probability": wd["probability"]}
                    for wd in merge_punctuations(
                        group_words(pieces_w[sl], starts_w[sl], ends_w[sl],
                                    probs=probs_w[sl]),
                        prepended=(prepend_punctuations
                                   if prepend_punctuations is not None
                                   else PREPEND_PUNCTUATIONS),
                        appended=(append_punctuations
                                  if append_punctuations is not None
                                  else APPEND_PUNCTUATIONS))
                ]
                tok_cursor += n_tok

        if aligned is not None:
            # whisper's word-timestamp seek: a window that does not end on a
            # closed timestamp pair resumes right after the last attested
            # word
            time_offset = seek * 0.01
            window_end_time = (seek + N_FRAMES) * 0.01
            if not single_ts_ending:
                lwe = _get_end(segs)
                if lwe is not None and lwe > time_offset:
                    # (max 1: a word ending within the seek frame must still
                    # advance, or the loop would re-decode forever)
                    advance = max(round(lwe * 100) - seek, 1)
            if hallucination_silence_threshold is not None:
                threshold = hallucination_silence_threshold
                if not single_ts_ending:
                    lwe = _get_end(segs)
                    if lwe is not None and lwe > time_offset:
                        remaining = window_end_time - lwe
                        if remaining > threshold:
                            advance = max(round(lwe * 100) - seek, 1)
                        else:
                            advance = segment_size
                # a leading anomaly after a long silent gap: skip the
                # silence and retry from the anomaly's start
                first_seg = _next_words_segment(segs)
                if first_seg is not None and _is_segment_anomaly(first_seg):
                    gap = first_seg["start"] - time_offset
                    if gap > threshold:
                        seek += max(round(gap * 100), 1)
                        continue  # window's output dropped entirely
                # an anomaly surrounded by silence (or more anomalies):
                # drop it and everything after, resume at its start
                hal_last_end = last_speech_timestamp
                for si, segment in enumerate(segs):
                    if not segment.get("words"):
                        continue
                    if _is_segment_anomaly(segment):
                        nxt = _next_words_segment(segs[si + 1:])
                        if nxt is not None:
                            hal_next_start = nxt["words"][0]["start"]
                        else:
                            hal_next_start = time_offset + segment_size * 0.01
                        silence_before = (
                            segment["start"] - hal_last_end > threshold
                            or segment["start"] < threshold
                            or segment["start"] - time_offset < 2.0)
                        silence_after = (
                            hal_next_start - segment["end"] > threshold
                            or _is_segment_anomaly(nxt)
                            or window_end_time - segment["end"] < 2.0)
                        if silence_before and silence_after:
                            advance = max(
                                round(max(time_offset + 1, segment["start"])
                                      * 100) - seek, 1)
                            if content_frames * 0.01 - segment["end"] < threshold:
                                advance = content_frames - seek
                            del segs[si:]
                            break
                    # whisper advances hal_last_end with the SEGMENT end
                    # (timestamp-token derived), not the last word's DTW end
                    hal_last_end = segment["end"]
            lwe = _get_end(segs)
            if lwe is not None:
                last_speech_timestamp = lwe

        for s in segs:
            s["id"] = len(segments)
            segments.append(s)
            if condition_on_previous_text:
                history.extend(s["tokens"])
            if verbose:
                print(f"[{s['start']:.2f} -> {s['end']:.2f}] {s['text']}")
        if used_t > 0.5:
            # whisper's prompt_reset_since: a window that escalated past 0.5
            # never conditions later windows (its own tokens included)
            history.clear()
        seek += advance
    # the decode language (detected on the first window and pinned, or the
    # caller's); English-only models are always "en"
    if not runtime._st.multilingual:
        language = "en"
    elif lang_pinned is not None and 0 <= lang_pinned < len(LANGUAGES):
        language = LANGUAGES[lang_pinned]
    else:
        language = runtime.language
    return {
        "text": "".join(s["text"] for s in segments),
        "segments": segments,
        "language": language,
    }
