"""Whisper runtime: capture, substitution and transcription on one device.

The port of ``freud_tpu``'s ``WhisperRuntime``. One runtime object owns the
model on its device (the card unless the caller passes ``device="cpu"``)
and at most one capture layer:

* ``activations(mels)`` — for an encoder layer one encoder forward that
  stops after the captured layer: collection never touches the decoder,
  which is built only when a decode first needs it. For a ``decoder.*``
  layer ``decode_capture``: the whole encoder, a greedy decode, then one
  teacher-forced ``decoder_forward`` that captures every decode position
  (``activations_with_decode`` also returns the tokens and the valid
  positions).
* ``transcribe(mels, substitute_layer=..., substitute_value=...,
  decoder_tap=...)`` — the encoder (optionally with one encoder layer's
  output replaced) and the KV-cached greedy decoder (``decoding.py``),
  optionally steered online at a decoder block (``decoder_tap``);
  ``transcribe_with_fallback`` is whisper.transcribe's temperature ladder
  (one decode a rung, beam search on the t = 0 rung when ``beam_size`` is
  given).

The log-mel on the card: the transcribe CLI's ``AudioBatchPipeline`` runs
the log-mel kernel (#1), as the JAX pipeline runs its Pallas kernel on the
TPU; on CUDA the port's ``mels_from_array`` (the trainer's validation
transcripts) runs #1 too, where the JAX package's runs its XLA path. Both
are held within #1's gate on the card. The differential tests run on the
CPU, where both packages take their plain paths.

Word timestamps: ``transcribe_with_word_timestamps`` (a batch of 30-s
windows) and ``align_words`` (one window of the long-form loop) run one
teacher-forced f32 ``decoder_forward`` that captures the alignment heads'
cross-attention, then DTW on the host (``timing.py``). Long-form audio:
``transcribe_long`` (``long_audio.py``), whose whole-recording log-mel is
plain torch on the runtime's device, not kernel #1 (its floor is global).
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np
import torch

from ... import profiling
from ...device import resolve_device
from .config import WhisperDims
from .decoding import beam_decode, detect_language, sample_decode
from .load import load_decoder, load_model
from .model import AudioEncoder, TextDecoder, decoder_forward, encoder_forward
from .tokenizer import decode_text, language_index, special_tokens

FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def pin_full_f32(device: torch.device) -> None:
    """f32 on CUDA means f32: no TF32 in cuDNN's convs (on by default) nor in
    cuBLAS matmuls (off by default). Process-wide PyTorch switches."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def fallback_accepts(text, sum_lp, n_text, no_speech_prob,
                     compression_ratio_threshold, logprob_threshold,
                     no_speech_threshold):
    """whisper transcribe.py decode_with_fallback's acceptance rule for one
    clip → (accept, compression_ratio, avg_logprob), as the JAX package
    applies it."""
    ratio = 0.0
    if text:
        raw = text.encode("utf-8")
        ratio = len(raw) / max(len(zlib.compress(raw)), 1)
    avg_lp = sum_lp / (n_text + 1.0)
    accept = True
    if (compression_ratio_threshold is not None
            and "<tok:" not in text
            and ratio > compression_ratio_threshold):
        # "<tok:N>" is the rendering without BPE assets: its scaffolding
        # compresses to ≈ 2.9 whatever the content, so the repetition gate
        # is skipped there (it would reject every rung)
        accept = False  # too repetitive
    if logprob_threshold is not None and avg_lp < logprob_threshold:
        accept = False  # average log probability too low
    if (no_speech_threshold is not None
            and no_speech_prob > no_speech_threshold):
        accept = True  # confident silence: don't escalate
    return accept, ratio, avg_lp


def _check_encoder_layer(layer_name: str, what: str) -> None:
    """Tensor substitution splices the encoder forward only: a ``decoder.*``
    name would never match a tap and silently do nothing. A decoder layer
    is steered online instead (``transcribe(decoder_tap=…)``): a fixed
    tensor cannot replace positions an autoregressive decode has not made
    yet."""
    if layer_name.startswith("decoder."):
        raise ValueError(
            f"{what} supports encoder layers only, got {layer_name!r} — "
            "decoder-layer capture works via activations(); for decoder-"
            "layer steering pass decoder_tap=(layer_idx, fn, fn_params) "
            "(an online per-position transform) instead of a tensor")


def decode_capture(encoder: AudioEncoder, decoder: TextDecoder, dims: WhisperDims,
                   mels: torch.Tensor, layer_name: str, *, sot_seq: tuple,
                   lang_detect: bool, lang_base: int, max_new: int,
                   compute_dtype: torch.dtype = torch.float32, early_exit: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decoder-layer activation capture for one mel batch, the counterpart
    of ``freud_tpu.models.whisper.runtime.decode_capture``: the whole
    encoder, language detection when ``lang_detect``, a greedy decode, then
    ONE teacher-forced ``decoder_forward`` over the decoded tokens that
    captures ``layer_name`` at every position (causal masking makes
    position i's activation the one the step that processed token i made,
    up to summation order).

    → ``(acts (b, n_prompt + max_new, width), tokens, n_valid (b,) int32)``
    on the device, where ``n_valid = n_prompt + n_text`` counts the positions
    the decode processed; rows from ``n_valid`` on are EOT padding, which
    a store masks by its per-file ``n_frames``. The weights are in
    ``compute_dtype`` already (``WhisperRuntime`` casts them once)."""
    with torch.inference_mode():
        encoded, _ = encoder_forward(encoder, dims, mels, compute_dtype=compute_dtype)
        b = encoded.shape[0]
        prompt = torch.tensor(sot_seq, dtype=torch.int64,
                              device=encoded.device).repeat(b, 1)
        if lang_detect:
            prompt[:, 1] = lang_base + detect_language(decoder, dims, encoded,
                                                       compute_dtype=compute_dtype)
        n_prompt = len(sot_seq)
        tokens, _, n_text, _ = sample_decode(
            decoder, dims, encoded, prompt, n_prompt, max_new=max_new,
            compute_dtype=compute_dtype, early_exit=early_exit)
        _, caps = decoder_forward(decoder, dims, tokens, encoded, compute_dtype,
                                  capture=(layer_name,))
        n_valid = (n_prompt + n_text).to(torch.int32)
    return caps[layer_name], tokens, n_valid


class WhisperRuntime:
    """Encoder capture and transcription for one model + capture layer on
    one device."""

    def __init__(
        self,
        model_name: str,
        layer_name: Optional[str] = None,
        compute_dtype: torch.dtype = torch.float32,
        max_new_tokens: int = 224,
        language: Optional[str] = None,
        task: str = "transcribe",
        device: torch.device | str | None = None,
        early_exit: bool = True,
    ):
        """``language=None`` detects the language per clip (multilingual
        vocabularies); a code like ``"en"`` pins it. ``task`` is
        "transcribe" or "translate" (multilingual vocabularies only).
        ``device`` None means the card. ``early_exit=False`` makes every
        decode run its whole ``max_new_tokens`` budget (the same output; a
        benchmark's fixed yardstick)."""
        if layer_name is not None and not layer_name.startswith(("encoder.", "decoder.")):
            raise ValueError(f"unknown capture layer {layer_name!r}")
        if task not in ("transcribe", "translate"):
            raise ValueError(f"task must be transcribe|translate, got {task!r}")
        self.model_name = model_name
        self.layer_name = layer_name
        self.compute_dtype = compute_dtype
        self.max_new_tokens = max_new_tokens
        self.language = language
        self.task = task
        self.early_exit = early_exit
        self.device = resolve_device(device, "WhisperRuntime",
                                     hint='pass device="cpu" to run on the CPU')
        if compute_dtype == torch.float32:
            pin_full_f32(self.device)
        encoder, self.dims = load_model(model_name, device=self.device)
        # cast once here; encoder_forward then runs the module as it is
        self.encoder = encoder.to(compute_dtype).eval()
        self._decoder: Optional[TextDecoder] = None
        self._align_decoder: Optional[TextDecoder] = None
        if self._decoder_layer:
            self.decoder  # a decoder capture decodes: build it with the model
        self._st = special_tokens(self.dims.n_vocab)
        if task == "translate" and not self._st.multilingual:
            raise ValueError(
                f"{model_name!r} is English-only; task='translate' needs a "
                "multilingual model")

    @property
    def decoder(self) -> TextDecoder:
        """The text decoder in ``compute_dtype``, built at first use."""
        if self._decoder is None:
            decoder, _ = load_decoder(self.model_name, device=self.device)
            self._decoder = decoder.to(self.compute_dtype).eval()
        return self._decoder

    # -- capture ------------------------------------------------------------

    @property
    def _decoder_layer(self) -> bool:
        return (self.layer_name or "").startswith("decoder.")

    def activations(self, mels: torch.Tensor) -> torch.Tensor:
        """Captured activations at ``layer_name`` for (b, n_mels, 3000) mels
        (or one (n_mels, 3000) clip). Encoder layers: one captured encoder
        forward, (b, 1500, width). Decoder layers: ``decode_capture``,
        (b, n_prompt + max_new_tokens, width), EOT-padded (see
        ``activations_with_lengths`` for the valid positions)."""
        return self.activations_with_lengths(mels)[0]

    def activations_with_lengths(
        self, mels: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (activations, n_valid (b,) int32): the valid leading positions
        of each clip. Encoder layers: the full frame axis, on the host
        (callers with audio lengths refine it, see loaders); decoder
        layers: the positions the greedy decode processed, on the device."""
        if self.layer_name is None:
            raise ValueError("runtime was built without a capture layer")
        if self._decoder_layer:
            acts, n_valid, _ = self.activations_with_decode(mels)
            return acts, n_valid
        # eager PyTorch runs every layer it is given: stop after the
        # captured block (XLA dropped the unused tail of the JAX collection
        # program, whose encoded output it discards)
        with torch.inference_mode():
            _, caps = encoder_forward(
                self.encoder, self.dims, self._batch(mels),
                capture=(self.layer_name,), compute_dtype=self.compute_dtype,
                stop_after_capture=True)
        acts = caps[self.layer_name]
        return acts, torch.full((acts.shape[0],), acts.shape[1], dtype=torch.int32)

    def activations_with_decode(
        self, mels: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decoder layers only: → (activations, n_valid, tokens), where
        ``tokens`` (b, n_prompt + max_new) are the greedy ids the capture
        ran over, decoded with ``transcribe``'s settings (the same SOT
        sequence, language handling, max_new and greedy sampling): a caller
        that also wants the baseline transcript renders these
        (``decode_tokens_text``) instead of decoding again."""
        if not self._decoder_layer:
            raise ValueError(
                "activations_with_decode needs a decoder.* capture layer, "
                f"got {self.layer_name!r}")
        with profiling.span("decode_capture"):
            acts, tokens, n_valid = decode_capture(
                self.encoder, self.decoder, self.dims, self._batch(mels),
                self.layer_name, early_exit=self.early_exit,
                **self._decode_capture_statics())
        return acts, n_valid, tokens

    def _decode_capture_statics(self) -> dict:
        """``decode_capture``'s settings: a pinned ``language`` goes into
        the SOT sequence; otherwise a multilingual model detects per clip."""
        st = self._st
        lang_detect = st.multilingual and self.language is None
        lang = (language_index(self.language, self.dims.n_vocab)
                if (st.multilingual and self.language) else 0)
        sot_seq = st.sot_sequence(
            lang_index=lang, task_translate=self.task == "translate", timestamps=True)
        return dict(sot_seq=tuple(sot_seq), lang_detect=lang_detect,
                    lang_base=st.lang_base, max_new=self.max_new_tokens,
                    compute_dtype=self.compute_dtype)

    # -- transcription ------------------------------------------------------

    def encode(self, mels: torch.Tensor, substitute_layer: Optional[str] = None,
               substitute_value=None) -> torch.Tensor:
        """(b, n_mels, 3000) mels → (b, 1500, d) encoded audio in
        ``compute_dtype``, with ``substitute_layer``'s output replaced by
        ``substitute_value`` ((s, d) or (b, s, d)) when given."""
        mels = self._batch(mels)
        substitute = None
        if substitute_layer is not None:
            _check_encoder_layer(substitute_layer, "substitution")
            substitute = {substitute_layer: self._batched_substitute(
                substitute_value, mels.shape[0])}
        with torch.inference_mode():
            encoded, _ = encoder_forward(self.encoder, self.dims, mels,
                                         substitute=substitute,
                                         compute_dtype=self.compute_dtype)
        return encoded

    def _prompt(self, encoded: torch.Tensor, lang_idx=None) -> tuple[torch.Tensor, int]:
        """(b, n_prompt) SOT sequences on the runtime's device: the pinned
        language, ``lang_idx`` where given, else the language detected per
        clip (multilingual vocabularies)."""
        batch = encoded.shape[0]
        seq = self._st.sot_sequence(
            lang_index=0, task_translate=self.task == "translate", timestamps=True)
        arr = np.tile(np.asarray(seq, np.int64), (batch, 1))
        if self._st.multilingual:
            if lang_idx is not None:
                lang = np.broadcast_to(np.asarray(lang_idx), (batch,))
            elif self.language is None:
                lang = detect_language(self.decoder, self.dims, encoded,
                                       compute_dtype=self.compute_dtype).cpu().numpy()
            else:
                lang = np.full((batch,), language_index(self.language, self.dims.n_vocab))
            arr[:, 1] = self._st.lang_base + lang
        return torch.from_numpy(arr).to(self.device), len(seq)

    def _decode(self, encoded: torch.Tensor, prompt: torch.Tensor, n_prompt: int,
                temperature: float = 0.0, beam_size: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                decoder_tap: Optional[tuple] = None,
                start: Optional[torch.Tensor] = None) -> tuple[np.ndarray, ...]:
        """One decode of the batch → (tokens, sum_logprob, n_text,
        no_speech_prob) as numpy arrays; ``start`` ((b,) int) left-crops a
        left-padded prompt buffer (``decoding._decode_step``). The
        ``decode`` span covers the device work: it ends with the results on
        the host."""
        with profiling.span("decode"):
            if beam_size:
                out = beam_decode(self.decoder, self.dims, encoded, prompt, n_prompt,
                                  max_new=self.max_new_tokens, beam_size=beam_size,
                                  start=start, compute_dtype=self.compute_dtype)
            else:
                out = sample_decode(self.decoder, self.dims, encoded, prompt, n_prompt,
                                    max_new=self.max_new_tokens, temperature=temperature,
                                    generator=generator, start=start,
                                    compute_dtype=self.compute_dtype,
                                    early_exit=self.early_exit, decoder_tap=decoder_tap)
            return tuple(t.cpu().numpy() for t in out)

    def transcribe(self, mels: torch.Tensor, substitute_layer: Optional[str] = None,
                   substitute_value=None, decoder_tap: Optional[tuple] = None) -> list[str]:
        """Greedy transcripts of (b, n_mels, 3000) mels; with
        ``substitute_layer``, that encoder layer's output is replaced by
        ``substitute_value`` for the encode (the reference's
        ``WhisperSubbedActivation``). ``decoder_tap=(layer_idx, fn,
        fn_params)`` steers DECODER block ``layer_idx`` online:
        ``fn(fn_params, x)`` replaces the block's output at every decode
        position as it is generated (``decoding._decode_step``)."""
        encoded = self.encode(mels, substitute_layer, substitute_value)
        prompt, n_prompt = self._prompt(encoded)
        return self.decode_tokens_text(
            self._decode(encoded, prompt, n_prompt, decoder_tap=decoder_tap)[0])

    def transcribe_one(self, mels, **kw) -> str:
        return self.transcribe(mels, **kw)[0]

    def transcribe_with_fallback(
        self,
        mels: torch.Tensor,
        substitute_layer: Optional[str] = None,
        substitute_value=None,
        temperatures: tuple = FALLBACK_TEMPERATURES,
        beam_size: Optional[int] = None,
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        seed: int = 0,
    ) -> list[str]:
        """whisper.transcribe's decode-with-fallback schedule, batched: one
        decode of the whole batch a temperature (beam search on the t = 0
        rung when ``beam_size`` is given; rung i samples from a
        ``torch.Generator`` seeded ``seed + i``). A clip takes the first rung
        whose transcript ``fallback_accepts``; the last rung is taken
        whatever it holds."""
        encoded = self.encode(mels, substitute_layer, substitute_value)
        prompt, n_prompt = self._prompt(encoded)
        b = encoded.shape[0]
        texts: list[Optional[str]] = [None] * b
        for ti, t in enumerate(temperatures):
            generator = None
            if t > 0:
                generator = torch.Generator(device=self.device).manual_seed(seed + ti)
            tokens, sum_lp, n_text, nsp = self._decode(
                encoded, prompt, n_prompt, temperature=float(t),
                beam_size=beam_size if t == 0.0 else None, generator=generator)
            last = ti == len(temperatures) - 1
            for i in range(b):
                if texts[i] is not None:
                    continue
                text = decode_text(tokens[i], self.dims.n_vocab)
                ok, _, _ = fallback_accepts(
                    text, float(sum_lp[i]), float(n_text[i]), float(nsp[i]),
                    compression_ratio_threshold, logprob_threshold,
                    no_speech_threshold)
                if ok or last:
                    texts[i] = text
            if all(x is not None for x in texts):
                break
        return texts  # type: ignore[return-value]

    def decode_tokens_text(self, tokens) -> list[str]:
        """Render decoded token rows to transcripts (``decode_text``)."""
        return [decode_text(row, self.dims.n_vocab) for row in np.asarray(tokens)]

    # -- word timestamps and long-form audio -----------------------------------

    @property
    def align_decoder(self) -> TextDecoder:
        """The decoder the alignment pass runs: f32 weights whatever
        ``compute_dtype`` is, as the JAX package's alignment pass runs its
        f32 parameters at f32 (a bf16 runtime loads a second, f32 copy at
        first use)."""
        if self.compute_dtype == torch.float32:
            return self.decoder
        if self._align_decoder is None:
            decoder, _ = load_decoder(self.model_name, device=self.device)
            self._align_decoder = decoder.eval()
        return self._align_decoder

    def _alignment_forward(self, tokens: torch.Tensor, encoded: torch.Tensor
                           ) -> tuple[np.ndarray, np.ndarray]:
        """One teacher-forced f32 ``decoder_forward`` over (b, T) ``tokens``
        that captures the alignment layers' cross-attention weights →
        (weights (b, n_pairs, T, frames) in the curated (layer, head) order,
        next-token probabilities (b, T − 1): row r's probability of token
        r + 1, whisper find_alignment's text_token_probs), both f32 numpy.
        The (layer, head) planes are picked on the device and come back to
        the host with the probabilities in one copy. The pairs are resolved
        from the asset dirs at every call (``timing.load_alignment_heads``),
        so a table that appears mid-process takes effect at once."""
        from . import timing

        pairs = tuple(timing.load_alignment_heads(
            self.model_name, self.dims.n_text_layer, self.dims.n_text_head))
        names = {l: f"decoder.blocks.{l}.cross_attn.weights" for l, _ in pairs}
        with profiling.span("align"), torch.inference_mode():
            tokens = tokens.to(self.device, torch.int64)
            logits, caps = decoder_forward(self.align_decoder, self.dims, tokens,
                                           encoded, torch.float32,
                                           capture=tuple(sorted(set(names.values()))))
            w = torch.stack([caps[names[l]][:, h] for l, h in pairs], dim=1)
            probs = torch.softmax(logits.float(), dim=-1)[:, :-1].gather(
                -1, tokens[:, 1:, None])[..., 0]
            flat = torch.cat([w.reshape(-1), probs.reshape(-1)]).cpu().numpy()
        return (flat[:w.numel()].reshape(w.shape),
                flat[w.numel():].reshape(probs.shape))

    def transcribe_with_word_timestamps(
        self, mels: torch.Tensor, num_frames: Optional[np.ndarray] = None
    ) -> tuple[list[str], list[list[dict]]]:
        """→ (texts, per-clip word lists ``[{"word", "start", "end",
        "probability"}, …]``): a greedy decode of the batch, ONE alignment
        pass over the decoded rows, then host-side DTW (``timing.py``).
        ``num_frames`` optionally gives each clip's real encoder-frame
        count (mel frames / 2) to trim the padded window. As in the JAX
        package, the alignment runs over the timestamp-mode tokens with the
        timestamp tokens' rows dropped, not a re-decode without
        timestamps."""
        from . import timing
        from .tokenizer import token_pieces

        encoded = self.encode(mels)
        prompt, n_prompt = self._prompt(encoded)
        tokens = self._decode(encoded, prompt, n_prompt)[0]
        # (b, n_pairs, T, frames) over the curated (layer, head) pairs
        w, tok_probs = self._alignment_forward(torch.from_numpy(tokens), encoded)
        eot = self._st.eot
        texts, words = [], []
        for i in range(tokens.shape[0]):
            pos = [p for p in range(n_prompt, tokens.shape[1]) if tokens[i, p] < eot]
            pieces = token_pieces(tokens[i, pos], self.dims.n_vocab)
            nf = int(num_frames[i]) if num_frames is not None else None
            # row p-1 is the query that PREDICTS token p (whisper
            # find_alignment's convention)
            rows = [p - 1 for p in pos]
            starts, ends = timing.token_times(w[i], rows, nf)
            texts.append(decode_text(tokens[i], self.dims.n_vocab))
            words.append(timing.merge_punctuations(timing.group_words(
                pieces, starts, ends, probs=tok_probs[i][rows])))
        return texts, words

    def align_words(
        self,
        encoded: torch.Tensor,  # (1, frames, d)
        text_tokens: list[int],
        lang_idx: int = 0,
        num_frames: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray, list[str], np.ndarray]:
        """→ (starts, ends, pieces, token_probs) for ``text_tokens`` against
        one window. whisper timing.py ``find_alignment``: the alignment row
        is the clean ``sot_sequence + <|notimestamps|> + text + <|eot|>``,
        whatever prompt and timestamps the window was decoded with, padded
        with EOT to one fixed length, ``len(base) + max_new_tokens + 1``."""
        from . import timing
        from .tokenizer import token_pieces

        st = self._st
        base = st.sot_sequence(lang_index=lang_idx,
                               task_translate=self.task == "translate",
                               timestamps=False)
        cap = self.max_new_tokens
        text_tokens = list(text_tokens)[:cap]
        if not text_tokens:  # timestamp-only window: nothing to align
            return np.zeros(0), np.zeros(0), [], np.zeros(0)
        row = base + text_tokens + [st.eot]
        row = row + [st.eot] * (len(base) + cap + 1 - len(row))
        w, tok_probs = self._alignment_forward(torch.tensor([row]), encoded)
        n = len(text_tokens)
        # rows B-1 .. B+n-1 predict text[0..n-1]; row B+n-1 (the last text
        # token's own row) predicts EOT and rides along as whisper's extra
        # DTW target anchoring the final word's end
        rows = list(range(len(base) - 1, len(base) + n))
        pieces = token_pieces(np.asarray(text_tokens), self.dims.n_vocab)
        starts, ends = timing.token_times(w[0], rows, num_frames)
        return starts[:n], ends[:n], pieces, tok_probs[0][rows[:n]]

    def transcribe_long(self, audio: np.ndarray, verbose: bool = False, **kw) -> dict:
        """Arbitrary-length transcription: whisper.transcribe's 30-s seek
        loop (``long_audio.transcribe_long``, which takes the keywords) →
        {"text", "segments", "language"}."""
        from .long_audio import transcribe_long

        return transcribe_long(self, audio, verbose=verbose, **kw)

    # -- helpers ------------------------------------------------------------

    def _batch(self, mels) -> torch.Tensor:
        mels = torch.as_tensor(mels)
        if mels.ndim == 2:
            mels = mels[None]
        return mels.to(self.device, torch.float32)

    def _batched_substitute(self, substitute_value, batch: int) -> torch.Tensor:
        """Broadcast a single (s, d) replacement over the mel batch: the
        substitution replaces the tensor wholesale, so a batch-1 value
        against batch-N mels would collapse the encode to one clip."""
        sub = torch.as_tensor(substitute_value).to(self.device)
        if sub.ndim == 2:
            sub = sub[None]
        if sub.shape[0] == 1 and batch > 1:
            sub = sub.expand(batch, *sub.shape[1:])
        return sub

    @property
    def activation_width(self) -> int:
        """Feature dimension at the capture layer (d_model or 4·d_model)."""
        d = self.dims.n_text_state if self._decoder_layer else self.dims.n_audio_state
        if (self.layer_name or "").endswith((".mlp.0", ".mlp.1")):
            return 4 * d
        return d

    @property
    def activation_frames(self) -> int:
        """Padded frame-axis length of ``activations()`` rows, reported in
        the store metadata as the JAX package reports it: encoder layers
        n_audio_ctx (1500), decoder layers the decode's buffer (n_prompt +
        max_new_tokens)."""
        if self._decoder_layer:
            return len(self._decode_capture_statics()["sot_seq"]) + self.max_new_tokens
        return self.dims.n_audio_ctx


def init_runtime(model_name: str, layer_name: Optional[str] = None, **kw) -> WhisperRuntime:
    return WhisperRuntime(model_name, layer_name, **kw)
