"""Whisper special-token layout and (optional) text detokenization.

The port's own copy of ``freud_tpu/models/whisper/tokenizer.py`` (it knows
no framework; ``tests/test_torch_host.py`` holds the two equal).
Special-token ids are fixed by vocabulary size, so the id arithmetic needs
no assets; BPE *text* decoding needs the tiktoken rank files, which are
loaded when present (``$FREUD_TOKENIZER_DIR``, the package's ``assets/``,
``~/.cache/freud_tpu/tokenizers``) and otherwise text renders as
``<tok:N>`` so every pipeline still runs without a download.
"""

from __future__ import annotations

import base64
import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

# Language-token order of the multilingual vocab (public Whisper layout);
# index i ⇒ token id lang_base + i. large-v3 appends "yue".
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)
_N_LANGS_V2 = 99
_N_LANGS_V3 = 100


def language_index(code: str, n_vocab: int) -> int:
    st = special_tokens(n_vocab)
    try:
        idx = LANGUAGES.index(code)
    except ValueError:
        raise ValueError(f"Unknown language code {code!r}")
    if idx >= st.n_langs:
        raise ValueError(f"{code!r} not in this model's {st.n_langs}-language vocab")
    return idx


@dataclass(frozen=True)
class SpecialTokens:
    n_vocab: int
    eot: int
    sot: int
    lang_base: int  # first language token (<|en|>)
    n_langs: int
    translate: int
    transcribe: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int

    @property
    def multilingual(self) -> bool:
        return self.n_vocab >= 51865

    def lang_token(self, lang_index: int = 0) -> int:
        return self.lang_base + lang_index

    def sot_sequence(self, lang_index: int = 0, task_translate: bool = False,
                     timestamps: bool = True) -> list[int]:
        """The decoder prompt: <|sot|> [<|lang|> <|task|>] [<|notimestamps|>].

        Matches the reference's default DecodingOptions
        (without_timestamps=False → timestamps on, hooked_model.py:103-110).
        """
        if not self.multilingual:
            seq = [self.sot]
        else:
            seq = [
                self.sot,
                self.lang_token(lang_index),
                self.translate if task_translate else self.transcribe,
            ]
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq


@lru_cache(maxsize=None)
def special_tokens(n_vocab: int) -> SpecialTokens:
    if n_vocab == 51864:  # English-only models
        base, n_langs = 50256, _N_LANGS_V2
    elif n_vocab == 51865:  # multilingual v1/v2
        base, n_langs = 50257, _N_LANGS_V2
    elif n_vocab == 51866:  # large-v3 family
        base, n_langs = 50257, _N_LANGS_V3
    else:
        raise ValueError(f"Unknown whisper vocab size {n_vocab}")
    eot = base
    sot = base + 1
    lang_base = base + 2
    after_langs = lang_base + n_langs
    return SpecialTokens(
        n_vocab=n_vocab,
        eot=eot,
        sot=sot,
        lang_base=lang_base,
        n_langs=n_langs,
        translate=after_langs,
        transcribe=after_langs + 1,
        sot_prev=after_langs + 3,
        no_speech=after_langs + 4,
        no_timestamps=after_langs + 5,
        timestamp_begin=after_langs + 6,
    )


def _rank_file_candidates(multilingual: bool) -> list[Path]:
    name = "multilingual.tiktoken" if multilingual else "gpt2.tiktoken"
    dirs = []
    if os.environ.get("FREUD_TOKENIZER_DIR"):
        dirs.append(Path(os.environ["FREUD_TOKENIZER_DIR"]))
    dirs.append(Path(__file__).parent / "assets")
    dirs.append(Path("~/.cache/freud_tpu/tokenizers").expanduser())
    return [d / name for d in dirs]


_BYTE_DECODER_CACHE: dict[bool, dict[int, bytes]] = {}


def clear_asset_caches() -> None:
    """Drop the rank-table caches (tests point $FREUD_TOKENIZER_DIR at
    synthetic rank files and need a clean slate between scenarios)."""
    _BYTE_DECODER_CACHE.clear()
    _ENCODER_RANKS_CACHE.clear()
    _NS_CACHE.clear()


def _byte_decoder(multilingual: bool) -> dict[int, bytes] | None:
    """token id → bytes table from a tiktoken rank file, if available.

    Caches only HITS: asset dirs are mutable (the same doctrine as the
    alignment-head table), so a rank file landing after the first call must
    be picked up on the next one, not shadowed by a cached None until
    process restart."""
    if multilingual in _BYTE_DECODER_CACHE:
        return _BYTE_DECODER_CACHE[multilingual]
    for path in _rank_file_candidates(multilingual):
        if path.exists():
            table: dict[int, bytes] = {}
            with open(path, "rb") as f:
                for line in f:
                    if not line.strip():
                        continue
                    tok_b64, rank = line.split()
                    table[int(rank)] = base64.b64decode(tok_b64)
            _BYTE_DECODER_CACHE[multilingual] = table
            return table
    return None


def decode_text(tokens, n_vocab: int) -> str:
    """Render token ids as text (BPE assets permitting) below the special ids."""
    st = special_tokens(n_vocab)
    content = [int(t) for t in tokens if int(t) < st.eot]
    table = _byte_decoder(st.multilingual)
    if table is None:
        return "".join(f"<tok:{t}>" for t in content)
    data = b"".join(table.get(t, b"?") for t in content)
    return data.decode("utf-8", errors="replace")


def tokenizer_available(n_vocab: int) -> bool:
    return _byte_decoder(special_tokens(n_vocab).multilingual) is not None


def token_pieces(tokens, n_vocab: int) -> list[str]:
    """Per-token rendered text pieces (for word-boundary grouping).

    With BPE assets each piece is that token's bytes decoded leniently (a
    piece may hold part of a multi-byte character — concatenation equals
    ``decode_text``'s output only when pieces are re-joined at the BYTE level,
    so callers grouping pieces into words should tolerate replacement chars
    at word boundaries); without assets, ``<tok:N>`` markers."""
    st = special_tokens(n_vocab)
    content = [int(t) for t in tokens if int(t) < st.eot]
    table = _byte_decoder(st.multilingual)
    if table is None:
        return [f"<tok:{t}>" for t in content]
    return [table.get(t, b"?").decode("utf-8", errors="replace") for t in content]


def encode_text(text: str, n_vocab: int) -> list[int] | None:
    """BPE-encode plain text (for ``initial_prompt`` conditioning); None
    without tokenizer assets.

    Pre-tokenizes by splitting on whitespace with the space attached to the
    following word (the dominant case of the GPT-2 regex); pieces containing
    trailing punctuation may merge slightly differently than tiktoken's
    regex, but the ids still decode to the same text — adequate for prompt
    conditioning, not for exact round-trip tests."""
    import re

    st = special_tokens(n_vocab)
    ranks = _encoder_ranks(st.multilingual)
    if ranks is None:
        return None
    out: list[int] = []
    for piece in re.findall(r"\s*\S+", text):
        out.extend(_encode_piece(piece, ranks))
    return out


# --------------------------------------------------------------- suppression

_ENCODER_RANKS_CACHE: dict[bool, dict[bytes, int]] = {}


def _encoder_ranks(multilingual: bool) -> dict[bytes, int] | None:
    if multilingual in _ENCODER_RANKS_CACHE:
        return _ENCODER_RANKS_CACHE[multilingual]
    table = _byte_decoder(multilingual)
    if table is None:
        return None  # miss NOT cached — assets may land later
    ranks = {v: k for k, v in table.items()}
    _ENCODER_RANKS_CACHE[multilingual] = ranks
    return ranks


def _encode_piece(text: str, ranks: dict[bytes, int]) -> list[int]:
    """Byte-level BPE of ONE pre-tokenized piece (greedy lowest-rank merge —
    the tiktoken algorithm). Every symbol whisper's non-speech rule encodes
    is a single regex piece (` ?[^\\s\\p{L}\\p{N}]+`), so no pre-tokenizer
    needed here."""
    parts = [bytes([b]) for b in text.encode("utf-8")]
    while len(parts) > 1:
        best_i, best_rank = None, None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_i, best_rank = i, r
        if best_i is None:
            break
        parts = (
            parts[:best_i] + [parts[best_i] + parts[best_i + 1]]
            + parts[best_i + 2:]
        )
    return [ranks[p] for p in parts]


# whisper tokenizer.py `non_speech_tokens`: speaker-tag / annotation symbols,
# keeping basic punctuation
_NS_SYMBOLS = (
    list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
    + "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
)
_NS_MISC = set("♩♪♫♬♭♮♯")


_NS_CACHE: dict[int, tuple] = {}


def non_speech_token_ids(n_vocab: int) -> tuple | None:
    """Whisper's non-speech suppression list (tokenizer.py non_speech_tokens),
    derived at runtime from the tiktoken rank table; None when the BPE asset
    is unavailable (the miss is not cached: assets may land later)."""
    if n_vocab in _NS_CACHE:
        return _NS_CACHE[n_vocab]
    st = special_tokens(n_vocab)
    ranks = _encoder_ranks(st.multilingual)
    if ranks is None:
        return None
    enc = lambda s: _encode_piece(s, ranks)  # noqa: E731
    result = {enc(" -")[0], enc(" '")[0]}
    for symbol in _NS_SYMBOLS + list(_NS_MISC):
        for toks in (enc(symbol), enc(" " + symbol)):
            if len(toks) == 1 or symbol in _NS_MISC:
                result.add(toks[0])
    out = tuple(sorted(result))
    _NS_CACHE[n_vocab] = out
    return out


def suppress_token_ids(n_vocab: int) -> tuple:
    """The id set whisper's default DecodingOptions suppresses every step
    (decoding.py _get_suppress_tokens with suppress_tokens="-1": the
    non-speech list plus transcribe/translate/sot/sot_prev/sot_lm/no_speech;
    reference path hooked_model.py:103-110). Degrades to the special-token
    subset when BPE assets are absent."""
    st = special_tokens(n_vocab)
    sot_lm = st.sot_prev - 1  # <|startoflm|> sits between transcribe and sot_prev
    ids = {st.transcribe, st.translate, st.sot, st.sot_prev, sot_lm,
           st.no_speech}
    ns = non_speech_token_ids(n_vocab)
    if ns is not None:
        ids.update(ns)
    return tuple(sorted(ids))


def blank_token_id(n_vocab: int) -> int | None:
    """Token for " " — suppressed (with EOT) at the first sampled position
    (whisper decoding.py SuppressBlank); None without BPE assets."""
    ranks = _encoder_ranks(special_tokens(n_vocab).multilingual)
    if ranks is None:
        return None
    return _encode_piece(" ", ranks)[0]
