"""Word-level timestamps via cross-attention DTW alignment.

Whisper's ``word_timestamps=True`` machinery (openai-whisper timing.py's
``find_alignment``: alignment-head attention → std-normalize → median filter
→ DTW → token times → word grouping), rebuilt for this framework's
functional decoder:

* the TEACHER-FORCED alignment forward is one jitted ``decoder_forward``
  over the already-decoded tokens, capturing the post-softmax cross-attention
  weights of the alignment layers (``decoder.blocks.{i}.cross_attn.weights``
  capture keys — no hooks);
* everything after the forward (normalization, filtering, DTW, grouping) is
  O(tokens × frames) host-side numpy — far below any device-worthy size.

Alignment heads: the released models ship curated head masks as repository
metadata (not checkpoint tensors); ``load_alignment_heads`` consumes them
from the asset dirs when present (``alignment_heads.json`` — pair lists or
whisper's base85-gzip dumps) and otherwise uses whisper's fallback: every
head of the upper half of decoder layers.

Beyond-reference surface: FREUD's decode paths are plain greedy
``model.decode`` (src/models/hooked_model.py:103-110) with no timing.
"""

from __future__ import annotations

import numpy as np

TOKENS_PER_SECOND = 50.0  # encoder frames/s: 1500 frames per 30 s
_MEDFILT_WIDTH = 7


def median_filter(x: np.ndarray, width: int = _MEDFILT_WIDTH) -> np.ndarray:
    """Median filter along the last axis with REFLECT padding (whisper
    timing.py median_filter: F.pad(..., mode="reflect"); sequences shorter
    than the half-width pass through unchanged, as there)."""
    pad = width // 2
    if width <= 1 or x.shape[-1] <= pad:
        return x
    cfg = [(0, 0)] * (x.ndim - 1) + [(pad, pad)]
    xp = np.pad(x, cfg, mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW path through ``cost`` (N_tokens, N_frames), whisper's
    step set {(1,0), (0,1), (1,1)}. Returns (text_indices, time_indices)."""
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), dtype=np.int8)
    for i in range(1, N + 1):
        row_prev = D[i - 1]
        row = D[i]
        for j in range(1, M + 1):
            c0, c1, c2 = row_prev[j - 1], row_prev[j], row[j - 1]
            # STRICT comparisons — whisper's numba dtw prefers the
            # insert/delete steps on cost ties, and median-filtered
            # matrices tie routinely
            if c0 < c1 and c0 < c2:
                best, t = c0, 0
            elif c1 < c2:
                best, t = c1, 1
            else:
                best, t = c2, 2
            row[j] = cost[i - 1, j - 1] + best
            trace[i, j] = t
    i, j = N, M
    text, time = [], []
    while i > 0 and j > 0:
        text.append(i - 1)
        time.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text[::-1]), np.asarray(time[::-1])


def default_alignment_heads(n_layers: int, n_heads: int) -> list[tuple[int, int]]:
    """whisper's fallback when no curated mask ships with the model: every
    head of the upper half of decoder layers."""
    return [(l, h) for l in range(n_layers // 2, n_layers) for h in range(n_heads)]


def load_alignment_heads(
    model_name: str, n_layers: int, n_heads: int
) -> list[tuple[int, int]]:
    """Curated alignment-head pairs for ``model_name``, with the upper-half
    fallback otherwise.

    The released whisper models' alignment masks are REPOSITORY metadata, not
    checkpoint tensors (openai-whisper __init__.py ``_ALIGNMENT_HEADS``), so
    in a zero-egress sandbox they arrive the same way tokenizer ranks do: an
    ``alignment_heads.json`` searched in ``$FREUD_WHISPER_DIR``,
    ``$FREUD_TOKENIZER_DIR``, then the package asset dir. Each entry maps a
    model name to either

    * a list of ``[layer, head]`` pairs, or
    * whisper's published base85-gzip boolean-mask dump string (decoded
      exactly as ``ModelDimensions.set_alignment_heads`` does), so the
      upstream ``_ALIGNMENT_HEADS`` values can be pasted in verbatim.

    ``random:``/``test:`` synthetic-model prefixes are stripped for lookup.
    """
    import base64
    import gzip
    import json
    import os
    from pathlib import Path

    names = [model_name]
    for prefix in ("random:", "test:"):
        if model_name.startswith(prefix):
            names.append(model_name[len(prefix):])
    dirs = []
    for env in ("FREUD_WHISPER_DIR", "FREUD_TOKENIZER_DIR"):
        if os.environ.get(env):
            dirs.append(Path(os.environ[env]))
    dirs.append(Path(__file__).parent / "assets")
    for d in dirs:
        p = d / "alignment_heads.json"
        if not p.exists():
            continue
        try:
            table = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        for name in names:
            entry = table.get(name)
            if entry is None:
                continue
            if isinstance(entry, str):
                mask = np.frombuffer(
                    gzip.decompress(base64.b85decode(entry)), dtype=bool
                ).reshape(n_layers, n_heads)
                return [(l, h) for l in range(n_layers)
                        for h in range(n_heads) if mask[l, h]]
            return [(int(l), int(h)) for l, h in entry]
    return default_alignment_heads(n_layers, n_heads)


def token_times(
    weights: np.ndarray,   # (n_align_heads, n_all_rows, n_frames)
    text_rows,             # row indices that PREDICT the tokens being timed
    num_frames: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """→ (start_times, end_times) in seconds, one per entry of ``text_rows``.

    whisper timing.py find_alignment order, exactly: trim the frame axis to
    the clip's real frames (straight slice — no renormalization), std/mean
    normalize per head over the FULL query-row axis (prompt rows included —
    normalizing over a pre-sliced subset shifts the DTW input), median
    filter, mean over heads, THEN slice the predictor rows for DTW. Row k of
    the attention matrix is the query whose output predicts token k+1, so
    callers pass the PRECEDING row for each timed token (runtime.align_words
    / transcribe_with_word_timestamps handle the shift).
    """
    w = weights.astype(np.float64)
    if num_frames is not None and num_frames < w.shape[-1]:
        w = w[..., :num_frames]
    text_rows = list(text_rows)
    n_tok = len(text_rows)
    if n_tok == 0 or w.shape[-1] == 0:
        # nothing to align (undecodable / sub-frame clip): zero times
        return np.zeros(n_tok), np.zeros(n_tok)
    std = w.std(axis=-2, keepdims=True) + 1e-12
    mean = w.mean(axis=-2, keepdims=True)
    w = (w - mean) / std
    w = median_filter(w)
    matrix = w.mean(axis=0)[text_rows]  # (tokens, frames)
    text_idx, time_idx = dtw(-matrix)
    # first frame index per token = start; last+1 = end (whisper's jump times)
    jumps = np.pad(np.diff(text_idx), (1, 0), constant_values=1).astype(bool)
    jump_times = time_idx[jumps] / TOKENS_PER_SECOND
    starts = jump_times
    ends = np.concatenate(
        [jump_times[1:], [time_idx[-1] / TOKENS_PER_SECOND + 1 / TOKENS_PER_SECOND]]
    )
    return starts, ends


# whisper transcribe.py's word_timestamps defaults
PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"


def merge_punctuations(words: list[dict],
                       prepended: str = PREPEND_PUNCTUATIONS,
                       appended: str = APPEND_PUNCTUATIONS) -> list[dict]:
    """whisper timing.py ``merge_punctuations``: a word that is a lone
    prepending punctuation mark (`` "``, `` (``, …) fuses onto the FOLLOWING
    word; a lone appending mark (``.``, ``,``, ``?``, …) fuses onto the
    PREVIOUS one. The absorber keeps its own times and probability (whisper
    concatenates text/tokens only); emptied entries drop from the list."""
    # backwards pass: prepended marks attach forward
    i, j = len(words) - 2, len(words) - 1
    while i >= 0:
        prev, nxt = words[i], words[j]
        if prev["word"].startswith(" ") and prev["word"].strip() in prepended:
            nxt["word"] = prev["word"] + nxt["word"]
            prev["word"] = ""
        else:
            j = i
        i -= 1
    # forwards pass: appended marks attach backward
    i, j = 0, 1
    while j < len(words):
        prev, nxt = words[i], words[j]
        if not prev["word"].endswith(" ") and nxt["word"] in appended:
            prev["word"] = prev["word"] + nxt["word"]
            nxt["word"] = ""
        else:
            i = j
        j += 1
    return [w for w in words if w["word"]]


def group_words(
    pieces: list[str], starts: np.ndarray, ends: np.ndarray,
    probs: np.ndarray | None = None,
) -> list[dict]:
    """Merge token pieces into words (whisper split_tokens_on_spaces for
    spaced languages: a piece starting with a space — or a ``<tok:`` marker
    when no tokenizer assets exist — begins a new word). The ``word`` field
    RETAINS its leading space, exactly whisper's JSON shape — consumers
    reconstruct segment text with ``''.join(w["word"] for w in words)``.
    ``probs`` (per-token teacher-forced probabilities) adds whisper's
    ``probability`` field: the mean over the word's tokens."""
    words: list[dict] = []
    counts: list[int] = []
    for i, (piece, s, e) in enumerate(zip(pieces, starts, ends)):
        new_word = (
            not words
            or piece.startswith(" ")
            or piece.startswith("<tok:")
        )
        if new_word:
            words.append({"word": piece, "start": float(s), "end": float(e)})
            counts.append(1)
            if probs is not None:
                words[-1]["probability"] = float(probs[i])
        else:
            words[-1]["word"] += piece
            words[-1]["end"] = float(e)
            counts[-1] += 1
            if probs is not None:
                n = counts[-1]
                words[-1]["probability"] += (
                    float(probs[i]) - words[-1]["probability"]) / n
    return words
