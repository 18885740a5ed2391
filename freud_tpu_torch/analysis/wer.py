"""Word error rate for transcript parity checks.

The reference never computes WER (its GUI just displays transcripts), but
the real-weights parity suite (tests/test_real_weights_parity.py,
scripts/parity_check.py) needs a dependency-free metric to score our decode
of the bundled LibriSpeech clip against its known text. Standard Levenshtein
over normalized word sequences.
"""

from __future__ import annotations

import re


def normalize_text(text: str) -> list[str]:
    """Lowercase, strip punctuation (keep intra-word apostrophes), split.

    A deliberately simple normalizer (whisper's EnglishTextNormalizer is a
    large rule table; this is the standard LibriSpeech-style fold) — parity
    thresholds in the suite account for the difference.
    """
    text = text.lower()
    text = re.sub(r"[^a-z0-9' ]+", " ", text)
    text = re.sub(r"(?<![a-z])'|'(?![a-z])", " ", text)  # keep don't, drop 'em quotes
    return text.split()


def word_error_rate(reference: str, hypothesis: str) -> float:
    """Levenshtein word distance / reference length (0.0 = exact)."""
    ref = normalize_text(reference)
    hyp = normalize_text(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    prev = list(range(len(hyp) + 1))
    for i, rw in enumerate(ref, 1):
        cur = [i]
        for j, hw in enumerate(hyp, 1):
            cur.append(min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (rw != hw),  # substitution / match
            ))
        prev = cur
    return prev[-1] / len(ref)


def find_reference_transcript(audio_path: str) -> str | None:
    """Resolve the known transcript asset for ``audio_path``.

    Shared by the parity test suite and scripts/parity_check.py so both
    surfaces agree on precedence: $FREUD_EXPECTED_TRANSCRIPT (literal text)
    first, then the FIRST match of <stem>.txt / <stem>.trans.txt next to the
    audio file, then the same names under $FREUD_WHISPER_DIR.
    """
    import os
    from pathlib import Path

    if os.environ.get("FREUD_EXPECTED_TRANSCRIPT"):
        return os.environ["FREUD_EXPECTED_TRANSCRIPT"]
    stem = Path(audio_path).stem
    for d in (Path(audio_path).parent,
              Path(os.environ.get("FREUD_WHISPER_DIR", "/nonexistent"))):
        for name in (f"{stem}.txt", f"{stem}.trans.txt"):
            p = d / name
            if p.exists():
                return p.read_text().strip()
    return None
