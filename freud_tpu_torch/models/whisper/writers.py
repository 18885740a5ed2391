"""Transcript output writers: txt / srt / vtt / tsv / json.

The reference surfaces transcripts only as raw strings in its GUI
(src/models/hooked_model.py:103-110 → whisper model.decode), but whisper
users consume ``whisper.utils.get_writer``'s subtitle formats downstream of
any transcription CLI, so ``transcribe_long``'s segment dicts
({"start", "end", "text"} seconds, models/whisper/long_audio.py:206) render
to the same formats here:

  txt   one segment text per line
  srt   1-indexed cues, ``HH:MM:SS,mmm --> HH:MM:SS,mmm`` (hours always)
  vtt   ``WEBVTT`` header, ``MM:SS.mmm`` cues (hours only when nonzero)
  tsv   ``start\\tend\\ttext`` header, integer-millisecond times
  json  the full result dict (segments, statistics, optional words)

Formatting matches whisper's published writer behavior (timestamp layout,
rounding, headers); the implementation is independent. With word timings
present, srt/vtt accept whisper's subtitle options (``max_line_width``,
``max_line_count``, ``highlight_words``) and split cues on word boundaries.
"""

from __future__ import annotations

import json
from pathlib import Path


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    """``[HH:]MM:SS<marker>mmm`` with millisecond rounding (whisper's
    subtitle timestamp layout: srt passes hours+comma, vtt dot)."""
    if seconds < 0:
        raise ValueError("non-negative timestamp expected")
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def _segments(result: dict) -> list[dict]:
    segs = result.get("segments")
    if segs is None:
        raise ValueError(
            "this output format needs timed segments — transcribe with the "
            "long-audio path (--long), which yields {'start','end','text'} "
            "segments per window"
        )
    return segs


def write_txt(result: dict) -> str:
    if result.get("segments") is None:
        return str(result.get("text", "")).strip() + "\n"
    return "".join(s["text"].strip() + "\n" for s in _segments(result))


def _subtitle_cues(result: dict, max_line_width: int | None,
                   max_line_count: int | None,
                   highlight_words: bool) -> list[tuple[float, float, str]]:
    """(start, end, text) cue list. With word timings present and any
    subtitle option set, cues split on word boundaries (whisper
    SubtitlesWriter.iterate_result: a line breaks at ``max_line_width``
    chars, a cue at ``max_line_count`` lines or a new segment;
    ``highlight_words`` additionally emits one cue per word with the
    current word <u>underlined</u>, karaoke-style). Otherwise cues are the
    segments as-is."""
    segs = _segments(result)
    word_mode = (max_line_width or max_line_count or highlight_words) and \
        any(s.get("words") for s in segs)
    if not word_mode:
        return [(s["start"], s["end"], s["text"].strip()) for s in segs]

    max_w = max_line_width or 1000
    max_c = max_line_count or 1000
    cues: list[tuple[float, float, str]] = []
    # flatten to (word, start, end) keeping segment boundaries as cue breaks
    for s in segs:
        words = s.get("words") or []
        if not words:  # a segment without words stays a plain cue
            cues.append((s["start"], s["end"], s["text"].strip()))
            continue
        lines: list[list[dict]] = [[]]
        width = 0
        for wd in words:
            token = wd["word"]
            if lines[-1] and width + len(token) > max_w:
                lines.append([])
                width = 0
            lines[-1].append(wd)
            width += len(token)
        # group lines into cues of max_c lines
        for c0 in range(0, len(lines), max_c):
            block = lines[c0:c0 + max_c]
            flat = [wd for ln in block for wd in ln]
            text = "\n".join("".join(w["word"] for w in ln).strip()
                             for ln in block)
            if highlight_words:
                for wi, wd in enumerate(flat):
                    marked = "\n".join(
                        "".join(
                            (f"<u>{w['word']}</u>" if w is wd else w["word"])
                            for w in ln).strip()
                        for ln in block)
                    w_end = (flat[wi + 1]["start"] if wi + 1 < len(flat)
                             else wd["end"])
                    cues.append((wd["start"], max(w_end, wd["start"]), marked))
            else:
                cues.append((flat[0]["start"], flat[-1]["end"], text))
    return cues


def write_srt(result: dict, max_line_width: int | None = None,
              max_line_count: int | None = None,
              highlight_words: bool = False) -> str:
    out = []
    cues = _subtitle_cues(result, max_line_width, max_line_count,
                          highlight_words)
    for i, (t0, t1, text) in enumerate(cues, start=1):
        start = format_timestamp(t0, True, ",")
        end = format_timestamp(t1, True, ",")
        out.append(f"{i}\n{start} --> {end}\n{text}\n")
    return "\n".join(out)


def write_vtt(result: dict, max_line_width: int | None = None,
              max_line_count: int | None = None,
              highlight_words: bool = False) -> str:
    out = ["WEBVTT\n"]
    cues = _subtitle_cues(result, max_line_width, max_line_count,
                          highlight_words)
    for t0, t1, text in cues:
        out.append(f"{format_timestamp(t0)} --> {format_timestamp(t1)}\n"
                   f"{text}\n")
    return "\n".join(out)


def write_tsv(result: dict) -> str:
    """Integer-millisecond start/end columns (whisper's WriteTSV layout);
    tabs/newlines inside text are flattened so rows stay 3-column."""
    lines = ["start\tend\ttext"]
    for s in _segments(result):
        text = s["text"].strip().replace("\t", " ").replace("\n", " ")
        lines.append(f"{round(1000 * s['start'])}\t{round(1000 * s['end'])}\t{text}")
    return "\n".join(lines) + "\n"


def write_json(result: dict) -> str:
    return json.dumps(result, ensure_ascii=False, indent=1) + "\n"


_WRITERS = {
    "txt": write_txt,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
    "json": write_json,
}

OUTPUT_FORMATS = tuple(_WRITERS)


def get_writer(output_format: str):
    """→ ``fn(result_dict) -> str`` for one of ``OUTPUT_FORMATS``."""
    try:
        return _WRITERS[output_format]
    except KeyError:
        raise ValueError(
            f"output_format must be one of {sorted(_WRITERS)}, "
            f"got {output_format!r}"
        ) from None


def write_result(result: dict, audio_path: str, output_dir: str | Path,
                 output_format: str, **subtitle_options) -> Path:
    """Render ``result`` for ``audio_path`` into
    ``output_dir/<stem>.<format>`` and return the written path.
    ``subtitle_options`` (max_line_width / max_line_count /
    highlight_words — whisper's writer options) apply to srt/vtt only."""
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / (Path(audio_path).stem + "." + output_format)
    fn = get_writer(output_format)
    opts = {k: v for k, v in subtitle_options.items() if v}
    text = fn(result, **opts) if output_format in ("srt", "vtt") and opts \
        else fn(result)
    target.write_text(text, encoding="utf-8")
    return target
