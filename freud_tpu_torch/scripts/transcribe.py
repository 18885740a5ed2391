"""Batch and long-form transcription CLI (PyTorch + CUDA).

The port of ``freud_tpu.scripts.transcribe``, on the card unless
``--device cpu`` is given. Batch mode: every audio file under
``--data_path`` through the native decoder, the log-mel kernel, the encoder
and the KV-cached decoder (greedy; ``--beam_size`` beam search;
``--fallback`` whisper.transcribe's temperature ladder;
``--word_timestamps`` per-word times from one alignment pass a batch). The
tail batch is padded to ``--batch_size`` with copies of its last clip, and
an undecodable file maps to ``"<decode-failed>"``. ``--long``: whisper's
30-s seek loop over files of any length (``long_audio.py``), with the
per-window ladder, timed segments and its options.

Usage:
  python -m freud_tpu_torch.scripts.transcribe --data_path DIR [--model tiny]
      [--batch_size 8] [--language en] [--task transcribe|translate]
      [--beam_size 5] [--fallback] [--word_timestamps] [--max_new_tokens 224]
      [--precision float32|bfloat16] [--device cuda|cpu] [--out out.json]
      [--long [--clip_timestamps S,E,…] [--initial_prompt TEXT]
       [--carry_initial_prompt] [--hallucination_silence_threshold S]]
      [--output_format txt|srt|vtt|tsv|json --output_dir D
       [--max_line_width N] [--max_line_count N] [--highlight_words]]

srt, vtt and tsv render ``--long``'s timed segments
(``models/whisper/writers.py``).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ..analysis.features import activation_length_from_samples
from ..data.audio_dataset import AudioBatchPipeline
from ..device import resolve_device
from ..models.whisper.runtime import FALLBACK_TEMPERATURES, WhisperRuntime

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def transcribe_folder(
    data_path: str,
    model: str = "tiny",
    batch_size: int = 8,
    language: Optional[str] = None,
    task: str = "transcribe",
    beam_size: Optional[int] = None,
    fallback: bool = False,
    max_new_tokens: int = 224,
    precision: str = "float32",
    word_timestamps: bool = False,
    verbose: bool = True,
    device: torch.device | str | None = None,
) -> dict:
    """→ {file path: transcript} — or, with ``word_timestamps``, {file path:
    {"text", "words": [{"word", "start", "end", "probability"}, …]}} — for
    every audio file under ``data_path`` (an undecodable file:
    ``"<decode-failed>"``). ``device`` None means the card."""
    if word_timestamps and (beam_size or fallback):
        raise SystemExit(
            "--word_timestamps uses the greedy alignment path and cannot "
            "combine with --beam_size/--fallback in batch mode (use --long, "
            "whose per-window ladder composes with word timestamps)")
    rt = WhisperRuntime(model, compute_dtype=PRECISIONS[precision],
                        max_new_tokens=max_new_tokens, language=language, task=task,
                        device=device)
    rt.decoder  # built here, before the first batch (the runtime builds it lazily)
    pipeline = AudioBatchPipeline(data_path, batch_size, rt.dims.n_mels,
                                  device=rt.device, drop_last=False)
    out: dict = {}
    for mels, files, lengths in pipeline:
        n = len(files)
        if n < batch_size:  # pad the tail batch: one decode shape a run
            mels = torch.cat([mels, mels[-1:].expand(batch_size - n, *mels.shape[1:])])
        words = None
        if word_timestamps:
            n_frames = np.array(
                [activation_length_from_samples(max(int(ln), 0)) for ln in lengths]
                + [rt.dims.n_audio_ctx] * (batch_size - n))
            texts, words = rt.transcribe_with_word_timestamps(mels, num_frames=n_frames)
        elif fallback or beam_size:
            texts = rt.transcribe_with_fallback(
                mels, beam_size=beam_size,
                temperatures=FALLBACK_TEMPERATURES if fallback else (0.0,))
        else:
            texts = rt.transcribe(mels)
        for j, (f, t, ln) in enumerate(zip(files, texts, lengths)):
            if ln < 0:
                out[f] = "<decode-failed>"
            elif words is not None:
                out[f] = {"text": t, "words": words[j]}
            else:
                out[f] = t
            if verbose:
                print(json.dumps({"file": f, "result": out[f]}))
    return out


def transcribe_folder_long(
    data_path: str,
    model: str = "tiny",
    language: Optional[str] = None,
    max_new_tokens: int = 224,
    precision: str = "float32",
    verbose: bool = True,
    beam_size: Optional[int] = None,
    word_timestamps: bool = False,
    task: str = "transcribe",
    clip_timestamps: str = "0",
    hallucination_silence_threshold: Optional[float] = None,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    device: torch.device | str | None = None,
) -> dict:
    """→ {file: {"text", "segments", "language"}} through the 30-s seek loop
    (``WhisperRuntime.transcribe_long``): files of any duration, every
    window through the temperature ladder (``beam_size`` makes its t = 0
    rung beam search), ``word_timestamps`` adds per-word times to every
    segment. An undecodable file: ``"<decode-failed>"``."""
    from ..audio.decode import load_audio
    from ..data.audio_dataset import list_audio_files

    rt = WhisperRuntime(model, compute_dtype=PRECISIONS[precision],
                        max_new_tokens=max_new_tokens, language=language, task=task,
                        device=device)
    out: dict = {}
    for f in list_audio_files(data_path):
        try:
            audio = load_audio(f)
        except RuntimeError:
            out[f] = "<decode-failed>"
            continue
        out[f] = rt.transcribe_long(
            audio, beam_size=beam_size, word_timestamps=word_timestamps,
            clip_timestamps=clip_timestamps,
            hallucination_silence_threshold=hallucination_silence_threshold,
            initial_prompt=initial_prompt,
            carry_initial_prompt=carry_initial_prompt)
        if verbose:
            print(json.dumps({"file": f, "result": out[f]}))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--language", default=None)
    ap.add_argument("--task", default="transcribe", choices=("transcribe", "translate"),
                    help="whisper DecodingOptions.task")
    ap.add_argument("--beam_size", type=int, default=None)
    ap.add_argument("--fallback", action="store_true",
                    help="temperature-fallback ladder (whisper.transcribe)")
    ap.add_argument("--max_new_tokens", type=int, default=224)
    ap.add_argument("--precision", default="float32", choices=sorted(PRECISIONS))
    ap.add_argument("--device", default=None,
                    help="cuda[:N] (the default) or cpu; without a CUDA card "
                         "only cpu runs")
    ap.add_argument("--word_timestamps", action="store_true",
                    help="cross-attention DTW word timings per file")
    ap.add_argument("--long", action="store_true",
                    help="30-s seek loop for arbitrary-length audio "
                         "(whisper.transcribe); yields timed segments")
    ap.add_argument("--clip_timestamps", default="0",
                    help="whisper's clip option: 'start,end,start,end,…' "
                         "seconds; transcribe only these ranges (--long)")
    ap.add_argument("--initial_prompt", default=None,
                    help="text to condition the first window on (whisper's "
                         "option; --long, needs tokenizer assets)")
    ap.add_argument("--carry_initial_prompt", action="store_true",
                    help="re-prefix --initial_prompt onto EVERY window's "
                         "conditioning (whisper's option)")
    ap.add_argument("--hallucination_silence_threshold", type=float, default=None,
                    help="whisper's option: with --long --word_timestamps, "
                         "skip silent gaps longer than this (seconds) when "
                         "an anomalous (probable-hallucination) segment is "
                         "detected")
    ap.add_argument("--out", default=None, help="write {file: text} JSON here")
    ap.add_argument("--output_format", default=None,
                    choices=["txt", "srt", "vtt", "tsv", "json"],
                    help="per-file transcript files (whisper-CLI formats; "
                         "srt/vtt/tsv need --long's timed segments)")
    ap.add_argument("--output_dir", default=".",
                    help="directory for --output_format files")
    ap.add_argument("--max_line_width", type=int, default=None,
                    help="srt/vtt: break subtitle lines at this many chars "
                         "(word-boundary cues; needs --word_timestamps)")
    ap.add_argument("--max_line_count", type=int, default=None,
                    help="srt/vtt: max lines per subtitle cue")
    ap.add_argument("--highlight_words", action="store_true",
                    help="srt/vtt: one cue per word with the current word "
                         "underlined (karaoke; needs --word_timestamps)")
    args = ap.parse_args(argv)

    if args.output_format in ("srt", "vtt", "tsv") and not args.long:
        ap.error(f"--output_format {args.output_format} needs the timed "
                 "segments of --long")
    device = resolve_device(args.device, "transcription",
                            hint="pass --device cpu to transcribe on the CPU")
    if args.long:
        result = transcribe_folder_long(
            args.data_path, args.model, args.language, args.max_new_tokens,
            args.precision, beam_size=args.beam_size,
            word_timestamps=args.word_timestamps, task=args.task,
            clip_timestamps=args.clip_timestamps,
            hallucination_silence_threshold=args.hallucination_silence_threshold,
            initial_prompt=args.initial_prompt,
            carry_initial_prompt=args.carry_initial_prompt, device=device)
    else:
        result = transcribe_folder(
            args.data_path, args.model, args.batch_size, args.language, args.task,
            args.beam_size, args.fallback, args.max_new_tokens, args.precision,
            args.word_timestamps, device=device)
    if args.output_format:
        from ..models.whisper.writers import write_result

        for path, res in result.items():
            if not isinstance(res, dict):  # batch mode / decode failures
                res = {"text": res if isinstance(res, str) else str(res)}
            write_result(res, path, args.output_dir, args.output_format,
                         max_line_width=args.max_line_width,
                         max_line_count=args.max_line_count,
                         highlight_words=args.highlight_words)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
