"""Batch transcription CLI (PyTorch + CUDA).

The batch mode of ``freud_tpu.scripts.transcribe``: every audio file under
``--data_path`` through the native decoder, the log-mel kernel, the encoder
and the KV-cached decoder (greedy; ``--beam_size`` beam search;
``--fallback`` whisper.transcribe's temperature ladder), on the card unless
``--device cpu`` is given. The tail batch is padded to ``--batch_size``
with copies of its last clip, and an undecodable file maps to
``"<decode-failed>"``.

Usage:
  python -m freud_tpu_torch.scripts.transcribe --data_path DIR [--model tiny]
      [--batch_size 8] [--language en] [--task transcribe|translate]
      [--beam_size 5] [--fallback] [--max_new_tokens 224]
      [--precision float32|bfloat16] [--device cuda|cpu] [--out out.json]

Long-form audio (``--long`` and its options), word timestamps and the
subtitle writers (``--output_format``) are not ported yet: they exit with
an error naming ROADMAP Queue 1 #11.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from ..data.audio_dataset import AudioBatchPipeline
from ..device import resolve_device
from ..models.whisper.runtime import FALLBACK_TEMPERATURES, WhisperRuntime

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the long-form surface of the JAX CLI: flag → its value when unused
LONG_FORM_FLAGS = {"long": False, "word_timestamps": False, "output_format": None,
                   "clip_timestamps": "0", "initial_prompt": None,
                   "carry_initial_prompt": False,
                   "hallucination_silence_threshold": None, "max_line_width": None,
                   "max_line_count": None, "highlight_words": False}


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
    verbose: bool = True,
    device: torch.device | str | None = None,
) -> dict[str, str]:
    """→ {file path: transcript} for every audio file under ``data_path``
    (an undecodable file: ``"<decode-failed>"``). ``device`` None means the
    card."""
    rt = WhisperRuntime(model, compute_dtype=PRECISIONS[precision],
                        max_new_tokens=max_new_tokens, language=language, task=task,
                        device=device)
    rt.decoder  # built here, before the first batch (the runtime builds it lazily)
    pipeline = AudioBatchPipeline(data_path, batch_size, rt.dims.n_mels,
                                  device=rt.device, drop_last=False)
    out: dict[str, str] = {}
    for mels, files, lengths in pipeline:
        n = len(files)
        if n < batch_size:  # pad the tail batch: one decode shape a run
            mels = torch.cat([mels, mels[-1:].expand(batch_size - n, *mels.shape[1:])])
        if fallback or beam_size:
            texts = rt.transcribe_with_fallback(
                mels, beam_size=beam_size,
                temperatures=FALLBACK_TEMPERATURES if fallback else (0.0,))
        else:
            texts = rt.transcribe(mels)
        for f, t, ln in zip(files, texts, lengths):
            out[f] = "<decode-failed>" if ln < 0 else t
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
    ap.add_argument("--out", default=None, help="write {file: text} JSON here")
    # the JAX CLI's long-form surface, refused until it is ported
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--word_timestamps", action="store_true")
    ap.add_argument("--output_format", default=None)
    ap.add_argument("--output_dir", default=".")
    ap.add_argument("--clip_timestamps", default="0")
    ap.add_argument("--initial_prompt", default=None)
    ap.add_argument("--carry_initial_prompt", action="store_true")
    ap.add_argument("--hallucination_silence_threshold", type=float, default=None)
    ap.add_argument("--max_line_width", type=int, default=None)
    ap.add_argument("--max_line_count", type=int, default=None)
    ap.add_argument("--highlight_words", action="store_true")
    args = ap.parse_args(argv)

    used = [f"--{k}" for k, unused in LONG_FORM_FLAGS.items()
            if getattr(args, k) != unused]
    if used:
        ap.error(f"{', '.join(used)}: long-form transcription, word timestamps "
                 "and the subtitle writers are not ported to freud_tpu_torch "
                 "yet (ROADMAP Queue 1 #11)")
    device = resolve_device(args.device, "transcription",
                            hint="pass --device cpu to transcribe on the CPU")
    result = transcribe_folder(
        args.data_path, args.model, args.batch_size, args.language, args.task,
        args.beam_size, args.fallback, args.max_new_tokens, args.precision,
        device=device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
