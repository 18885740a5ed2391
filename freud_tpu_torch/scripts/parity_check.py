"""Real-weights parity check — run this where the real assets are.

The port of ``freud_tpu/scripts/parity_check.py``, on the port's own
modules (torch; no JAX). Decode behaviour is pinned to whisper's published
rules through synthetic weights in the tests; this CLI runs the same ladder
against real assets with human-readable output:

  1. mel oracle          (needs only the bundled flac + torch)
  2. encoder golden      (needs $FREUD_WHISPER_DIR/<model>.pt + openai-whisper)
  3. suppression diff    (needs tokenizer ranks + openai-whisper)
  4. transcript + WER    (needs weights + ranks + the clip's reference text)
  5. word timestamps     (needs weights + ranks)

Check 1 computes the port's log-mel of the port's copy of the bundled clip
(``freud_tpu_torch/assets/example_audio.flac``) on ``--device`` (the CUDA
log-mel kernel on the card, its plain version on the CPU) against a
``torch.stft`` oracle. Checks 2-5 report "skipped" when their assets are
missing, as the JAX package's do.

Asset layout:
  $FREUD_WHISPER_DIR/tiny.pt ...           OpenAI checkpoints
  $FREUD_TOKENIZER_DIR/multilingual.tiktoken   BPE ranks
  <flac dir>/8280-266249-0065.txt          reference transcript
  (or $FREUD_EXPECTED_TRANSCRIPT)

Usage: python -m freud_tpu_torch.scripts.parity_check [--model tiny]
           [--audio f.flac] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device


def _default_flac() -> str:
    return str(Path(__file__).parent.parent / "assets" / "example_audio.flac")


def check_mel(audio_path: str, device: torch.device) -> bool:
    from ..audio.decode import load_audio
    from ..audio.filters import mel_filterbank
    from ..audio.mel import mels_from_array, pad_or_trim

    raw = load_audio(audio_path)
    got = mels_from_array(raw, 80, device=device).cpu().numpy()
    t = torch.from_numpy(np.asarray(pad_or_trim(raw), np.float32))
    stft = torch.stft(t, 400, 160, window=torch.hann_window(400),
                      center=True, return_complex=True)
    mag = stft[..., :-1].abs() ** 2
    mel = torch.from_numpy(np.array(mel_filterbank(80))) @ mag
    log_spec = torch.clamp(mel, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    want = ((log_spec + 4.0) / 4.0).numpy()
    err = float(np.abs(got - want).max())
    print(f"[mel]         max |Δ| vs torch.stft oracle: {err:.2e} "
          f"({'OK' if err < 5e-4 else 'FAIL'})")
    return err < 5e-4


def check_encoder(model: str, audio_path: str, device: torch.device) -> bool | None:
    from ..models.whisper.load import find_checkpoint

    if find_checkpoint(model) is None:
        print(f"[encoder]     skipped: no {model}.pt under $FREUD_WHISPER_DIR")
        return None
    if importlib.util.find_spec("whisper") is None:
        print("[encoder]     skipped: openai-whisper not installed")
        return None
    import whisper as openai_whisper

    from ..audio.decode import load_audio
    from ..audio.mel import mels_from_array
    from ..models.whisper import encoder_forward
    from ..models.whisper.load import load_model

    encoder, dims = load_model(model, device=device)
    mel = mels_from_array(load_audio(audio_path), dims.n_mels, device=device)
    with torch.no_grad():
        ours, _ = encoder_forward(encoder, dims, mel[None])
        ref = openai_whisper.load_model(
            model, device="cpu", download_root=os.environ.get("FREUD_WHISPER_DIR"))
        theirs = ref.encoder(mel[None].cpu()).numpy()
    err = float(np.abs(ours.cpu().numpy() - theirs).max())
    print(f"[encoder]     max |Δ| vs openai-whisper: {err:.2e} "
          f"({'OK' if err < 5e-2 else 'FAIL'})")
    return err < 5e-2


def check_suppression() -> bool | None:
    from ..models.whisper.tokenizer import (_rank_file_candidates,
                                            non_speech_token_ids)

    if not any(p.exists() for p in _rank_file_candidates(True)):
        print("[suppression] skipped: no multilingual.tiktoken ranks")
        return None
    if importlib.util.find_spec("whisper") is None:
        print("[suppression] skipped: openai-whisper not installed")
        return None
    from whisper.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=True, num_languages=99)
    ours = set(non_speech_token_ids(51865) or ())
    theirs = set(tok.non_speech_tokens)
    extra, missing = sorted(ours - theirs), sorted(theirs - ours)
    ok = not extra and not missing
    print(f"[suppression] non-speech list: {'identical' if ok else 'DIFFERS'}"
          + ("" if ok else f" extra={extra[:8]} missing={missing[:8]}"))
    return ok


def _assets_for_decode(model: str) -> bool:
    from ..models.whisper.load import find_checkpoint
    from ..models.whisper.tokenizer import _rank_file_candidates

    return find_checkpoint(model) is not None and any(
        p.exists() for p in _rank_file_candidates(True))


def check_transcript(model: str, audio_path: str, device: torch.device) -> bool | None:
    if not _assets_for_decode(model):
        print("[transcript]  skipped: needs weights + tokenizer ranks")
        return None
    from ..analysis.wer import find_reference_transcript, word_error_rate
    from ..audio.decode import load_audio
    from ..models.whisper.runtime import WhisperRuntime

    rt = WhisperRuntime(model, language="en", device=device)
    out = rt.transcribe_long(load_audio(audio_path))
    print(f"[transcript]  {out['text'].strip()!r}")

    expected = find_reference_transcript(audio_path)
    if not expected:
        print("[wer]         skipped: no reference transcript asset")
        return bool(out["text"].strip())
    wer = word_error_rate(expected, out["text"])
    budget = float(os.environ.get("FREUD_PARITY_WER_MAX", "0.3"))
    print(f"[wer]         {wer:.3f} (budget {budget}) "
          f"({'OK' if wer <= budget else 'FAIL'})")
    return wer <= budget


def check_words(model: str, audio_path: str, device: torch.device) -> bool | None:
    if not _assets_for_decode(model):
        print("[words]       skipped: needs weights + tokenizer ranks")
        return None
    from ..audio.decode import load_audio
    from ..models.whisper.runtime import WhisperRuntime

    rt = WhisperRuntime(model, language="en", device=device)
    out = rt.transcribe_long(load_audio(audio_path), word_timestamps=True)
    if not out["segments"]:
        print("[words]       FAIL: no segments")
        return False
    probs = []
    ok = True
    for s in out["segments"]:
        if "".join(w["word"] for w in s["words"]) != s["text"]:
            ok = False
        starts = [w["start"] for w in s["words"]]
        if starts != sorted(starts):
            ok = False
        probs += [w["probability"] for w in s["words"]]
    med = float(np.median(probs)) if probs else 0.0
    ok = ok and med > 0.3
    print(f"[words]       text-reconstruction + monotone times, median "
          f"word prob {med:.2f} ({'OK' if ok else 'FAIL'})")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default=os.environ.get("FREUD_PARITY_MODEL",
                                                      "tiny"))
    ap.add_argument("--audio", default=_default_flac())
    ap.add_argument("--device", default="cuda",
                    help="cpu or cuda[:N] (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, what="parity check",
                         hint="pass --device cpu to run the checks on the CPU")

    results = [
        check_mel(args.audio, dev),
        check_encoder(args.model, args.audio, dev),
        check_suppression(),
        check_transcript(args.model, args.audio, dev),
        check_words(args.model, args.audio, dev),
    ]
    ran = [r for r in results if r is not None]
    print(f"\n{sum(ran)}/{len(ran)} checks passed "
          f"({len(results) - len(ran)} skipped for missing assets)")
    return 0 if all(ran) else 1


if __name__ == "__main__":
    sys.exit(main())
