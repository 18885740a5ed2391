"""Host-side audio decode.

The same decoder and fallback chain as ``freud_tpu/audio/decode.py``: the
in-process native decoder ``libfreud_audio.so`` (libavformat demux +
libavcodec decode + libswresample mono/16 kHz resample, with a threaded batch
API that fills one contiguous float32 buffer per batch), then stdlib ``wave``
for PCM WAV files, then the ffmpeg CLI if present; ``audio_duration_s``
reads a file's duration from its header.

The native library is built from the port's copy of the decoder sources
(``freud_tpu_torch/audio/native/``) into ``freud_tpu_torch/_build/`` — see
``freud_tpu_torch/_native.py``. Its Makefile links the ffmpeg libraries;
where they are missing the build fails and WAV files decode through
``wave``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import wave
from typing import Optional, Sequence

import numpy as np

from .._native import build_audio_decoder
from ..constants import N_SAMPLES, SAMPLE_RATE

_lib = None
_lib_checked = False
_lib_lock = threading.Lock()


def native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native decoder; None if unavailable.

    Serialized behind a lock: the first call may run the build, during
    which a concurrent caller (the prefetch producer vs the main thread)
    must WAIT for it rather than observe a half-initialized "checked, no
    lib" state and silently fall back."""
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    with _lib_lock:
        if _lib_checked:
            return _lib
        _lib = _load_native()
        _lib_checked = True
        return _lib


def _load_native() -> Optional[ctypes.CDLL]:
    if os.environ.get("FREUD_DISABLE_NATIVE_AUDIO"):
        return None
    path = build_audio_decoder()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.fa_decode.restype = ctypes.c_int
    lib.fa_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fa_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.fa_duration.restype = ctypes.c_double
    lib.fa_duration.argtypes = [ctypes.c_char_p]
    lib.fa_decode_batch.restype = ctypes.c_int
    lib.fa_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.fa_last_error.restype = ctypes.c_char_p
    return lib


def _decode_wave(file: str, sr: int) -> np.ndarray:
    with wave.open(file, "rb") as w:
        n_ch, sampwidth, rate, n_frames = (
            w.getnchannels(),
            w.getsampwidth(),
            w.getframerate(),
            w.getnframes(),
        )
        raw = w.readframes(n_frames)
    if sampwidth == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise RuntimeError(f"unsupported WAV sample width {sampwidth}")
    if n_ch > 1:
        audio = audio.reshape(-1, n_ch).mean(axis=1)
    if rate != sr:
        n_out = int(round(len(audio) * sr / rate))
        audio = np.interp(
            np.linspace(0, len(audio) - 1, n_out), np.arange(len(audio)), audio
        ).astype(np.float32)
    return audio


def _decode_ffmpeg_cli(file: str, sr: int) -> np.ndarray:
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", file,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, np.int16).astype(np.float32) / 32768.0


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Decode ``file`` to a mono float32 waveform at ``sr`` Hz."""
    lib = native_lib()
    if lib is not None:
        out_ptr = ctypes.POINTER(ctypes.c_float)()
        out_len = ctypes.c_int64()
        rc = lib.fa_decode(
            os.fsencode(file), sr, ctypes.byref(out_ptr), ctypes.byref(out_len)
        )
        if rc == 0:
            audio = np.ctypeslib.as_array(out_ptr, shape=(out_len.value,)).copy()
            lib.fa_free(out_ptr)
            return audio
        raise RuntimeError(
            f"Failed to load audio {file}: {lib.fa_last_error().decode()}"
        )
    # fallback decoders raise their own exception types (wave.Error,
    # EOFError, CalledProcessError, OSError); normalize to the documented
    # RuntimeError contract so per-file degrade paths (load_audio_batch,
    # the upload endpoint's 400) catch every backend the same way
    if file.lower().endswith(".wav"):
        try:
            return _decode_wave(file, sr)
        except Exception as wave_err:  # noqa: BLE001 — 24-bit/float WAVs etc.
            # the stdlib module can't read every WAV (24-bit PCM, IEEE
            # float): fall through to the ffmpeg CLI before giving up
            if not shutil.which("ffmpeg"):
                raise RuntimeError(
                    f"Failed to load audio {file}: {wave_err!r}"
                ) from wave_err
    try:
        if shutil.which("ffmpeg"):
            return _decode_ffmpeg_cli(file, sr)
    except Exception as e:  # noqa: BLE001 — normalize to the documented type
        raise RuntimeError(f"Failed to load audio {file}: {e!r}") from e
    raise RuntimeError(
        f"No audio decode backend available for {file} "
        "(native libfreud_audio.so missing and not a PCM WAV)"
    )


def load_audio_batch(
    files: Sequence[str],
    sr: int = SAMPLE_RATE,
    frame_len: int = N_SAMPLES,
    n_threads: Optional[int] = None,
    out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of files into one (len(files), frame_len) float32 buffer.

    Returns (buffer, true_lengths). Each row is zero-padded / truncated to
    ``frame_len`` — exactly the pad-or-trim geometry the encoder consumes, so
    the result can go straight to the device with no per-file copies.
    ``true_lengths[i]`` is the untruncated decoded sample count (-1 on failure).
    ``out``: a C-contiguous float32 (len(files), frame_len) buffer to decode
    into (the pipeline passes a view of pinned host memory); it is zeroed
    first.
    """
    n = len(files)
    if out is None:
        buf = np.zeros((n, frame_len), dtype=np.float32)
    else:
        if (out.shape != (n, frame_len) or out.dtype != np.float32
                or not out.flags.c_contiguous):
            raise ValueError(
                f"out must be C-contiguous float32 {(n, frame_len)}, got "
                f"{out.dtype} {out.shape}")
        buf = out
        buf.fill(0.0)
    lengths = np.zeros(n, dtype=np.int64)
    lib = native_lib()
    if lib is not None and n > 0:
        if n_threads is None:
            n_threads = min(8, max(1, (os.cpu_count() or 1)))
        # os.fsencode round-trips non-UTF-8 filenames (surrogateescape);
        # str.encode would raise UnicodeEncodeError and abort the whole batch
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(f) for f in files])
        lib.fa_decode_batch(
            c_paths,
            n,
            sr,
            frame_len,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads,
        )
        return buf, lengths
    for i, f in enumerate(files):
        try:
            audio = load_audio(f, sr)
        except RuntimeError:
            lengths[i] = -1
            continue
        lengths[i] = len(audio)
        m = min(frame_len, len(audio))
        buf[i, :m] = audio[:m]
    return buf, lengths


def audio_duration_s(file: str) -> float:
    """Duration in seconds from container metadata, without a full decode
    (the native library's ``fa_duration``); a PCM WAV's header through
    ``wave`` where the library is absent, else a full decode. Search reads
    it only for a store without ``n_frames``."""
    lib = native_lib()
    if lib is not None:
        dur = lib.fa_duration(os.fsencode(file))
        if dur >= 0:
            return float(dur)
    if file.lower().endswith(".wav"):
        with wave.open(file, "rb") as w:
            return w.getnframes() / w.getframerate()
    return len(load_audio(file)) / SAMPLE_RATE
