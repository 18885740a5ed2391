"""Log-mel spectrogram front end, as plain PyTorch.

The same DSP pipeline as ``freud_tpu/audio/mel.py`` — periodic Hann window,
centered STFT (reflect padding) with N_FFT=400 / HOP_LENGTH=160, last frame
dropped, power magnitudes, Slaney mel filterbank, ``log10(clamp(1e-10))``, an
8-decade dynamic-range floor relative to the per-clip max, and the
``(x + 4) / 4`` affine — expressed as framed matmuls against an explicit
real-DFT basis.

``log_mel_spectrogram`` is the plain version of the CUDA log-mel kernel
(``freud_tpu_torch/ops/mel.py``): the CPU path runs it, and the kernel is
held against it on the card. Its DFT and mel projection are float32 matmuls,
which stay true f32 (the ``Precision.HIGHEST`` of the JAX version) as long
as ``torch.backends.cuda.matmul.allow_tf32`` keeps its default, False.
``batched_log_mel`` dispatches on the tensor's device: CUDA → the kernel,
CPU → the plain path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES
from .filters import mel_filterbank

N_FREQS = N_FFT // 2 + 1  # 201 one-sided bins


@lru_cache(maxsize=None)
def _dft_basis() -> np.ndarray:
    """Windowed real-DFT analysis basis, shape (N_FFT, 2 * N_FREQS).

    Column block [0:201] = cos terms, [201:402] = -sin terms, each pre-scaled
    by the periodic Hann window so framing + windowing + DFT is one matmul.
    """
    n = np.arange(N_FFT, dtype=np.float64)
    k = np.arange(N_FREQS, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / N_FFT
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))  # periodic Hann
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    out = (basis * hann[:, None]).astype(np.float32)
    out.setflags(write=False)  # cached: shared by every caller
    return out


def reflect_pad_center(audio: torch.Tensor) -> torch.Tensor:
    """Center the STFT: reflect-pad N_FFT//2 samples on both ends (last axis)."""
    pad = N_FFT // 2
    flat = audio.reshape(-1, audio.shape[-1])
    padded = F.pad(flat, (pad, pad), mode="reflect")
    return padded.reshape(*audio.shape[:-1], padded.shape[-1])


def frame_signal(padded: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Overlapping (…, n_frames, N_FFT) frames of a padded (…, samples) signal
    (zero-extended at the end when it is too short). A strided view."""
    need = (n_frames - 1) * HOP_LENGTH + N_FFT
    extra = need - padded.shape[-1]
    if extra > 0:
        padded = F.pad(padded, (0, extra))
    return padded.unfold(-1, N_FFT, HOP_LENGTH)[..., :n_frames, :]


def power_spectrogram(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """|STFT|^2 of a (…, samples) waveform → (…, n_frames, N_FREQS)."""
    frames = frame_signal(reflect_pad_center(audio), n_frames)
    return framed_power(frames)


def framed_power(frames: torch.Tensor) -> torch.Tensor:
    """|DFT|² of already-framed (…, T, N_FFT) windows → (…, T, N_FREQS)."""
    basis = torch.tensor(_dft_basis(), device=frames.device)
    proj = torch.matmul(frames, basis)
    re, im = proj[..., :N_FREQS], proj[..., N_FREQS:]
    return re * re + im * im


def framed_log10_mel(frames: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(…, T, N_FFT) framed windows → (…, T, n_mels) UNFLOORED log10-mel."""
    fb = torch.tensor(mel_filterbank(n_mels).T, device=frames.device)
    mel = torch.matmul(framed_power(frames), fb)
    return torch.log10(torch.clamp(mel, min=1e-10))


def log_mel_spectrogram(
    audio: torch.Tensor, n_mels: int = 80, n_frames: int = N_FRAMES
) -> torch.Tensor:
    """Whisper-style log-mel of (…, N_SAMPLES) audio → (…, n_mels, n_frames).

    The dynamic-range floor (max - 8) is applied per clip.
    """
    audio = audio.to(torch.float32)
    frames = frame_signal(reflect_pad_center(audio), n_frames)
    log_spec = framed_log10_mel(frames, n_mels)  # (…, T, n_mels)
    peak = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(-1, -2)  # (…, n_mels, T)


def pad_or_trim(array: np.ndarray, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad with zeros or truncate along ``axis`` to exactly ``length`` samples."""
    n = array.shape[axis]
    if n > length:
        array = np.take(array, np.arange(length), axis=axis)
    elif n < length:
        widths = [(0, 0)] * array.ndim
        widths[axis] = (0, length - n)
        array = np.pad(array, widths)
    return array


def trim_audio(
    array: np.ndarray, start_time: float, end_time: float, sample_rate: int = 16_000
) -> np.ndarray:
    """Slice a waveform to a [start, end] second range."""
    return array[int(sample_rate * start_time) : int(sample_rate * end_time)]


def batched_log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, N_SAMPLES) → (B, n_mels, N_FRAMES), dispatched on the device:
    the CUDA log-mel kernel for a CUDA tensor, the plain path on the CPU."""
    from ..ops.mel import log_mel_spectrogram_cuda

    return log_mel_spectrogram_cuda(audio, n_mels)


def mels_from_array(
    audio: np.ndarray, n_mels: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Pad/trim a 1-D waveform to 30 s and compute its log-mel on ``device``."""
    if n_mels not in (80, 128):
        # whisper models use exactly these two banks; a silent 128-mel
        # fallback for any other value would feed wrong-width features
        raise ValueError(f"n_mels must be 80 or 128, got {n_mels}")
    audio = pad_or_trim(np.asarray(audio, dtype=np.float32).reshape(-1))
    x = torch.from_numpy(audio).to(device)
    return batched_log_mel(x[None], n_mels)[0]
