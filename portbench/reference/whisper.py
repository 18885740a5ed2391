"""Whisper's log-mel and audio encoder, and the TopK SAE encode, in plain
float32 PyTorch (OpenAI's whisper package as published: ``audio.py``'s
``log_mel_spectrogram`` and ``model.py``'s ``AudioEncoder``).

The mel bank is librosa's Slaney bank (``librosa.filters.mel(sr=16000,
n_fft=400, n_mels)``, the bank whisper ships as ``mel_filters.npz``),
built here from its published formulas.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE, N_FFT, HOP, N_SAMPLES = 16000, 400, 160, 480000


def mel_bank(n_mels: int) -> np.ndarray:
    """(n_mels, 201) Slaney-normalised triangular filters, float32."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel)),
                        f_sp * m)

    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: np.ndarray, n_mels: int, device) -> torch.Tensor:
    """A clip padded or cut to 30 s → (n_mels, 3000): |STFT|² (periodic
    Hann, centred, reflect padding, the last frame dropped), the mel bank,
    log10 clamped at 1e-10, floored at the clip's max − 8, (x + 4) / 4."""
    x = np.zeros(N_SAMPLES, np.float32)
    n = min(len(audio), N_SAMPLES)
    x[:n] = audio[:n]
    x = torch.from_numpy(x).to(device)
    stft = torch.stft(x, N_FFT, HOP, window=torch.hann_window(N_FFT, device=device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = stft[..., :-1].abs() ** 2
    mel = torch.from_numpy(mel_bank(n_mels)).to(device) @ power
    spec = torch.log10(torch.clamp(mel, min=1e-10))
    spec = torch.maximum(spec, spec.max() - 8.0)
    return (spec + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def encoder_to_block(sd: dict, dims: dict, mels: torch.Tensor, block: int) -> torch.Tensor:
    """(b, n_mels, 3000) log-mels → the residual stream after
    ``encoder.blocks.<block>``, (b, n_ctx, d); ``sd``: OpenAI's state-dict
    names, float32."""
    d, heads = dims["n_audio_state"], dims["n_audio_head"]
    w = lambda k: sd[f"encoder.{k}"]
    x = F.gelu(F.conv1d(mels, w("conv1.weight"), w("conv1.bias"), padding=1))
    x = F.gelu(F.conv1d(x, w("conv2.weight"), w("conv2.bias"), stride=2, padding=1))
    pos = sd.get("encoder.positional_embedding")
    x = x.transpose(1, 2) + (sinusoids(dims["n_audio_ctx"], d).to(x.device) if pos is None
                             else pos)
    b, t, _ = x.shape
    scale = (d // heads) ** -0.25
    for i in range(block + 1):
        p = f"blocks.{i}."
        h = F.layer_norm(x, (d,), w(p + "attn_ln.weight"), w(p + "attn_ln.bias"))
        q = F.linear(h, w(p + "attn.query.weight"), w(p + "attn.query.bias"))
        k = F.linear(h, w(p + "attn.key.weight"))
        v = F.linear(h, w(p + "attn.value.weight"), w(p + "attn.value.bias"))
        q, k, v = (z.view(b, t, heads, d // heads).transpose(1, 2) for z in (q, k, v))
        att = torch.softmax((q * scale) @ (k * scale).transpose(-1, -2), dim=-1) @ v
        att = att.transpose(1, 2).reshape(b, t, d)
        x = x + F.linear(att, w(p + "attn.out.weight"), w(p + "attn.out.bias"))
        h = F.layer_norm(x, (d,), w(p + "mlp_ln.weight"), w(p + "mlp_ln.bias"))
        h = F.gelu(F.linear(h, w(p + "mlp.0.weight"), w(p + "mlp.0.bias")))
        x = x + F.linear(h, w(p + "mlp.2.weight"), w(p + "mlp.2.bias"))
    return x


def sae_latents(sae: dict, x: torch.Tensor) -> torch.Tensor:
    """relu((x − b_dec)·W_encᵀ + b_enc): every latent before the TopK."""
    return torch.relu((x - sae["b_dec"]) @ sae["encoder.weight"].T + sae["encoder.bias"])


def tap_block(layer_name: str) -> int:
    parts = layer_name.split(".")
    if parts[:2] != ["encoder", "blocks"] or len(parts) != 3:
        raise ValueError(f"the reference taps a block's output, not {layer_name}")
    return int(parts[2])
