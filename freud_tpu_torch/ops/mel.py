"""Log-mel front end as a hand-written CUDA kernel (``csrc/mel.cu``).

Replaces the Pallas TPU kernel ``freud_tpu/ops/mel_pallas.py``
(``log_mel_spectrogram_pallas``) and keeps its precision recipe: the
windowed real DFT as three bf16 products of hi/lo limbs (x_hi·B_hi +
x_hi·B_lo + x_lo·B_hi) with f32 sums, on the H100's tensor cores
(``wgmma``). Those three products, ~3.0 GFLOP a 30-s clip, bound it; the
kernel stages each 128-frame tile's samples once in shared memory, builds
the A fragments in registers at the TPU kernel's row shifts (frame j = rows
j, j + 1, j + 2 of the (rows, 160) view), streams the basis limbs from L2 by
TMA into two warpgroups that share each tile, forms the power in registers
and projects onto each mel band's nonzero bins in f32 (the header of
``csrc/mel.cu`` has the design).

``log_mel_spectrogram_cuda`` is the wrapper: a CUDA tensor launches the
kernel, a CPU tensor takes the plain version
(``freud_tpu_torch.audio.mel.log_mel_spectrogram``). There is no fallback
from one to the other. ``log_mel_spectrogram_cuda.launches`` counts kernel
launches (``_native.counted``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._native import Kernel, counted
from ..audio.filters import mel_filterbank
from ..audio.mel import N_FREQS, _dft_basis, log_mel_spectrogram, reflect_pad_center
from ..constants import N_FFT, N_FRAMES, N_SAMPLES

_FREQ_SLOTS = 208  # csrc/mel.cu: 201 bins padded to two chunks of 104


def _basis_limbs() -> torch.Tensor:
    """(2, 416, 400) bf16: the hi and lo limbs of the windowed basis
    (hi = bf16(B), lo = bf16(B − hi), as ``mel_pallas.py`` splits it), as
    the kernel's K-major B operand: row n < 208 of a limb is the cos column
    of bin n, row 208 + n the −sin column of bin n, zero past bin 200."""
    basis = torch.from_numpy(np.array(_dft_basis()))  # (400, 402)
    rows = torch.zeros((2 * _FREQ_SLOTS, N_FFT), dtype=torch.float32)
    rows[:N_FREQS] = basis[:, :N_FREQS].T
    rows[_FREQ_SLOTS:_FREQ_SLOTS + N_FREQS] = basis[:, N_FREQS:].T
    hi = rows.to(torch.bfloat16)
    lo = (rows - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, lo])


def _band_table(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The Slaney bank as the kernel takes it: (W,) f32, each band's nonzero
    weights, band after band — a band's weights are one contiguous triangle
    of bins — and (3, n_mels) int32: each band's first bin, end bin and
    first weight (an empty band gets [0, 0))."""
    bank = mel_filterbank(n_mels)
    table = np.zeros((3, n_mels), np.int32)
    weights = []
    for m, row in enumerate(bank):
        nz = np.flatnonzero(row)
        table[2, m] = sum(len(w) for w in weights)
        if nz.size:
            table[0, m], table[1, m] = nz[0], nz[-1] + 1
            weights.append(row[nz[0]:nz[-1] + 1])
    return np.concatenate(weights).astype(np.float32), table


def log_mel_spectrogram_recipe(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on ``audio``'s device, with
    exact sums: (B, 480000) f32 → (B, n_mels, 3000) f32. Frame j is rows j,
    j + 1, j + 2 [:80] of the (rows, 160) view of the reflect-padded clip;
    each of those three K-bands is x_hi·B_hi + x_hi·B_lo + x_lo·B_hi from
    the kernel's basis limbs; power, the Slaney bank, log10, the per-clip
    floor and the affine follow. Limb products are exact and the sums are
    f64, so the kernel differs from it only by its f32 sums. Used by the
    tests and ``chip_smoke.py`` to hold the kernel to its recipe."""
    f64 = torch.float64
    batch = audio.shape[0]
    padded = torch.nn.functional.pad(reflect_pad_center(audio.to(torch.float32)),
                                     (0, 3008 * 160 - (N_SAMPLES + N_FFT)))
    rows = padded.view(batch, 3008, 160)
    x_hi = rows.to(torch.bfloat16).to(f64)
    x_lo = (rows - x_hi.to(torch.float32)).to(torch.bfloat16).to(f64)
    b_hi, b_lo = _basis_limbs().to(audio.device, f64)
    proj = torch.zeros((batch, N_FRAMES, 2 * _FREQ_SLOTS), dtype=f64, device=audio.device)
    for shift, (k0, width) in enumerate(((0, 160), (160, 160), (320, 80))):
        xh = x_hi[:, shift:shift + N_FRAMES, :width]
        xl = x_lo[:, shift:shift + N_FRAMES, :width]
        bh, bl = b_hi[:, k0:k0 + width].T, b_lo[:, k0:k0 + width].T
        proj += xh @ bh + xh @ bl + xl @ bh
    re = proj[..., :N_FREQS]
    im = proj[..., _FREQ_SLOTS:_FREQ_SLOTS + N_FREQS]
    bank = torch.tensor(mel_filterbank(n_mels).T, dtype=f64, device=audio.device)
    log = torch.log10(torch.clamp((re * re + im * im) @ bank, min=1e-10))
    log = torch.maximum(log, log.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((log + 4.0) / 4.0).transpose(-1, -2).to(torch.float32)


# The kernel against log_mel_spectrogram_recipe, in log10 units (4 × the
# output's): max |Δ| < RECIPE_MAX and a share < RECIPE_SHARE of bins with
# |Δ| > RECIPE_LOOSE. Its f32 sums differ from the recipe's exact ones by
# ~1e-6 on most bins and by more on the few whose re and im nearly cancel
# (32 seeded clips on an H100: max up to 4.6e-4, share up to 1.2e-4). A
# recipe without one of its three products misses by orders of magnitude
# (tests/test_torch_mel.py::test_recipe_gate_rejects_a_dropped_product).
RECIPE_MAX, RECIPE_LOOSE, RECIPE_SHARE = 1e-3, 1e-5, 1e-3


def recipe_gap(got: torch.Tensor, recipe: torch.Tensor) -> tuple[float, float]:
    """(max |Δ|, share of bins with |Δ| > RECIPE_LOOSE) of two log-mels, in
    log10 units."""
    diff = 4.0 * (got - recipe).abs()
    return diff.max().item(), (diff > RECIPE_LOOSE).float().mean().item()


@functools.cache
def _operands(device: torch.device, n_mels: int) -> tuple[torch.Tensor, ...]:
    """The kernel's constant operands on ``device``, made once: the basis
    limbs, the bank's nonzero weights and its band table."""
    weights, table = _band_table(n_mels)
    return (_basis_limbs().to(device), torch.from_numpy(weights).to(device),
            torch.from_numpy(table).to(device))


_LOG_MEL = Kernel("mel", "freud_log_mel", "log-mel kernel")


@counted(_LOG_MEL)
def log_mel_spectrogram_cuda(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, 480000) f32 waveforms → (B, n_mels, 3000) f32 Whisper log-mels.

    A 1-D waveform is treated as a batch of one."""
    if audio.ndim == 1:
        return log_mel_spectrogram_cuda(audio[None], n_mels)[0]
    if not audio.is_cuda:
        return log_mel_spectrogram(audio, n_mels)
    if n_mels not in (80, 128):
        raise ValueError(f"n_mels must be 80 or 128, got {n_mels}")
    if audio.ndim != 2 or audio.shape[1] != N_SAMPLES:
        raise ValueError(f"expected (B, {N_SAMPLES}) audio, got {tuple(audio.shape)}")
    if audio.dtype != torch.float32:
        raise TypeError(f"expected float32 audio, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    batch = audio.shape[0]
    if batch > 65535:  # CUDA's gridDim.y limit: one grid row per clip
        raise ValueError(f"batch {batch} > 65535 clips; split the batch")
    if audio.data_ptr() % 16:
        raise ValueError("audio is not 16-byte aligned")
    device = audio.device
    basis, weights, bands = _operands(device, n_mels)
    out = torch.empty((batch, n_mels, N_FRAMES), dtype=torch.float32, device=device)
    if batch == 0:
        return out
    clip_max = torch.empty((batch,), dtype=torch.int32, device=device)
    _LOG_MEL(audio, basis, weights, weights.numel(), bands, out, clip_max, batch, n_mels)
    return out
