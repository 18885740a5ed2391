"""freud_tpu_torch log-mel against freud_tpu: the plain PyTorch path against
the JAX XLA path and the Pallas kernel (interpret mode), with the bounds of
tests/test_mel_pallas.py. The CUDA kernel is held against the plain path
on a card in tests/test_torch_cuda.py.

Tolerance (``_assert_mel_close``): max |Δ| < 2e-3 and a share < 1e-5 of
bins with |Δ| > 3e-4 — bins on the per-clip floor (max − 8) may clamp on
one side only. The CUDA kernel's operands, combined as the kernel combines
them, meet the Pallas kernel within 1e-4 log10 units: both take the same
three bf16 limb products, and differ only in the order of f32 sums and in
the mel projection (f32 here, limb-split bf16 there); measured ≤ 1.5e-5.
``log_mel_spectrogram_recipe``, the same arithmetic in PyTorch with exact
sums, meets both within the same 1e-4; on a card the kernel is held to it
by the looser recipe gate of ``ops/mel.py`` (12M bins there, whose tail
is wider), which a recipe without one of its products fails.
On a rare clip the recipe itself is above the 2e-3 gate against an f64
log-mel (``test_recipe_crosses_the_gate_on_a_silent_clip``)."""

import numpy as np
import pytest
import torch

from freud_tpu.audio import mel as jmel
from freud_tpu.constants import N_FRAMES, N_SAMPLES
from freud_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from freud_tpu_torch.audio import mel as tmel
from freud_tpu_torch.audio.filters import mel_filterbank
from freud_tpu_torch.ops.mel import (
    _band_table,
    _basis_limbs,
    RECIPE_MAX,
    log_mel_spectrogram_cuda,
    log_mel_spectrogram_recipe,
    recipe_gap,
)


def _assert_mel_close(got, want):
    diff = np.abs(got - want)
    assert diff.max() < 2e-3, diff.max()
    frac_loose = np.mean(diff > 3e-4)
    assert frac_loose < 1e-5, frac_loose


def _audio(batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, N_SAMPLES)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_mel_matches_jax_xla(n_mels):
    audio = _audio(2)
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels).numpy()
    want = np.asarray(jmel.log_mel_spectrogram(audio, n_mels))
    assert got.shape == (2, n_mels, N_FRAMES)
    _assert_mel_close(got, want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_mel_matches_pallas_kernel(n_mels):
    audio = _audio(2, seed=1)
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels).numpy()
    want = np.asarray(log_mel_spectrogram_pallas(audio, n_mels, interpret=True))
    _assert_mel_close(got, want)


def test_framing_matches_jax_on_short_signals():
    """Reflect padding and framing agree for lengths that need the zero
    extension at the end (the long-audio chunker's shapes)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    for n_frames in (5, 13, 16):
        got = tmel.frame_signal(tmel.reflect_pad_center(torch.from_numpy(x)),
                                n_frames).numpy()
        want = np.asarray(jmel.frame_signal(jmel.reflect_pad_center(x), n_frames))
        np.testing.assert_array_equal(got, want)
    got = tmel.log_mel_spectrogram(torch.from_numpy(x), 80, n_frames=13).numpy()
    want = np.asarray(jmel.log_mel_spectrogram(x, 80, n_frames=13))
    _assert_mel_close(got, want)


def test_power_spectrogram_and_trim_audio_match_jax():
    """The public helpers: |STFT|² of framed audio within 1e-5 of max of
    JAX's (f32 DFT on both sides, HIGHEST precision in JAX), and the
    second-range slice equal."""
    audio = _audio(2, seed=6)[:, :48000]
    for n_frames in (300, 13):
        got = tmel.power_spectrogram(torch.from_numpy(audio), n_frames).numpy()
        want = np.asarray(jmel.power_spectrogram(audio, n_frames))
        assert got.shape == want.shape == (2, n_frames, tmel.N_FREQS)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    clip = audio[0]
    for start, end in ((0.0, 1.0), (0.25, 2.5), (1.7, 1.2)):
        np.testing.assert_array_equal(tmel.trim_audio(clip, start, end),
                                      jmel.trim_audio(clip, start, end))
    np.testing.assert_array_equal(tmel.trim_audio(clip, 0.5, 1.0, sample_rate=8000),
                                  jmel.trim_audio(clip, 0.5, 1.0, sample_rate=8000))


def test_dft_basis_equal():
    np.testing.assert_array_equal(tmel._dft_basis(), jmel._dft_basis())


def test_cpu_dispatch_takes_plain_path():
    audio = _audio(1, seed=3)
    before = log_mel_spectrogram_cuda.launches
    got = tmel.batched_log_mel(torch.from_numpy(audio), 80)
    assert log_mel_spectrogram_cuda.launches == before
    want = tmel.log_mel_spectrogram(torch.from_numpy(audio), 80)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = log_mel_spectrogram_cuda(torch.from_numpy(audio[0]), 80)
    assert one.shape == (80, N_FRAMES)


def test_mels_from_array_matches_jax():
    rng = np.random.default_rng(4)
    clip = (rng.standard_normal(50_000) * 0.2).astype(np.float32)
    got = tmel.mels_from_array(clip, 80).numpy()
    want = np.asarray(jmel.mels_from_array(clip, 80))
    _assert_mel_close(got, want)
    with pytest.raises(ValueError):
        tmel.mels_from_array(clip, 64)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _kernel_log10_mel(clip: np.ndarray, n_mels: int) -> np.ndarray:
    """csrc/mel.cu's arithmetic in numpy, from its host operands: (n_mels,
    3000) unfloored log10-mel. Frame j is rows j, j + 1, j + 2 [:80] of the
    (rows, 160) view of the reflect-padded clip (three K-bands at row shifts
    0, 1, 2); each band is x_hi·B_hi + x_hi·B_lo + x_lo·B_hi with f32 sums;
    power from the cos rows [0, 201) and −sin rows [208, 409) of the basis;
    the mel projection in f32 over each band's nonzero bins, from the
    kernel's packed weights and band table."""
    limbs = _basis_limbs()
    assert limbs.shape == (2, 416, 400) and limbs.dtype == torch.bfloat16
    b_hi, b_lo = limbs.float().numpy()
    padded = np.pad(clip, (200, 3008 * 160 - clip.size - 200), mode="reflect")
    rows = padded.reshape(3008, 160)
    x_hi = _bf16(rows)
    x_lo = _bf16(rows - x_hi)
    proj = np.zeros((N_FRAMES, 416), np.float32)
    for shift, (k0, width) in enumerate(((0, 160), (160, 160), (320, 80))):
        xh = x_hi[shift:shift + N_FRAMES, :width]
        xl = x_lo[shift:shift + N_FRAMES, :width]
        bh, bl = b_hi[:, k0:k0 + width].T, b_lo[:, k0:k0 + width].T
        proj += xh @ bh + xh @ bl + xl @ bh
    re, im = proj[:, :201], proj[:, 208:409]
    power = re * re + im * im
    weights, table = _band_table(n_mels)
    mel = np.stack([power[:, lo:hi] @ weights[at:at + hi - lo] for lo, hi, at in table.T],
                   axis=1)
    return np.log10(np.maximum(mel, 1e-10)).T


@pytest.mark.parametrize("n_mels", [80, 128])
def test_band_table_packs_the_bank(n_mels):
    """The packed weights and band table rebuild the Slaney bank exactly:
    every nonzero weight, nothing else; at most two bands a bin."""
    weights, table = _band_table(n_mels)
    bank = mel_filterbank(n_mels)
    rebuilt = np.zeros_like(bank)
    for m, (lo, hi, at) in enumerate(table.T):
        rebuilt[m, lo:hi] = weights[at:at + hi - lo]
    np.testing.assert_array_equal(rebuilt, bank)
    assert weights.size == np.count_nonzero(bank) <= 2 * 201


def test_basis_limbs_layout():
    """The limbs sum to the windowed basis within the bf16 split's 2^-16
    (relative to its largest entry), cos bins in rows [0, 201), −sin bins
    in [208, 409), zeros elsewhere."""
    hi, lo = _basis_limbs().float().numpy()
    basis = tmel._dft_basis()
    want = np.zeros((416, 400), np.float32)
    want[:201], want[208:409] = basis[:, :201].T, basis[:, 201:].T
    assert np.abs(hi + lo - want).max() < 2.0 ** -16
    assert not hi[201:208].any() and not hi[409:].any()
    np.testing.assert_array_equal(hi, _bf16(want))


@pytest.mark.parametrize("silent", [False, True])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_kernel_operands_reproduce_pallas_mel(n_mels, silent):
    """The CUDA kernel's operands — the basis limbs in its (416, 400)
    layout and each band's nonzero bin range — combined as csrc/mel.cu
    combines them give the Pallas kernel's log-mel (interpret mode) within
    1e-4 log10 units before the floor, and the plain path's within
    ``_assert_mel_close``; ``silent``: a clip that is silent after 1000
    samples, where the floor clamps most bins."""
    clip = _audio(1, seed=6)[0]
    if silent:
        clip[1000:] = 0.0
    log = _kernel_log10_mel(clip, n_mels)
    got = (np.maximum(log, log.max() - 8.0) + 4.0) / 4.0
    pallas = np.asarray(log_mel_spectrogram_pallas(clip[None], n_mels, interpret=True))[0]
    above = log > log.max() - 8.0 + 1e-3  # off the floor on both sides
    assert above.any()
    assert np.abs(log - (4.0 * pallas - 4.0))[above].max() < 1e-4
    assert 4.0 * np.abs(got - pallas).max() < 1e-4
    plain = tmel.log_mel_spectrogram(torch.from_numpy(clip[None]), n_mels).numpy()[0]
    _assert_mel_close(got, plain)


@pytest.mark.parametrize("silent", [False, True])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_recipe_reproduces_pallas_mel(n_mels, silent):
    """``log_mel_spectrogram_recipe`` (the kernel's arithmetic in PyTorch,
    exact sums; the card tests and the smoke hold the kernel to it) meets
    the numpy emulation of csrc/mel.cu and the Pallas kernel (interpret
    mode) within 1e-4 log10 units (measured ≤ 1.1e-5)."""
    clip = _audio(1, seed=6)[0]
    if silent:
        clip[1000:] = 0.0
    got = log_mel_spectrogram_recipe(torch.from_numpy(clip[None]), n_mels).numpy()[0]
    assert got.shape == (n_mels, N_FRAMES) and got.dtype == np.float32
    log = _kernel_log10_mel(clip, n_mels)
    emulated = (np.maximum(log, log.max() - 8.0) + 4.0) / 4.0
    pallas = np.asarray(log_mel_spectrogram_pallas(clip[None], n_mels, interpret=True))[0]
    assert 4.0 * np.abs(got - emulated).max() < 1e-4
    assert 4.0 * np.abs(got - pallas).max() < 1e-4


def _f64_log_mel(clip: np.ndarray, n_mels: int) -> np.ndarray:
    """The log-mel in float64 throughout, from an f64 basis and bank."""
    x = torch.from_numpy(clip.astype(np.float64))
    frames = tmel.frame_signal(tmel.reflect_pad_center(x), N_FRAMES)
    n, k = np.arange(400), np.arange(201)
    ang = 2.0 * np.pi * np.outer(n, k) / 400
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / 400))
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * hann[:, None]
    proj = frames @ torch.from_numpy(basis)
    power = proj[:, :201] ** 2 + proj[:, 201:] ** 2
    mel = power @ torch.from_numpy(mel_filterbank(n_mels).T.astype(np.float64))
    log = torch.log10(torch.clamp(mel, min=1e-10))
    log = torch.maximum(log, log.max() - 8.0)
    return ((log + 4.0) / 4.0).T.numpy()


def test_recipe_crosses_the_gate_on_a_silent_clip():
    """The edge of the 2e-3 gate: chip_smoke.py's batch of 32 seeded clips
    (torch.randn, seed 0, × 0.1), silent after 1000 samples. On clip 15
    the contract's three-product recipe itself — the Pallas kernel in
    interpret mode — is 2.434e-3 off the f64 log-mel, above the gate, while
    the f32 plain path is 7.7e-6 off it. So the smoke holds a batch of such
    clips to the recipe (within 1e-4 log10 units), not to the plain path;
    the kernel's recipe, in PyTorch, reads the same as Pallas."""
    gen = torch.Generator().manual_seed(0)
    clip = (torch.randn((32, N_SAMPLES), generator=gen) * 0.1)[15].numpy()
    clip[1000:] = 0.0
    want = _f64_log_mel(clip, 80)
    pallas = np.asarray(log_mel_spectrogram_pallas(clip[None], 80, interpret=True))[0]
    plain = tmel.log_mel_spectrogram(torch.from_numpy(clip[None]), 80).numpy()[0]
    recipe = log_mel_spectrogram_recipe(torch.from_numpy(clip[None]), 80).numpy()[0]
    assert np.abs(pallas - want).max() == pytest.approx(2.434e-3, abs=1e-5)
    assert np.abs(plain - want).max() < 2e-5
    assert 4.0 * np.abs(recipe - pallas).max() < 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_recipe_gate_rejects_a_dropped_product(monkeypatch, n_mels):
    """The recipe gate, which holds the CUDA kernel to
    ``log_mel_spectrogram_recipe`` on a card, tells the three-product recipe
    from one without its x_hi·B_lo product (the basis's lo limb zeroed)."""
    from freud_tpu_torch.ops import mel as mel_ops

    audio = torch.from_numpy(_audio(2, seed=7))
    want = log_mel_spectrogram_recipe(audio, n_mels)
    limbs = mel_ops._basis_limbs()
    keep_hi = torch.tensor([1.0, 0.0], dtype=limbs.dtype)[:, None, None]
    monkeypatch.setattr(mel_ops, "_basis_limbs", lambda: limbs * keep_hi)
    max_err, share = recipe_gap(log_mel_spectrogram_recipe(audio, n_mels), want)
    assert max_err > 100 * RECIPE_MAX and share > 0.5, (max_err, share)
