"""Frozen work counts and the card's peaks: the yardstick of every
roofline and utilization metric.

A copy of the arithmetic of ``freud_tpu_torch/flops.py`` as it stood when
this benchmark was defined, so that a later change to the program cannot
move the yardstick. Conventions: a (M, K) × (K, N) product counts 2·M·K·N
operations; only products and convolutions count; a bound is the larger of
the bytes over the memory rate and the operations over the peak for their
type. One difference: ``encoder_flops_to_tap`` counts the blocks a
collection runs (up to and including the tapped one), where the program's
``encoder_flops`` counts every block of the model.
"""

from __future__ import annotations

# Published dense peaks of one NVIDIA H100 (NVIDIA's data sheet, SXM part),
# at its full 700 W power limit: operations/s by type, device bytes/s.
H100 = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "bytes": 3.35e12}


def bound_s(flops: float, dtype: str, nbytes: float, f32_flops: float = 0.0) -> float:
    """The least time the card could take: max(operations over their peak,
    bytes over the memory rate)."""
    return max(flops / H100[dtype] + f32_flops / H100["f32"], nbytes / H100["bytes"])


def mel_filter_nonzeros(n_mels: int) -> int:
    """Nonzero weights of the Slaney mel bank at 16 kHz, n_fft 400 (frozen:
    391 at 80 bands, 394 at 128; ``reference/whisper.py`` builds the bank)."""
    return {80: 391, 128: 394}[n_mels]


def log_mel_bound_s(batch: int, n_mels: int, n_samples: int = 480000) -> float:
    """Kernel #1: f32 audio (batch, n_samples) → f32 (batch, n_mels, 3000);
    the windowed DFT as three bf16 products of hi/lo limbs (bf16 peak), the
    mel projection's nonzero weights in f32."""
    n_frames = n_samples // 160
    dft = 2.0 * n_frames * 400 * (2 * 201)
    proj = 2.0 * n_frames * mel_filter_nonzeros(n_mels)
    return bound_s(3 * batch * dft, "bf16", 4.0 * batch * (n_samples + n_mels * n_frames),
                   batch * proj)


def whisper_attention_bound_s(batch: int, heads: int, seq: int, head_dim: int = 64,
                              in_bytes: int = 4) -> float:
    """Kernel #5: q, k, v (b, h, s, dh) → (b, h, s, dh); 4·b·h·s²·dh bf16
    products."""
    flops = 4.0 * batch * heads * seq * seq * head_dim
    return bound_s(flops, "bf16", 4.0 * in_bytes * batch * heads * seq * head_dim)


def topk_sae_forward_bound_s(rows: int, d_in: int, n_dict: int, k: int, k_aux: int) -> float:
    """Kernel #4 (encode, select, both decodes): x (M, d_in) f32 and the f32
    parameters → bf16 acts, f32 y_main and y_aux, the thresholds and fired;
    2·M·d_in·n_dict encode products and 2·d_in a selected entry, M·(k +
    k_aux) of them."""
    selected = rows * (k + k_aux)
    flops = 2.0 * rows * d_in * n_dict + 2.0 * selected * d_in
    nbytes = (4.0 * rows * d_in + 4.0 * (2 * n_dict * d_in + n_dict + d_in) + n_dict
              + 2.0 * rows * n_dict + 2 * 4.0 * rows * d_in + 2 * 4.0 * rows + n_dict)
    return bound_s(flops, "bf16", nbytes)


def sae_topk_step_flops(rows: int, d_in: int, n_dict: int, auxk_live: bool) -> float:
    """A TopK train step's products: enc, main decode, aux decode, d1, d2,
    dW_enc, two dW_dec — 8 with AuxK live, 6 without; masked decodes count
    dense."""
    return (8 if auxk_live else 6) * 2.0 * rows * d_in * n_dict


def mel_flops(n_mels: int, n_frames_in: int = 3000) -> float:
    n_fft, n_freq = 400, 201
    return 2.0 * n_frames_in * n_fft * (2 * n_freq) + 2.0 * n_frames_in * n_freq * n_mels


def encoder_flops_to_tap(n_mels: int, d: int, n_ctx: int, blocks_run: int) -> float:
    """One 30-s clip through the log-mel, the conv stem and ``blocks_run``
    encoder blocks at T = n_ctx."""
    t = n_ctx
    conv1 = 2.0 * (2 * t) * 3 * n_mels * d
    conv2 = 2.0 * t * 3 * d * d
    block = 8.0 * t * d * d + 4.0 * t * t * d + 16.0 * t * d * d
    return mel_flops(n_mels) + conv1 + conv2 + blocks_run * block


def sae_encode_flops(rows: int, d_in: int, n_dict: int) -> float:
    return 2.0 * rows * d_in * n_dict


def tapped_blocks(layer_name: str) -> int:
    """Encoder blocks a forward runs to reach ``encoder.blocks.N[...]``."""
    parts = layer_name.split(".")
    if parts[:2] != ["encoder", "blocks"]:
        raise ValueError(f"not an encoder block tap: {layer_name}")
    return int(parts[2]) + 1


def peak_share_pct(flops: float, seconds: float) -> float:
    """Percent of the H100's dense bf16 peak."""
    return 100.0 * flops / seconds / H100["bf16"]

