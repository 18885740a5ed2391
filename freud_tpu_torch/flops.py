"""Analytic operation and byte counts, the card's peaks, and each kernel's
bound: the least time the card could take for a kernel's work.

The pipeline counts (``mel_flops`` … ``decode_flops``) keep the conventions
of the JAX package's accounting:

* a matmul of shapes (M, K) × (K, N) counts 2·M·K·N operations;
* only matmul and convolution operations count — elementwise work
  (softmax, GELU, the TopK selection) is left out;
* attention scores and values count the dense 4·T²·d.

A kernel's bound (``*_bound``) is the larger of two times: the bytes its
function must move — each input read once, each output written once, in the
dtypes the caller hands over and gets back — over the card's memory rate,
and its counted operations over the card's peak for their type (summed
where the work runs at two types). Where the
work depends on the data (the TopK decodes), the count is what the inputs
need, not the most they could. ``bound_by`` names the larger term.

Peaks are the published dense rates of the card, keyed by
``torch.cuda.get_device_name()``; they assume the card's full power limit.
The bounds are the H100's, the one card the port targets; ``device_peaks``
says whether the attached card is in the table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .audio.filters import mel_filterbank

# Published dense peaks (NVIDIA's data sheet, SXM part): operations/s by
# type, and device-memory bytes/s.
_PEAKS: dict[str, dict[str, float]] = {
    "NVIDIA H100": {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "bytes": 3.35e12},
}
H100 = _PEAKS["NVIDIA H100"]


def peaks_for_name(name: str) -> dict[str, float] | None:
    """The peak table of a card named as ``torch.cuda.get_device_name()``
    gives it ("NVIDIA H100 80GB HBM3" → the H100's); None for a card the
    table does not hold (longest prefix wins)."""
    for key in sorted(_PEAKS, key=len, reverse=True):
        if name.startswith(key):
            return _PEAKS[key]
    return None


def device_peaks() -> dict[str, float] | None:
    """Peaks of CUDA card 0, or None without a card or for an unknown one
    (a utilization against a host CPU means nothing)."""
    import torch

    if not torch.cuda.is_available():
        return None
    return peaks_for_name(torch.cuda.get_device_name(0))


def mfu_pct(total_flops: float, elapsed_s: float) -> float | None:
    """Model FLOPs utilization (percent) against card 0's bf16 peak, the
    JAX package's convention; None without a card the table holds."""
    peaks = device_peaks()
    if peaks is None or elapsed_s <= 0:
        return None
    return 100.0 * total_flops / elapsed_s / peaks["bf16"]


# -- whisper encoder ---------------------------------------------------------

def mel_flops(n_mels: int, n_frames_in: int = 3000) -> float:
    """Framed-matmul DFT + mel projection: each of the ``n_frames_in`` hops
    multiplies a 400-sample window by the packed (400, 2·201) DFT basis,
    then (201,)·(201, n_mels)."""
    n_fft, n_freq = 400, 201
    dft = 2.0 * n_frames_in * n_fft * (2 * n_freq)
    mel = 2.0 * n_frames_in * n_freq * n_mels
    return dft + mel


def encoder_flops(dims, include_mel: bool = True) -> float:
    """Forward operations for ONE 30-s file through the Whisper encoder
    (conv stem + n_audio_layer blocks at T = 1500)."""
    d, t = dims.n_audio_state, dims.n_audio_ctx
    t_in = 2 * t  # conv1 runs at 3000 frames; conv2 strides to 1500
    conv1 = 2.0 * t_in * 3 * dims.n_mels * d
    conv2 = 2.0 * t * 3 * d * d
    # per block: qkv+out projections 4·(2·T·d²), scores+values 2·(2·T²·d),
    # mlp 2·(2·T·d·4d)
    block = 8.0 * t * d * d + 4.0 * t * t * d + 16.0 * t * d * d
    total = conv1 + conv2 + dims.n_audio_layer * block
    if include_mel:
        total += mel_flops(dims.n_mels)
    return total


# -- SAE training steps ------------------------------------------------------

def sae_l1_step_flops(rows: int, d_in: int, n_dict: int) -> float:
    """L1 forward + backward matmuls: enc, dec, dW_enc, dW_dec, d_latent."""
    return 5 * 2.0 * rows * d_in * n_dict


def sae_topk_step_flops(rows: int, d_in: int, n_dict: int,
                        auxk_live: bool = True) -> float:
    """TopK forward + backward matmuls: enc, topk decode, auxk decode, d1,
    d2, dW_enc, 2 dW_dec — 8 with AuxK live, 6 without. The masked decodes
    count dense, as the JAX package counts them."""
    n_matmuls = 8 if auxk_live else 6
    return n_matmuls * 2.0 * rows * d_in * n_dict


# -- serving decode ----------------------------------------------------------

def decode_flops(dims, n_clips: int, tokens_per_clip: float,
                 mean_pos: float | None = None) -> float:
    """Matmul operations for batched greedy serving: per-clip encoder
    forward + cross-K/V projections, then per-token decoder work (self and
    cross attention + MLP + vocab projection). ``mean_pos`` is the mean
    self-attention KV length over emitted tokens (default tokens_per_clip/2
    + the SOT prompt)."""
    d, t_audio = dims.n_text_state, dims.n_audio_ctx
    layers = dims.n_text_layer
    enc = encoder_flops(dims) * n_clips
    cross_kv = layers * 2 * 2.0 * t_audio * d * d * n_clips
    if mean_pos is None:
        mean_pos = tokens_per_clip / 2.0 + 3
    # per token per layer: self q/k/v/out 4·2·d², cross q/out 2·2·d²,
    # mlp 16·d², self dots 4·pos·d, cross dots 4·T_audio·d
    per_tok_layer = (4 + 2) * 2.0 * d * d + 16.0 * d * d \
        + 4.0 * mean_pos * d + 4.0 * t_audio * d
    vocab = 2.0 * d * dims.n_vocab
    total_tokens = n_clips * tokens_per_clip
    return enc + cross_kv + total_tokens * (layers * per_tok_layer + vocab)


# -- kernel bounds -------------------------------------------------------------

@dataclass(frozen=True)
class KernelBound:
    flops: float        # counted operations
    dtype: str          # the peak they run against
    bytes: float        # inputs read once + outputs written once
    f32_flops: float = 0.0  # further operations, on the f32 CUDA cores

    @property
    def flops_s(self) -> float:
        return self.flops / H100[self.dtype] + self.f32_flops / H100["f32"]

    @property
    def bytes_s(self) -> float:
        return self.bytes / H100["bytes"]

    @property
    def bound_s(self) -> float:
        return max(self.flops_s, self.bytes_s)

    @property
    def bound_ms(self) -> float:
        return 1e3 * self.bound_s

    @property
    def bound_by(self) -> str:
        return "operations" if self.flops_s >= self.bytes_s else "bytes"


def log_mel_bound(batch: int, n_mels: int, n_samples: int = 480000) -> KernelBound:
    """Kernel #1: f32 audio (batch, n_samples) → f32 (batch, n_mels, 3000).
    The contract takes the windowed DFT as the TPU kernel's three bf16
    products of hi/lo limbs with f32 sums, which on the H100 run on the bf16
    tensor cores: 3 × 2·frames·400·402 a clip against the ``"bf16"`` peak.
    The mel projection is exact in f32 and needs only the Slaney bank's
    nonzero weights (391 of 16,080 at 80 bands): 2·frames·nnz a clip
    against the ``"f32"`` peak. The dense (201, n_mels) projection that
    ``mel_flops`` counts is work this function does not need."""
    n_frames = n_samples // 160
    dft = 2.0 * n_frames * 400 * (2 * 201)
    proj = 2.0 * n_frames * np.count_nonzero(mel_filterbank(n_mels))
    return KernelBound(3 * batch * dft, "bf16",
                       4.0 * batch * (n_samples + n_mels * n_frames), batch * proj)


def fused_qkv_attention_bound(batch: int, seq: int, d: int, heads: int) -> KernelBound:
    """Kernel #2: f32 x (b, s, d) and f32 Wq, Wk, Wv, bq, bv → f32 (b, s, d);
    the q/k/v projection 2·b·s·d·3d and attention 4·b·h·s²·dh, bf16
    products."""
    dh = d // heads
    flops = 2.0 * batch * seq * d * 3 * d + 4.0 * batch * heads * seq * seq * dh
    nbytes = 2 * 4.0 * batch * seq * d + 4.0 * (3 * d * d + 2 * d)
    return KernelBound(flops, "bf16", nbytes)


def whisper_attention_bound(batch: int, heads: int, seq: int, head_dim: int = 64,
                            in_bytes: int = 4) -> KernelBound:
    """Kernel #5: q, k, v (b, h, s, dh) → (b, h, s, dh), all in the input
    dtype; 4·b·h·s²·dh of bf16 products (the b·h·s² exponentials are
    elementwise work and not counted)."""
    flops = 4.0 * batch * heads * seq * seq * head_dim
    return KernelBound(flops, "bf16", 4.0 * in_bytes * batch * heads * seq * head_dim)


def topk_thresholds_bound(rows: int, n_dict: int, in_bytes: int = 2) -> KernelBound:
    """Kernel #3 as multi_topk calls it: acts (M, n_dict) of ``in_bytes``
    an entry (2: bf16, 4: the f32 route) and the dead mask (n_dict,) bool →
    t_main, t_aux, t_multi (M, 1) f32, fired (n_dict,) bool; a selection, no
    counted operations."""
    nbytes = float(in_bytes) * rows * n_dict + 2.0 * n_dict + 4.0 * 3 * rows
    return KernelBound(0.0, "bf16", nbytes)


def topk_select_bound(rows: int, n_dict: int) -> KernelBound:
    """Kernel #4's select launch alone: bf16 acts (M, n_dict) and the dead
    mask as bits → t_main, t_aux (M,) f32 and the fired bits; no counted
    operations."""
    nbytes = 2.0 * rows * n_dict + n_dict / 8 + 2 * 4.0 * rows + n_dict / 8
    return KernelBound(0.0, "bf16", nbytes)


def topk_shard_candidates_bound(rows: int, n_local: int, width: int,
                                in_bytes: int = 2) -> KernelBound:
    """The sharded selection's candidates launch: a shard's acts (M, n_s)
    of ``in_bytes`` an entry and its dead mask (n_s,) bool → the candidates
    (M, width) int32; a selection, no counted operations."""
    nbytes = float(in_bytes) * rows * n_local + n_local + 4.0 * rows * width
    return KernelBound(0.0, "bf16", nbytes)


def topk_shard_combine_bound(rows: int, n_local: int, width: int, shards: int,
                             in_bytes: int = 2, n_thresholds: int = 3) -> KernelBound:
    """The sharded selection's combine launch: every shard's candidates
    (P, M, width) int32 and this shard's acts (M, n_s) → the thresholds
    (M, 1) f32 each and the shard's fired mask (n_s,) bool."""
    nbytes = (4.0 * shards * rows * width + float(in_bytes) * rows * n_local
              + 4.0 * n_thresholds * rows + n_local)
    return KernelBound(0.0, "bf16", nbytes)


def topk_sae_encode_bound(rows: int, d_in: int, n_dict: int) -> KernelBound:
    """Kernel #4's encode launches alone (a split dictionary's rows): x
    (M, d_in) f32, f32 W_enc, b_enc and b_dec → acts (M, n_dict) bf16;
    2·M·d_in·n_dict of bf16 products."""
    nbytes = (4.0 * rows * d_in + 4.0 * (n_dict * d_in + n_dict + d_in)
              + 2.0 * rows * n_dict)
    return KernelBound(2.0 * rows * d_in * n_dict, "bf16", nbytes)


def topk_sae_decode_bound(rows: int, d_in: int, n_dict: int,
                          selected: float) -> KernelBound:
    """Kernel #4's decode launches alone: acts (M, n_dict) bf16, f32 W_dec,
    the dead mask and t_main, t_aux (M, 1) f32 → y_main, y_aux (M, d_in)
    f32; 2·d_in operations per entry ``selected`` over both decodes (what
    the run's data selected)."""
    nbytes = (2.0 * rows * n_dict + 4.0 * n_dict * d_in + n_dict + 2 * 4.0 * rows
              + 2 * 4.0 * rows * d_in)
    return KernelBound(2.0 * selected * d_in, "bf16", nbytes)


def topk_bwd_pair_bound(rows: int, n_dict: int, in_bytes: int = 2) -> KernelBound:
    """The TopK backward's masked pair: acts (M, n_dict) of ``in_bytes`` an
    entry, t_main, t_aux (M,) f32 and the dead flags (n_dict,) f32 →
    [dense_main; dense_aux] (2M, n_dict) in acts' dtype; masks and selects,
    no counted operations."""
    nbytes = 3.0 * in_bytes * rows * n_dict + 2 * 4.0 * rows + 4.0 * n_dict
    return KernelBound(0.0, "bf16", nbytes)


def topk_bwd_route_bound(rows: int, n_dict: int, in_bytes: int = 2) -> KernelBound:
    """The TopK backward's route: [d1; d2] (2M, n_dict) and acts (M, n_dict)
    of ``in_bytes`` an entry, t_main, t_aux (M,) f32 and the dead flags
    (n_dict,) f32 → d_acts (M, n_dict) in acts' dtype and db_enc (n_dict,)
    f32 (the row groups' partial sums between its two launches are not
    counted); no counted operations."""
    nbytes = 4.0 * in_bytes * rows * n_dict + 2 * 4.0 * rows + 2 * 4.0 * n_dict
    return KernelBound(0.0, "bf16", nbytes)


def topk_indexed_bound(rows: int, n_dict: int, k: int, in_bytes: int = 4,
                       bias: bool = False) -> KernelBound:
    """The SAE encode's indexed top-k: the latent (M, n_dict) of ``in_bytes``
    an entry read once (and the bias (n_dict,) f32 where it is fused) →
    values (M, k) in the latent's type and int64 columns (M, k); compares,
    no counted operations."""
    nbytes = float(in_bytes) * rows * n_dict + (in_bytes + 8.0) * rows * k
    nbytes += 4.0 * n_dict if bias else 0.0
    return KernelBound(0.0, "bf16", nbytes)


def topk_sae_forward_bound(rows: int, d_in: int, n_dict: int, k: int, k_aux: int,
                           selected: float | None = None) -> KernelBound:
    """Kernel #4: x (M, d_in) f32, f32 W_enc, b_enc, b_dec, W_dec and the
    dead mask → acts (M, n_dict) bf16, y_main, y_aux (M, d_in) f32, t_main,
    t_aux (M, 1) f32, fired (n_dict,) bool. The encode is 2·M·d_in·n_dict
    of bf16 products; the decodes need 2·d_in operations per selected
    entry, ``selected`` of them over both decodes (default M·(k + k_aux),
    the count the ranks ask for; a run passes what its data selected)."""
    if selected is None:
        selected = rows * (k + k_aux)
    flops = 2.0 * rows * d_in * n_dict + 2.0 * selected * d_in
    nbytes = (4.0 * rows * d_in                    # x
              + 4.0 * (2 * n_dict * d_in + n_dict + d_in) + n_dict  # params, dead
              + 2.0 * rows * n_dict                # acts
              + 2 * 4.0 * rows * d_in              # y_main, y_aux
              + 2 * 4.0 * rows + n_dict)           # t_main, t_aux, fired
    return KernelBound(flops, "bf16", nbytes)


def gemm_f32x3_bound(rows: int, k: int, n: int, bias: bool = True) -> KernelBound:
    """The 3xTF32 product (``csrc/gemm_f32x3.cu``): the split reads W (N, K)
    f32 and writes its two TF32 limbs, the product reads x (M, K) f32, both
    limbs and the bias (N,) f32 → y (M, N) f32; three products of 2·M·K·N
    against the ``"tf32"`` peak."""
    nbytes = 4.0 * (rows * k + 5 * n * k + rows * n) + (4.0 * n if bias else 0.0)
    return KernelBound(3 * 2.0 * rows * k * n, "tf32", nbytes)


def moe_gateup_bound(rows: int, d: int, width: int, n_dyn: int) -> KernelBound:
    """The MoE's grouped gate/up product (``csrc/moe.cu``): ``rows`` routed
    rows (M, d) bf16 and ``n_dyn`` experts' gate and up (width, d) bf16 →
    the SwiGLU (M, width) bf16; 2·M·d·2·width bf16 operations."""
    nbytes = 2.0 * (rows * d + 2 * n_dyn * width * d + rows * width)
    return KernelBound(4.0 * rows * d * width, "bf16", nbytes)


def moe_down_bound(rows: int, d: int, width: int, n_dyn: int) -> KernelBound:
    """The MoE's grouped down product: (M, width) bf16 and ``n_dyn``
    experts' (d, width) bf16 → (M, d) bf16; 2·M·width·d operations."""
    nbytes = 2.0 * (rows * width + n_dyn * d * width + rows * d)
    return KernelBound(2.0 * rows * d * width, "bf16", nbytes)


def moe_route_bound(tokens: int, d: int, n_router: int, top_k: int, rows: int) -> KernelBound:
    """The MoE's route, plan, permute and combine launches together, bound
    by bytes: the router reads u (T, d) bf16 and its (n_router, d) f32
    weights and writes probs, sel and wsel; the plan reads sel and writes
    the rows; the permute copies ``rows`` rows of u; the combine reads h,
    the fixed experts' output and the ``rows`` expert rows and writes
    (T, d) bf16. The router's 2·T·d·n_router f32 operations are left out
    (under a thousandth of the bytes' time)."""
    slots = 4.0 * tokens * top_k
    nbytes = (2.0 * tokens * d + 4.0 * n_router * d + 4.0 * tokens * n_router + 2 * slots
              + 2 * slots + 4.0 * n_router
              + 2 * 2.0 * rows * d + slots
              + 3 * 2.0 * tokens * d + 2.0 * rows * d + 2 * slots)
    return KernelBound(0.0, "bf16", nbytes)


def moe_route_topk_bound(tokens: int, n_router: int, top_k: int) -> KernelBound:
    """The MoE's top-k route (``csrc/moe.cu`` ``route_topk_kernel``), bound
    by bytes: the f32 logits (T, n_router) and the bias read, the f32
    probabilities written, and each slot's int32 entry, f32 weight and int8
    class. Its exponentials and comparisons are left out."""
    nbytes = 4.0 * tokens * n_router + 4.0 * n_router + 4.0 * tokens * n_router
    return KernelBound(0.0, "bf16", nbytes + 9.0 * tokens * top_k)


def moe_held_bounds(rows: float, active: int, d: int, width: int) -> tuple:
    """The grouped gate/up and down products over a share of the experts:
    ``rows`` held rows, of which ``active`` experts took at least one (only
    those experts' weights are read) → (gate/up, down) bounds."""
    return (moe_gateup_bound(rows, d, width, active), moe_down_bound(rows, d, width, active))
