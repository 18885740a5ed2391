"""Whisper audio encoder as an ``nn.Module`` with activation capture and
substitution.

The module tree follows OpenAI Whisper's (``conv1``, ``conv2``,
``positional_embedding``, ``blocks.N.{attn_ln, attn.{query,key,value,out},
mlp_ln, mlp.0, mlp.2}``, ``ln_post``), so an OpenAI checkpoint's encoder
state dict loads with ``load_state_dict`` and capture names are module
paths. ``encoder_forward`` takes a static set of capture names and a dict of
substitution tensors, like ``freud_tpu.models.whisper.model.encoder_forward``,
with the same tap points (and the same (b, T, d) layout at the conv taps):

  encoder.conv1 / encoder.conv2      conv output, pre-GELU
  encoder.blocks.N                   residual-stream output of block N
  encoder.blocks.N.attn_ln           pre-attention LayerNorm output
  encoder.blocks.N.attn.out          attention output projection
  encoder.blocks.N.mlp_ln            pre-MLP LayerNorm output
  encoder.blocks.N.mlp.0             first MLP linear (pre-GELU)
  encoder.blocks.N.mlp.1             GELU output (width 4·d_model)
  encoder.blocks.N.mlp.2 / .mlp      MLP output projection
  encoder.ln_post                    final LayerNorm

Self-attention is routed as the JAX ``_attention_impl`` routes it
(``attention_route``, set by the module-level ``ATTENTION_IMPL``): under
``"auto"`` a CUDA tensor with d ≤ 768 launches the fused q/k/v attention
kernel (``ops.attention.fused_qkv_attention``), a CUDA tensor with d > 768
(medium, large) projects q/k/v with the ``nn.Linear``s and launches the
blocked kernel (``ops.attention.whisper_attention``) — both bf16 products
with f32 statistics — and a CPU tensor takes the plain f32 path. The MLP,
the q/k/v projections at d > 768 and the out-projection (the JAX package
left them to XLA) go through ``ops.gemm_f32x3.linear``: CUDA f32 outside
autograd takes the 3xTF32 tensor-core kernel, f32-grade sums; anything
else ``F.linear``. The convs stay ``F.conv1d``. For f32 on CUDA the caller
pins TF32 off (``WhisperRuntime`` does), or cuDNN would run the convs in
TF32.

The text decoder (``TextDecoder``: ``token_embedding``,
``positional_embedding``, ``blocks.N.{attn_ln, attn, cross_attn_ln,
cross_attn, mlp_ln, mlp}``, ``ln``, OpenAI's names) has no kernel of its
own, as in the JAX package: an attention with a mask or a cross-attention
source is plain matmuls (``attend``), with JAX's numerics — q and k each
scaled by dh^-¼ before the product, scores and vocabulary logits f32
products of the compute-dtype operands (the operands are upcast, so a bf16
decode rounds as ``preferred_element_type=f32`` does), the softmax in f32.
``decoder_forward`` is the teacher-forced full-sequence pass (causal mask)
through the same ``ResidualAttentionBlock`` as the encoder, with the same
taps under ``decoder.blocks.N`` and one more:

  decoder.blocks.N.cross_attn.weights   post-softmax cross-attention
                                        weights (b, h, T, S), capture only

The KV-cached step is ``decoding._decode_step``.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import (
    fused_qkv_attention,
    whisper_attention,
    whisper_attention_plain,
)
from ...ops.gemm_f32x3 import linear
from .config import WhisperDims

Captures = dict[str, torch.Tensor]

FUSED_ATTENTION_MAX_D = 768  # the fused kernel's gate (model.py:205 of the JAX package)

# Full-sequence self-attention implementation (the JAX package's values):
#   "auto"   → on CUDA the fused q/k/v kernel for d ≤ 768, the blocked
#              whisper_attention kernel for d > 768; the plain path on the CPU
#   "einsum" → the plain f32 attention, on any device
#   "kernel" → force the whisper_attention kernel (q/k/v by the Linears)
#   "fused"  → force the fused q/k/v kernel
#   "flash"  → JAX's opt-in stock flash kernel computes the same function;
#              here it is served by the whisper_attention kernel
ATTENTION_IMPL: str = "auto"
ATTENTION_IMPLS = ("auto", "einsum", "kernel", "fused", "flash")


def attention_route(d: int, device_type: str, impl: str | None = None) -> str:
    """Which attention a (…, d) input on ``device_type`` takes under
    ``impl`` (default ``ATTENTION_IMPL``): ``"fused"`` (fused_qkv_attention),
    ``"kernel"`` (whisper_attention) or ``"plain"`` (f32 attention). A
    kernel route given a CPU tensor runs that wrapper's plain version."""
    impl = ATTENTION_IMPL if impl is None else impl
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention implementation {impl!r}; "
                         f"expected one of {ATTENTION_IMPLS}")
    if impl == "auto":
        if device_type != "cuda":
            return "plain"
        return "fused" if d <= FUSED_ATTENTION_MAX_D else "kernel"
    return {"einsum": "plain", "flash": "kernel"}.get(impl, impl)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Standard sinusoidal position encoding (sin | cos concatenated)."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, s, d) → a (b, h, s, dh) view."""
    b, s, d = t.shape
    return t.view(b, s, heads, d // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(b, h, s, dh) → (b, s, h·dh)."""
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           keep: Optional[torch.Tensor] = None, weights_tap=None) -> torch.Tensor:
    """Softmax attention with the JAX decoder's numerics: ``q`` (…, g, dh)
    and ``k`` (…, s, dh), each already scaled by dh^-¼; the scores are the
    f32 product of the (upcast) operands, ``keep`` (bool, broadcast to the
    scores) masks to -inf, the softmax runs in f32 and its weights are cast
    to ``v``'s dtype before the product with ``v``. ``weights_tap`` (a
    callback) sees those weights."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if keep is not None:
        scores = scores.masked_fill(~keep, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    if weights_tap is not None:
        weights_tap(weights)
    return torch.matmul(weights, v)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``; CUDA f32 outside autograd on the 3xTF32 kernel
    (``ops.gemm_f32x3.linear``'s routing rule)."""
    return linear(x, layer.weight, layer.bias)


def _tapper(capture: frozenset, substitute: Mapping, store: Captures):
    """The capture/substitution callback of one forward: ``tap(name, x)``
    replaces x by ``substitute[name]`` (cast to x's device and dtype) and
    records the result in ``store`` when ``name`` is captured."""
    def tap(name: str, x: torch.Tensor) -> torch.Tensor:
        if name in substitute:
            x = torch.as_tensor(substitute[name]).to(x.device, x.dtype)
        if name in capture:
            store[name] = x
        return x
    return tap


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor, xa: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, weights_tap=None) -> torch.Tensor:
        """Self-attention of ``x``, or with ``xa`` cross-attention to it;
        ``mask`` (bool, True = attend) is broadcast to the scores. Full
        self-attention (no mask, no ``xa``: the encoder) takes its
        ``attention_route``; the decoder's attention takes ``attend``, as
        the JAX package never routes a masked or cross attention to a
        kernel. ``weights_tap`` sees ``attend``'s softmax weights."""
        b, s, d = x.shape
        if xa is not None or mask is not None:
            scale = (d // self.n_head) ** -0.25
            src = x if xa is None else xa
            q = split_heads(self.query(x), self.n_head) * scale
            k = split_heads(self.key(src), self.n_head) * scale
            v = split_heads(self.value(src), self.n_head)
            return self.out(merge_heads(attend(q, k, v, mask, weights_tap)))
        route = attention_route(d, x.device.type)
        if route == "fused":
            # nn.Linear weights are (out, in); the kernel takes (in, out)
            out = fused_qkv_attention(
                x, self.query.weight.t(), self.query.bias, self.key.weight.t(),
                self.value.weight.t(), self.value.bias, self.n_head,
            )
            return _linear(self.out, out)

        def heads(t):  # (b, s, d) → a (b, h, s, dh) view, no copy
            return t.view(b, s, self.n_head, d // self.n_head).transpose(1, 2)

        q, k, v = (heads(_linear(self.query, x)), heads(_linear(self.key, x)),
                   heads(_linear(self.value, x)))
        if route == "kernel":
            out = whisper_attention(q, k, v)
        else:
            out = whisper_attention_plain(q, k, v)
        # the kernel writes (b, s, h, dh) memory: merging the heads is free
        return _linear(self.out, out.transpose(1, 2).reshape(b, s, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state)
        if cross_attention:  # the decoder's blocks
            self.cross_attn = MultiHeadAttention(n_state, n_head)
            self.cross_attn_ln = nn.LayerNorm(n_state)
        self.mlp = nn.Sequential(
            nn.Linear(n_state, 4 * n_state), nn.GELU(), nn.Linear(4 * n_state, n_state)
        )
        self.mlp_ln = nn.LayerNorm(n_state)

    def forward(self, x, prefix: str, tap, xa: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One block under the tap names of the module docstring; ``xa``
        (the decoder's blocks) adds the cross-attention branch, ``mask`` the
        self-attention's causal mask."""
        h = tap(f"{prefix}.attn_ln", self.attn_ln(x))
        x = x + tap(f"{prefix}.attn.out", self.attn(h, mask=mask))
        if xa is not None:
            def weights(w):  # capture only, as JAX's wtap: its result is dropped
                tap(f"{prefix}.cross_attn.weights", w)

            x = x + self.cross_attn(self.cross_attn_ln(x), xa=xa, weights_tap=weights)
        h = tap(f"{prefix}.mlp_ln", self.mlp_ln(x))
        h = tap(f"{prefix}.mlp.0", _linear(self.mlp[0], h))
        h = tap(f"{prefix}.mlp.1", self.mlp[1](h))
        h = tap(f"{prefix}.mlp.2", _linear(self.mlp[2], h))
        h = tap(f"{prefix}.mlp", h)
        return tap(prefix, x + h)


class AudioEncoder(nn.Module):
    """Whisper's audio encoder: (b, n_mels, 3000) log-mels → (b, 1500, d)."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_audio_state
        self.dims = dims
        self.conv1 = nn.Conv1d(dims.n_mels, d, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        self.register_buffer(
            "positional_embedding",
            torch.from_numpy(sinusoids(dims.n_audio_ctx, d)),
        )
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_audio_head)
            for _ in range(dims.n_audio_layer)
        )
        self.ln_post = nn.LayerNorm(d)

    def forward(
        self,
        mels: torch.Tensor,
        capture: Sequence[str] = (),
        substitute: Optional[Mapping[str, torch.Tensor]] = None,
        stop_after_capture: bool = False,
    ) -> tuple[Optional[torch.Tensor], Captures]:
        capture = frozenset(capture)
        store: Captures = {}
        tap = _tapper(capture, substitute or {}, store)

        def done() -> bool:
            return stop_after_capture and len(store) == len(capture)

        x = mels.to(self.positional_embedding.dtype)
        # convs run on (b, channels, T); the taps see (b, T, d) like JAX's
        x = tap("encoder.conv1", self.conv1(x).transpose(1, 2))
        x = F.gelu(x).transpose(1, 2)
        x = tap("encoder.conv2", self.conv2(x).transpose(1, 2))
        x = F.gelu(x)
        if done():
            return None, store
        x = x + self.positional_embedding
        for i, block in enumerate(self.blocks):
            x = block(x, f"encoder.blocks.{i}", tap)
            if done():
                return None, store
        x = tap("encoder.ln_post", self.ln_post(x))
        return x, store


def encoder_forward(
    module: AudioEncoder,
    dims: WhisperDims,
    mels: torch.Tensor,
    capture: Sequence[str] = (),
    substitute: Mapping[str, torch.Tensor] | None = None,
    compute_dtype: torch.dtype = torch.float32,
    stop_after_capture: bool = False,
) -> tuple[Optional[torch.Tensor], Captures]:
    """Encode (batch, n_mels, 3000) log-mels → (batch, 1500, d_model).

    Returns (encoded, captures); capture/substitute keys are the names in the
    module docstring. ``compute_dtype`` other than the module's parameter
    dtype runs the forward on cast copies of the parameters (the module is
    not changed). ``stop_after_capture`` ends the forward after the block
    holding the last captured name and returns ``encoded=None`` — eager
    PyTorch runs every layer it is given, where XLA dropped the unused tail.
    """
    if dims != module.dims:
        raise ValueError(f"dims {dims} do not match the module's {module.dims}")
    kwargs = dict(capture=capture, substitute=substitute,
                  stop_after_capture=stop_after_capture)
    if module.positional_embedding.dtype == compute_dtype:
        return module(mels, **kwargs)
    state = {k: v.to(compute_dtype) for k, v in module.state_dict().items()}
    return torch.func.functional_call(module, state, (mels,), kwargs)


def init_encoder(dims: WhisperDims, seed: int = 0,
                 device: torch.device | str = "cpu") -> AudioEncoder:
    """Random-initialized encoder (for tests / benchmarks) from a seeded
    ``torch.Generator``. Same distributions as the JAX ``init_params`` —
    uniform ±1/√d_in linears (k without bias), N(0, 1/(3·d_in)) convs with
    zero bias, unit LayerNorms — but not the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    enc = AudioEncoder(dims)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith(("_ln.weight", "ln_post.weight")):
                p.fill_(1.0)
            elif name.endswith(("_ln.bias", "ln_post.bias")):
                p.zero_()
            elif name.startswith("conv"):
                if name.endswith("weight"):
                    fan_in = p.shape[1] * p.shape[2]
                    p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(fan_in))
                else:
                    p.zero_()
            else:  # linear weight (out, in) or bias (out,) of a linear
                linear = enc.get_submodule(name.rsplit(".", 1)[0])
                bound = 1.0 / np.sqrt(linear.in_features)
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return enc.to(device)


# ---------------------------------------------------------------- decoder


class TextDecoder(nn.Module):
    """Whisper's text decoder: (b, T) tokens and (b, 1500, d) encoded audio
    → (b, T, n_vocab) logits (``decoder_forward``)."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_text_state
        self.dims = dims
        self.token_embedding = nn.Embedding(dims.n_vocab, d)
        self.positional_embedding = nn.Parameter(torch.empty(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_text_head, cross_attention=True)
            for _ in range(dims.n_text_layer)
        )
        self.ln = nn.LayerNorm(d)

    def forward(
        self,
        tokens: torch.Tensor,
        xa: torch.Tensor,
        capture: Sequence[str] = (),
        substitute: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> tuple[torch.Tensor, Captures]:
        """(b, T) tokens attending to (b, S, d) encoded audio, causal →
        ((b, T, n_vocab) f32 logits, captures)."""
        store: Captures = {}
        tap = _tapper(frozenset(capture), substitute or {}, store)
        t = tokens.shape[-1]
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        xa = xa.to(x.dtype)
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        for i, block in enumerate(self.blocks):
            x = block(x, f"decoder.blocks.{i}", tap, xa=xa, mask=causal)
        x = self.ln(x)
        return torch.matmul(x.float(), self.token_embedding.weight.float().T), store


def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module`` itself when its parameters are ``dtype``, else a cast copy
    (the module is not changed)."""
    if next(module.parameters()).dtype == dtype:
        return module
    return copy.deepcopy(module).to(dtype)


def decoder_forward(
    module: TextDecoder,
    dims: WhisperDims,
    tokens: torch.Tensor,
    encoded: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    *,
    capture: Sequence[str] = (),
    substitute: Mapping[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, Captures]:
    """Teacher-forced full-sequence decoder with a causal mask: (b, T)
    tokens → ((b, T, n_vocab) f32 logits, captures) — the counterpart of
    ``freud_tpu.models.whisper.model.decoder_forward`` and the oracle of the
    KV-cached step. Weights and ``encoded`` run in ``compute_dtype`` (a
    cast copy when the module differs). ``capture``/``substitute`` keys are
    the ``decoder.blocks.N…`` names of the module docstring (keywords here:
    ``compute_dtype`` keeps its place as the fifth argument)."""
    if dims != module.dims:
        raise ValueError(f"dims {dims} do not match the module's {module.dims}")
    dec = cast_module(module, compute_dtype)
    return dec(tokens, encoded.to(compute_dtype), capture, substitute)


def init_decoder(dims: WhisperDims, seed: int = 0,
                 device: torch.device | str = "cpu") -> TextDecoder:
    """Random-initialized decoder from a seeded ``torch.Generator``: the
    JAX ``init_params`` distributions — token embedding N(0, 0.02²),
    positional embedding N(0, 0.01²), uniform ±1/√d_in linears (keys
    without bias), unit LayerNorms — but not the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dec = TextDecoder(dims)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name == "token_embedding.weight":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name == "positional_embedding":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
            elif name.endswith("ln.weight"):
                p.fill_(1.0)
            elif name.endswith("ln.bias"):
                p.zero_()
            else:  # linear weight (out, in) or bias (out,) of a linear
                linear = dec.get_submodule(name.rsplit(".", 1)[0])
                bound = 1.0 / np.sqrt(linear.in_features)
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return dec.to(device)
