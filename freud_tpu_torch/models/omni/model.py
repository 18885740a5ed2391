"""Uni-MoE-2.0-Omni's audio path as ``nn.Module``s: the Whisper audio tower,
the projector, and the decoder-only language model (Qwen2-style GQA with
M-RoPE, a top-p mixture of experts with a null expert, two always-on fixed
experts), with activation capture.

For each LM layer, x the residual stream (Uni-MoE-2.0-Omni's config keys;
PERF.md and the benchmark's configuration list what the config does not fix):

  h = x + W_o·Attn_causal(RoPE_M(W_q·n + b_q), RoPE_M(W_k·n + b_k), W_v·n + b_v),
      n = RMSNorm_1(x)
  u = RMSNorm_2(h)
  p = softmax(W_r·u) in f32 over the dynamic experts, then the null one
  sel = the shortest prefix of the entries by p (ties to the lower index)
        whose sum reaches top_p, cut at top_k
  y = h + Σ_fixed F(u) + Σ_{e ∈ sel, e not null} p_e·E_e(u)

F and E are SwiGLU, W_down(silu(W_gate·u) ⊙ W_up·u), without bias. The
routed half runs ``ops/moe.py`` (the CUDA kernels of ``csrc/moe.cu`` on the
card); the fixed experts are one dense SwiGLU of their summed width; the
attention is ``F.scaled_dot_product_attention`` (a fallback, not a kernel
port). The forward does not synchronise with the host.

A clip: the tower's first ``pool · query_tokens`` frames, average-pooled by
``pool`` and projected (one linear with bias), between the embedded
``prefix_ids`` and ``suffix_ids``; (t, h, w) positions equal, numbered in
sequence (M-RoPE then turns as 1-D RoPE; the code carries (3, T) ids).

Tap names (``OmniModel.forward``'s ``capture``):

  encoder.blocks.N / encoder.ln_post ...   the tower (models/whisper/model.py)
  omni.projector                           the projected audio tokens
  lm.embed                                 the LM's input sequence
  lm.layers.N                              layer N's output (residual stream)
  lm.layers.N.self_attn                    layer N's attention output (W_o·…)
  lm.layers.N.post_attention_layernorm     u
  lm.layers.N.mlp.router                   p, (T, n_router) f32
  lm.layers.N.mlp.route                    sel, (T, top_k) int32 (-1: none)

Spans: ``omni.tower`` around the tower, ``lm.attention`` and ``lm.moe``
around each layer's two halves. Each forward writes each layer's count of
tokens an entry took, null included, into the (layers, n_router) int32
table ``moe_tokens`` on the device (``OmniRuntime.counters``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import profiling
from ...ops import moe as moe_ops
from ..whisper.model import AudioEncoder, _tapper
from .config import OmniConfig

Captures = dict[str, torch.Tensor]


class RMSNorm(nn.Module):
    """Qwen2's: the mean square in f32, the normalised row cast back to the
    input's dtype, then the weight."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x32.to(x.dtype)


def positions(seq_len: int, batch: int, device) -> torch.Tensor:
    """(3, batch, seq_len) (t, h, w) ids: equal, numbered in sequence."""
    return torch.arange(seq_len, device=device).expand(3, batch, seq_len)


def rope_table(pos: torch.Tensor, head_dim: int, theta: float, sections: Sequence[int]
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE: (3, b, T) position ids → (cos, sin), each (b, T, head_dim)
    f32. Frequency pair j turns at theta^(-2j/head_dim) times the id of the
    axis whose section holds j (sections in the order t, h, w); the second
    half of the head repeats the first (rotate-half pairing)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=pos.device,
                                        dtype=torch.float32) / head_dim))
    freqs = pos[..., None].float() * inv                     # (3, b, T, hd/2)
    bounds = [sum(sections[:s]) for s in range(len(sections) + 1)]
    f = torch.cat([freqs[s, ..., bounds[s]:bounds[s + 1]] for s in range(len(sections))],
                  dim=-1)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, heads, T, hd); cos, sin (b, T, hd), cast to x's dtype."""
    cos, sin = cos[:, None].to(x.dtype), sin[:, None].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


class Attention(nn.Module):
    def __init__(self, cfg: OmniConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.heads, self.kv_heads, self.head_dim = (cfg.num_attention_heads,
                                                    cfg.num_key_value_heads, hd)
        self.q_proj = nn.Linear(d, self.heads * hd)
        self.k_proj = nn.Linear(d, self.kv_heads * hd)
        self.v_proj = nn.Linear(d, self.kv_heads * hd)
        self.o_proj = nn.Linear(self.heads * hd, d, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        def heads(z, n):
            return z.view(b, t, n, self.head_dim).transpose(1, 2)

        q = apply_rope(heads(self.q_proj(x), self.heads), cos, sin)
        k = apply_rope(heads(self.k_proj(x), self.kv_heads), cos, sin)
        v = heads(self.v_proj(x), self.kv_heads)
        groups = self.heads // self.kv_heads
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.transpose(1, 2).reshape(b, t, self.heads * self.head_dim))


def fixed_experts(u: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                  down: torch.Tensor) -> torch.Tensor:
    """The always-on experts as one SwiGLU of their summed width (the sum of
    the experts' outputs): (T, d) → (T, d)."""
    return F.linear(F.silu(F.linear(u, gate)) * F.linear(u, up), down)


class MoE(nn.Module):
    """The FFN: the router (f32), the dynamic experts stacked (n_dyn, I, d)
    and (n_dyn, d, I), the fixed experts' weights concatenated."""

    def __init__(self, cfg: OmniConfig):
        super().__init__()
        d, i, fw = cfg.hidden_size, cfg.dynamic_width, cfg.n_fixed * cfg.fixed_width
        self.cfg = cfg
        self.router = nn.Parameter(torch.zeros(cfg.n_router, d))
        self.w_gate = nn.Parameter(torch.zeros(cfg.n_dynamic, i, d))
        self.w_up = nn.Parameter(torch.zeros(cfg.n_dynamic, i, d))
        self.w_down = nn.Parameter(torch.zeros(cfg.n_dynamic, d, i))
        self.fixed_gate = nn.Parameter(torch.zeros(fw, d))
        self.fixed_up = nn.Parameter(torch.zeros(fw, d))
        self.fixed_down = nn.Parameter(torch.zeros(d, fw))

    def forward(self, h: torch.Tensor, u: torch.Tensor, counts: torch.Tensor, prefix: str,
                tap) -> torch.Tensor:
        """h (residual) and u (its RMSNorm), (b, T, d); ``counts``: this
        layer's row of the token-count table, written."""
        cfg = self.cfg
        shape = h.shape
        h2, u2 = h.reshape(-1, shape[-1]), u.reshape(-1, shape[-1])
        probs, sel, wsel = moe_ops.route(u2, self.router, cfg.top_p, cfg.top_k)
        tap(f"{prefix}.router", probs)
        tap(f"{prefix}.route", sel)
        offsets, pos = moe_ops.plan(sel, cfg.n_dynamic, counts)
        a = moe_ops.permute(u2, pos, u2.shape[0] * cfg.top_k)
        y = moe_ops.down(moe_ops.gateup(a, counts, offsets, self.w_gate, self.w_up),
                         counts, offsets, self.w_down)
        fixed = fixed_experts(u2, self.fixed_gate, self.fixed_up, self.fixed_down)
        return moe_ops.combine(h2, fixed, y, pos, wsel).reshape(shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: OmniConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoE(cfg)

    def forward(self, x, cos, sin, counts, prefix: str, tap) -> torch.Tensor:
        with profiling.span("lm.attention"):
            h = x + tap(f"{prefix}.self_attn", self.self_attn(self.input_layernorm(x), cos, sin))
        with profiling.span("lm.moe"):
            u = tap(f"{prefix}.post_attention_layernorm", self.post_attention_layernorm(h))
            y = self.mlp(h, u, counts, f"{prefix}.mlp", tap)
        return tap(prefix, y)


class OmniModel(nn.Module):
    """The audio path: (b, n_mels, 3000) log-mels → the LM's residual
    stream. Holds ``n_layers`` LM layers (a collection holds those up to
    its tap)."""

    def __init__(self, cfg: OmniConfig, n_layers: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.n_layers = cfg.num_hidden_layers if n_layers is None else n_layers
        d = cfg.hidden_size
        self.tower = AudioEncoder(cfg.tower)
        self.projector = nn.Linear(cfg.tower.n_audio_state, d)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(self.n_layers))
        self.register_buffer("prompt_ids", torch.tensor(
            [*cfg.prefix_ids, *cfg.suffix_ids], dtype=torch.int64), persistent=False)
        self.register_buffer("moe_tokens", torch.zeros(
            (self.n_layers, cfg.n_router), dtype=torch.int32), persistent=False)

    def audio_tokens(self, encoded: torch.Tensor) -> torch.Tensor:
        """(b, frames, tower width) → (b, query_tokens, d): the first
        pool·query_tokens frames, averaged by pool (in f32), projected."""
        cfg = self.cfg
        b, _, w = encoded.shape
        x = encoded[:, :cfg.pool * cfg.query_tokens].reshape(b, cfg.query_tokens, cfg.pool, w)
        return self.projector(x.float().mean(2).to(encoded.dtype))

    def forward(self, mels: torch.Tensor, capture: Sequence[str] = (),
                substitute: Optional[Mapping[str, torch.Tensor]] = None,
                stop_after_capture: bool = False) -> tuple[Optional[torch.Tensor], Captures]:
        cfg = self.cfg
        capture = frozenset(capture)
        store: Captures = {}
        tap = _tapper(capture, substitute or {}, store)
        tower_caps = [n for n in capture if n.startswith("encoder.")]
        with profiling.span("omni.tower"):
            encoded, caps = self.tower(mels, capture=tower_caps)
        store.update(caps)
        audio = tap("omni.projector", self.audio_tokens(encoded))
        b = audio.shape[0]
        npre = len(cfg.prefix_ids)
        prompt = self.embed_tokens(self.prompt_ids).to(audio.dtype).expand(b, -1, -1)
        x = tap("lm.embed", torch.cat([prompt[:, :npre], audio, prompt[:, npre:]], dim=1))
        cos, sin = rope_table(positions(x.shape[1], b, x.device), cfg.head_dim,
                              cfg.rope_theta, cfg.mrope_section)
        last = max((int(n.split(".")[2]) for n in capture if n.startswith("lm.layers.")),
                   default=self.n_layers - 1)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, self.moe_tokens[i], f"lm.layers.{i}", tap)
            if stop_after_capture and i == last:
                return None, store
        return x, store
