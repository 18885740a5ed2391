"""LongCat-Flash-Omni's audio path as ``nn.Module``s: a Whisper audio tower,
the projector, and the language model's shortcut-connected double layers
(two multi-head latent attentions, two dense SwiGLU FFNs and one mixture of
experts with identity zero experts, whose output lands at the end of the
double layer), with activation capture.

For each double layer, x the residual stream (LongCat-Flash's config keys;
PERF.md and the benchmark's configuration list what the config does not fix):

  h1 = x  + MLA_0(n_0(x))
  u  = n_1(h1)                    the MoE input, shared with the first dense FFN
  h2 = h1 + FFN_0(u)
  m  = MoE(u)
  h3 = h2 + MLA_1(n_2(h2))
  x' = h3 + FFN_1(n_3(h3)) + m    the shortcut lands at the end

MLA (heads H, q/kv latents of q_lora_rank / kv_lora_rank, a head's qk
width nope + rope against its v width):

  q = s_q · W_qb·RMSNorm(W_qa·n)                     (H, nope + rope) a token
  c = s_kv · RMSNorm(W_kva·n)[:kv_lora_rank]         the kv latent
  k_rope = W_kva·n[kv_lora_rank:], one for every head
  k_nope, v = W_kvb·c                                (H, nope), (H, v)
  out = W_o · Attn_causal([q_nope, RoPE(q_rope)], [k_nope, RoPE(k_rope)], v)

with s_q = √(d / q_lora_rank), s_kv = √(d / kv_lora_rank) (the LoRA scales),
the softmax scale 1/√(nope + rope), RoPE in the half-split layout at
rope_theta. The MoE (the router in f32 on the unrounded scores):

  p = softmax(u·W_rᵀ) over the routed experts, then the identity entries
  sel = the top moe_topk entries of p + b (b the selection bias; ties to
        the lower index)
  m = Σ_{e ∈ sel} scale·p_e·v_e,  v_e = E_e(u) for a held expert, u for an
      identity entry, nothing for an expert another card holds

Norms are RMSNorm (f32 mean square, cast back, times the weight); E, FFN
are SwiGLU without bias. The router's product runs on ``ops/gemm_f32x3.py``
(3xTF32 on the card), the selection and the held experts on ``ops/moe.py``
(``csrc/moe.cu``); the attention is ``F.scaled_dot_product_attention`` (a
fallback, not a kernel port). Everything runs in order on one stream; the
forward does not synchronise with the host.

A clip: the tower's first ``pool · query_tokens`` frames, average-pooled by
``pool`` and projected (one linear with bias), between the embedded
``prefix_ids`` and ``suffix_ids``; positions numbered in sequence.

Tap names (``LongCatModel.forward``'s ``capture``):

  encoder.blocks.N / encoder.ln_post ...   the tower (models/whisper/model.py)
  omni.projector                           the projected audio tokens
  lm.embed                                 the LM's input sequence
  lm.layers.N                              double layer N's output
  lm.layers.N.mlp.input                    u, the MoE input
  lm.layers.N.mlp.router                   p, (T, n_router) f32
  lm.layers.N.mlp.route                    sel, (T, moe_topk) int32

Spans: ``omni.tower`` around the tower; ``lm.mla`` around each MLA with its
norm (two a layer), ``lm.dense`` around each dense FFN with its norm (two),
``lm.moe`` around the router's product, the selection, plan, permute and
grouped products, and again around the combine that lands the shortcut
(two a layer). Each forward writes each layer's count of slots an entry
took, over every entry held or not, into the (layers, n_router) int32
table ``routes`` on the device (``LongCatRuntime.counters``).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import profiling
from ...ops import gemm_f32x3
from ...ops import moe as moe_ops
from ..omni.model import RMSNorm, apply_rope, positions, rope_table
from ..whisper.model import AudioEncoder, _tapper
from .config import LongCatConfig

Captures = dict[str, torch.Tensor]


class MLA(nn.Module):
    """Multi-head latent attention. ``qkv_a`` stacks W_qa over W_kva (both
    read the same normed input)."""

    def __init__(self, cfg: LongCatConfig):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        self.qkv_a = nn.Linear(d, cfg.q_lora_rank + cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                               bias=False)
        self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps)
        self.q_b_proj = nn.Linear(cfg.q_lora_rank, h * cfg.qk_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, d, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        h, nope, rope, vd = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim, cfg.v_head_dim)
        s_q, s_kv = cfg.q_scale, cfg.kv_scale
        qa, c, k_rope = self.qkv_a(x).split([cfg.q_lora_rank, cfg.kv_lora_rank, rope], dim=-1)
        q = self.q_b_proj(self.q_a_layernorm(qa))
        if s_q != 1.0:
            q = q * s_q
        q_nope, q_rope = q.view(b, t, h, cfg.qk_head_dim).transpose(1, 2).split([nope, rope], -1)
        c = self.kv_a_layernorm(c)
        if s_kv != 1.0:
            c = c * s_kv
        k_nope, v = self.kv_b_proj(c).view(b, t, h, nope + vd).transpose(1, 2).split([nope, vd],
                                                                                     -1)
        q = torch.cat([q_nope, apply_rope(q_rope, cos, sin)], dim=-1)
        k_rope = apply_rope(k_rope[:, None], cos, sin).expand(b, h, t, rope)
        k = torch.cat([k_nope, k_rope], dim=-1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             scale=1.0 / math.sqrt(cfg.qk_head_dim))
        return self.o_proj(out.transpose(1, 2).reshape(b, t, h * vd))


class DenseFFN(nn.Module):
    """A SwiGLU FFN; ``gate_up`` stacks the gate's rows over up's (one
    product)."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_up = nn.Linear(d, 2 * width, bias=False)
        self.down = nn.Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = self.gate_up(x).chunk(2, dim=-1)
        return self.down(F.silu(g) * u)


class MoE(nn.Module):
    """The router (f32 weights and selection bias over every entry) and the
    held experts stacked (n_held, I, d) and (n_held, d, I). ``route`` runs
    the router and the held experts; ``combine`` lands their sum, the
    identity entries' and the rest of the double layer's in one pass."""

    def __init__(self, cfg: LongCatConfig):
        super().__init__()
        d, i = cfg.hidden_size, cfg.expert_width
        self.cfg = cfg
        self.router = nn.Parameter(torch.zeros(cfg.n_router, d))
        self.bias = nn.Parameter(torch.zeros(cfg.n_router))
        self.w_gate = nn.Parameter(torch.zeros(cfg.n_held, i, d))
        self.w_up = nn.Parameter(torch.zeros(cfg.n_held, i, d))
        self.w_down = nn.Parameter(torch.zeros(cfg.n_held, d, i))

    def route(self, u: torch.Tensor, counts: torch.Tensor, prefix: str, tap) -> tuple:
        """u (T, d) → what ``combine`` takes; ``counts``: this layer's row of
        the slot-count table, written."""
        cfg = self.cfg
        logits = gemm_f32x3.linear(u.float(), self.router)
        probs, sel, wsel, _ = moe_ops.route_topk(logits, self.bias, cfg.top_k,
                                                 cfg.routed_scale, cfg.held, cfg.identity)
        tap(f"{prefix}.router", probs)
        tap(f"{prefix}.route", sel)
        offsets, pos = moe_ops.plan(sel, cfg.n_held, counts, cfg.held[0])
        a = moe_ops.permute(u, pos, u.shape[0] * cfg.top_k)
        h = moe_ops.gateup(a, counts, offsets, self.w_gate, self.w_up, cfg.held[0])
        y = moe_ops.down(h, counts, offsets, self.w_down, cfg.held[0])
        return y, pos, wsel, sel

    def combine(self, x: torch.Tensor, fixed: torch.Tensor, u: torch.Tensor,
                routed: tuple) -> torch.Tensor:
        """x + fixed + the MoE's output, (T, d)."""
        y, pos, wsel, sel = routed
        return moe_ops.combine(x, fixed, y, pos, wsel, u, sel, self.cfg.identity)


class DoubleLayer(nn.Module):
    def __init__(self, cfg: LongCatConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = nn.ModuleList(RMSNorm(d, eps) for _ in range(2))
        self.post_attention_layernorm = nn.ModuleList(RMSNorm(d, eps) for _ in range(2))
        self.self_attn = nn.ModuleList(MLA(cfg) for _ in range(2))
        self.mlps = nn.ModuleList(DenseFFN(d, cfg.ffn_width) for _ in range(2))
        self.mlp = MoE(cfg)

    def forward(self, x, cos, sin, counts, prefix: str, tap) -> torch.Tensor:
        shape = x.shape
        with profiling.span("lm.mla"):
            h1 = x + self.self_attn[0](self.input_layernorm[0](x), cos, sin)
        with profiling.span("lm.dense"):
            u = tap(f"{prefix}.mlp.input", self.post_attention_layernorm[0](h1))
            h2 = h1 + self.mlps[0](u)
        u = u.reshape(-1, shape[-1])
        with profiling.span("lm.moe"):
            routed = self.mlp.route(u, counts, f"{prefix}.mlp", tap)
        with profiling.span("lm.mla"):
            h3 = h2 + self.self_attn[1](self.input_layernorm[1](h2), cos, sin)
        with profiling.span("lm.dense"):
            f1 = self.mlps[1](self.post_attention_layernorm[1](h3))
        with profiling.span("lm.moe"):
            out = self.mlp.combine(h3.reshape(-1, shape[-1]), f1.reshape(-1, shape[-1]), u,
                                   routed)
        return tap(prefix, out.reshape(shape))


class LongCatModel(nn.Module):
    """The audio path: (b, n_mels, 3000) log-mels → the LM's residual
    stream. Holds ``n_layers`` double layers (a collection holds those up
    to its tap)."""

    def __init__(self, cfg: LongCatConfig, n_layers: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.n_layers = cfg.num_hidden_layers if n_layers is None else n_layers
        d = cfg.hidden_size
        self.tower = AudioEncoder(cfg.tower)
        self.projector = nn.Linear(cfg.tower.n_audio_state, d)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.layers = nn.ModuleList(DoubleLayer(cfg) for _ in range(self.n_layers))
        self.register_buffer("prompt_ids", torch.tensor(
            [*cfg.prefix_ids, *cfg.suffix_ids], dtype=torch.int64), persistent=False)
        self.register_buffer("routes", torch.zeros(
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
        with profiling.span("omni.tower"):
            encoded, caps = self.tower(mels, capture=[n for n in capture
                                                      if n.startswith("encoder.")])
        store.update(caps)
        audio = tap("omni.projector", self.audio_tokens(encoded))
        b = audio.shape[0]
        npre = len(cfg.prefix_ids)
        prompt = self.embed_tokens(self.prompt_ids).to(audio.dtype).expand(b, -1, -1)
        x = tap("lm.embed", torch.cat([prompt[:, :npre], audio, prompt[:, npre:]], dim=1))
        rope = cfg.qk_rope_head_dim
        cos, sin = rope_table(positions(x.shape[1], b, x.device)[:1], rope, cfg.rope_theta,
                              (rope // 2,))
        last = max((int(n.split(".")[2]) for n in capture if n.startswith("lm.layers.")),
                   default=self.n_layers - 1)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, self.routes[i], f"lm.layers.{i}", tap)
            if stop_after_capture and i == last:
                return None, store
        return x, store
