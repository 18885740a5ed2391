"""LongCat-Flash-Omni's audio path in plain float32 PyTorch: the Whisper
tower, the projector, the language model's shortcut-connected double layers
and the TopK SAE's latents, from HuggingFace-layout weights (the names of
``freud_tpu_torch/models/longcat/load.py``'s docstring, each layer's without
its ``model.layers.N.`` prefix).

It imports nothing but torch and follows LongCat-Flash's double layer as
its config fixes it:

  h1 = x + MLA_0(n_0(x)); u = n_1(h1); h2 = h1 + FFN_0(u); m = MoE(u)
  h3 = h2 + MLA_1(n_2(h2)); out = h3 + FFN_1(n_3(h3)) + m

with its stated readings of what the config leaves open (the benchmark's
configuration file lists them under ``assumed``): the LoRA scales
√(d / q_lora_rank) on q and √(d / kv_lora_rank) on the normed kv latent,
the softmax scale 1/√(qk_nope + qk_rope), RoPE in the half-split layout on
the 64 decoupled dims with k's rope part shared by every head, SwiGLU dense
FFNs and experts without bias, RMSNorm (ε rms_norm_eps). The router: p =
softmax(u·W_rᵀ) over the routed experts then the identity entries, the top
moe_topk entries of p + b (b the selection bias; ties to the lower index),
weights routed_scaling_factor · p, not renormalised. The share: an identity
entry adds its weight times u; a routed expert adds its weight times its
SwiGLU of u only if it is held (``deployment.held_experts``, [lo, hi)); an
expert another card holds adds nothing here, as on the card. Positions are
numbered in sequence. The tower's first pool · tokens frames are averaged
by pool and projected by one linear with bias. Attention is causal softmax
attention written out; no kernel, cache or batching of the program's.

``operand`` rounds the operands of every product (the control's lower
precision); None keeps float32. The caller pins TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), back to float32."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _lin(x, w, b=None, operand=None):
    if operand is not None:
        x, w = operand(x), operand(w)
    return F.linear(x, w, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(seq_len: int, dim: int, theta: float, device):
    """(cos, sin), (T, dim): pair j turns at theta^(-2j/dim) times the
    position; the second half repeats the first (half-split layout)."""
    pos = torch.arange(seq_len, device=device, dtype=torch.float64)
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float64) / dim)
    f = pos[:, None] * inv
    emb = torch.cat([f, f], dim=-1)
    return emb.cos().float(), emb.sin().float()


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def share(cfg: dict) -> tuple:
    """(routed experts the router scores, (lo, hi) the held ones)."""
    dep = cfg.get("deployment") or {}
    n_routed = dep.get("n_routed_experts", cfg["n_routed_experts"])
    return n_routed, tuple(dep.get("held_experts", (0, cfg["n_routed_experts"])))


def mla(w: dict, cfg: dict, half: int, n: torch.Tensor, cos, sin,
        operand=None) -> torch.Tensor:
    """(b, T, d) normed input → W_o·causal attention of MLA ``half``."""
    p = f"self_attn.{half}."
    b, t, d = n.shape
    heads, eps = cfg["num_attention_heads"], cfg["rms_norm_eps"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    kl = cfg["kv_lora_rank"]
    s_q = math.sqrt(d / cfg["q_lora_rank"]) if cfg["mla_scale_q_lora"] else 1.0
    s_kv = math.sqrt(d / kl) if cfg["mla_scale_kv_lora"] else 1.0
    qa = rms_norm(_lin(n, w[p + "q_a_proj.weight"], None, operand),
                  w[p + "q_a_layernorm.weight"], eps)
    q = (_lin(qa, w[p + "q_b_proj.weight"], None, operand) * s_q)
    q = q.view(b, t, heads, nope + rd).transpose(1, 2)
    c, k_rope = _lin(n, w[p + "kv_a_proj_with_mqa.weight"], None, operand).split([kl, rd], -1)
    c = rms_norm(c, w[p + "kv_a_layernorm.weight"], eps) * s_kv
    kv = _lin(c, w[p + "kv_b_proj.weight"], None, operand).view(b, t, heads, nope + vd)
    k_nope, v = kv.transpose(1, 2).split([nope, vd], -1)
    q_nope, q_rope = q.split([nope, rd], -1)
    q = torch.cat([q_nope, _rotate(q_rope, cos, sin)], dim=-1)
    k = torch.cat([k_nope, _rotate(k_rope[:, None], cos, sin).expand(b, heads, t, rd)], dim=-1)
    if operand is not None:
        q, k, v = operand(q), operand(k), operand(v)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(nope + rd)
    mask = torch.ones(t, t, dtype=torch.bool, device=n.device).tril()
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    if operand is not None:
        att = operand(att)
    out = (att @ v).transpose(1, 2).reshape(b, t, heads * vd)
    return _lin(out, w[p + "o_proj.weight"], None, operand)


def swiglu(x, gate, up, down, operand=None):
    return _lin(F.silu(_lin(x, gate, None, operand)) * _lin(x, up, None, operand), down,
                None, operand)


def route(scores: torch.Tensor, top_k: int):
    """(T, n) biased scores → (sel (T, top_k) int64: the top_k entries, ties
    to the lower index; margin (T,): the gap between the top_k-th score and
    the next, over the spread (standard deviation) of the row's scores)."""
    v, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    margin = (v[:, top_k - 1] - v[:, top_k]) / scores.std(-1).clamp(min=1e-30)
    return idx[:, :top_k], margin


def moe(w: dict, cfg: dict, u: torch.Tensor, operand=None, held=None) -> dict:
    """The MoE on (T, d) inputs → {"held", "identity" (the two parts of its
    output), "m" (their sum), "probs", "sel", "margin"}; ``held`` overrides
    the configuration's share ((0, 0): no expert)."""
    n_routed, own = share(cfg)
    lo, hi = own if held is None else held
    probs = torch.softmax(_lin(u, w["mlp.router.classifier.weight"], None, operand), dim=-1)
    sel, margin = route(probs + w["mlp.router.e_score_correction_bias"], cfg["moe_topk"])
    wsel = cfg["routed_scaling_factor"] * probs.gather(1, sel)
    ident = (wsel * (sel >= n_routed)).sum(1, keepdim=True) * u
    part = torch.zeros_like(u)
    for e in range(lo, hi):
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        p = f"mlp.experts.{e}."
        out = swiglu(u[rows], w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                     w[p + "down_proj.weight"], operand)
        part.index_add_(0, rows, wsel[rows, slot][:, None] * out)
    return {"held": part, "identity": ident, "m": part + ident, "probs": probs, "sel": sel,
            "margin": margin}


def layer(w: dict, cfg: dict, x: torch.Tensor, operand=None, held=None) -> dict:
    """One double layer on (b, T, d) inputs → {"out", "u" (its MoE input),
    "probs" (T·b, n), "sel", "margin", "moe" (``moe``'s dict)}, tokens
    flattened batch-major."""
    eps = cfg["rms_norm_eps"]
    b, t, d = x.shape
    cos, sin = rope(t, cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), x.device)

    def ffn(half, z):
        p = f"mlps.{half}."
        return swiglu(z, w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                      w[p + "down_proj.weight"], operand)

    h1 = x + mla(w, cfg, 0, rms_norm(x, w["input_layernorm.0.weight"], eps), cos, sin, operand)
    u = rms_norm(h1, w["post_attention_layernorm.0.weight"], eps)
    h2 = h1 + ffn(0, u)
    r = moe(w, cfg, u.reshape(b * t, d), operand, held)
    h3 = h2 + mla(w, cfg, 1, rms_norm(h2, w["input_layernorm.1.weight"], eps), cos, sin,
                  operand)
    out = h3 + ffn(1, rms_norm(h3, w["post_attention_layernorm.1.weight"], eps))
    out = out + r["m"].reshape(b, t, d)
    return {"out": out, "u": u.reshape(b * t, d), "probs": r["probs"], "sel": r["sel"],
            "margin": r["margin"], "moe": r}


def tower(w: dict, dims: dict, mels: torch.Tensor) -> torch.Tensor:
    """(b, n_mels, 3000) log-mels → (b, n_ctx, width): the Whisper encoder
    and its final LayerNorm, HuggingFace Whisper names without the
    ``model.audio_tower.`` prefix."""
    d, heads = dims["n_audio_state"], dims["n_audio_head"]
    x = F.gelu(F.conv1d(mels, w["conv1.weight"], w["conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, w["conv2.weight"], w["conv2.bias"], stride=2, padding=1))
    x = x.transpose(1, 2) + w["embed_positions.weight"]
    b, t, _ = x.shape
    scale = (d // heads) ** -0.25
    for i in range(dims["n_audio_layer"]):
        p = f"layers.{i}."
        h = F.layer_norm(x, (d,), w[p + "self_attn_layer_norm.weight"],
                         w[p + "self_attn_layer_norm.bias"])
        q = F.linear(h, w[p + "self_attn.q_proj.weight"], w[p + "self_attn.q_proj.bias"])
        k = F.linear(h, w[p + "self_attn.k_proj.weight"])
        v = F.linear(h, w[p + "self_attn.v_proj.weight"], w[p + "self_attn.v_proj.bias"])
        q, k, v = (z.view(b, t, heads, d // heads).transpose(1, 2) for z in (q, k, v))
        att = torch.softmax((q * scale) @ (k * scale).transpose(-1, -2), dim=-1) @ v
        att = att.transpose(1, 2).reshape(b, t, d)
        x = x + F.linear(att, w[p + "self_attn.out_proj.weight"],
                         w[p + "self_attn.out_proj.bias"])
        h = F.layer_norm(x, (d,), w[p + "final_layer_norm.weight"],
                         w[p + "final_layer_norm.bias"])
        x = x + F.linear(F.gelu(F.linear(h, w[p + "fc1.weight"], w[p + "fc1.bias"])),
                         w[p + "fc2.weight"], w[p + "fc2.bias"])
    return F.layer_norm(x, (d,), w["layer_norm.weight"], w["layer_norm.bias"])


def audio_tokens(encoded: torch.Tensor, proj_w, proj_b, pool: int, tokens: int):
    """(b, frames, width) → (b, tokens, d): the first pool·tokens frames
    averaged by pool, then the projector."""
    b, _, width = encoded.shape
    x = encoded[:, :pool * tokens].reshape(b, tokens, pool, width).mean(2)
    return F.linear(x, proj_w, proj_b)


def sae_latents(sae: dict, x: torch.Tensor) -> torch.Tensor:
    """relu((x − b_dec)·W_encᵀ + b_enc): every latent before the TopK."""
    return torch.relu((x - sae["b_dec"]) @ sae["encoder.weight"].T + sae["encoder.bias"])
