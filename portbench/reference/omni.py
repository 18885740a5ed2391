"""Uni-MoE-2.0-Omni's audio path in plain float32 PyTorch: the Whisper
tower, the projector, the language model's layers and the TopK SAE's
latents, from HuggingFace-layout weights (the names of
``freud_tpu_torch/models/omni/load.py``'s docstring, each layer's without
its ``model.layers.N.`` prefix).

It imports nothing but torch and follows the layer equations as
Uni-MoE-2.0-Omni's config fixes them, with its stated readings of what the
config leaves open (the benchmark's configuration file lists them under
``assumed``): q/k/v with bias, o without; the combine weight p_e of the
softmax over every router entry, not renormalised over the selection; the
fixed experts' sum ungated; (t, h, w) positions equal and numbered in
sequence; the tower's first pool · query_tokens frames averaged by pool and
projected by one linear with bias. Attention is causal softmax attention
written out; no kernel, cache or batching of the program's.

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


def rope(seq_len: int, head_dim: int, theta: float, sections, device):
    """(cos, sin), (T, head_dim): pair j turns at theta^(-2j/head_dim)
    times its section's position id (t, h, w equal: the position)."""
    pos = torch.arange(seq_len, device=device, dtype=torch.float64)
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device,
                                       dtype=torch.float64) / head_dim)
    assert sum(sections) == head_dim // 2
    ids = torch.stack([pos] * len(sections))                   # (3, T)
    axis = torch.repeat_interleave(torch.arange(len(sections), device=device),
                                   torch.tensor(list(sections), device=device))
    f = ids[axis].T * inv                                      # (T, hd/2)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos().float(), emb.sin().float()


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def attention(w: dict, cfg: dict, n: torch.Tensor, cos, sin, operand=None) -> torch.Tensor:
    """(b, T, d) normed input → W_o·causal attention, grouped KV heads."""
    b, t, d = n.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    q = _lin(n, w["self_attn.q_proj.weight"], w["self_attn.q_proj.bias"], operand)
    k = _lin(n, w["self_attn.k_proj.weight"], w["self_attn.k_proj.bias"], operand)
    v = _lin(n, w["self_attn.v_proj.weight"], w["self_attn.v_proj.bias"], operand)
    q = _rotate(q.view(b, t, heads, hd).transpose(1, 2), cos, sin)
    k = _rotate(k.view(b, t, kv, hd).transpose(1, 2), cos, sin)
    v = v.view(b, t, kv, hd).transpose(1, 2)
    k = k.repeat_interleave(heads // kv, dim=1)
    v = v.repeat_interleave(heads // kv, dim=1)
    if operand is not None:
        q, k, v = operand(q), operand(k), operand(v)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=n.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    if operand is not None:
        p = operand(p)
    out = (p @ v).transpose(1, 2).reshape(b, t, d)
    return _lin(out, w["self_attn.o_proj.weight"], None, operand)


def route(p: torch.Tensor, top_p: float, top_k: int):
    """(T, n) router probabilities → (sel (T, top_k) int64, -1 where none;
    wsel (T, top_k); margin (T,)): the entries by p, ties to the lower
    index; entry j taken while j < top_k and the sum of those before it is
    below top_p. The margin is how far p lies from changing the selected
    set: the least of |sum before j − top_p| over the decisions made, and
    the gap between the last entry taken and the next."""
    ps, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    before = torch.cat([torch.zeros_like(ps[:, :1]), torch.cumsum(ps, -1)[:, :-1]], dim=1)
    take = before[:, :top_k] < top_p
    take[:, 0] = True
    sel = torch.where(take, idx[:, :top_k], -1)
    wsel = torch.where(take, ps[:, :top_k], 0.0)
    n = take.sum(1)
    gaps = [ps.gather(1, (n - 1)[:, None])[:, 0] - ps.gather(1, n.clamp(max=p.shape[1] - 1)
                                                           [:, None])[:, 0]]
    for j in range(1, top_k):
        made = n >= j  # decision j was made (taken, or the first refused)
        gaps.append(torch.where(made, (before[:, j] - top_p).abs(), torch.inf))
    return sel, wsel, torch.stack(gaps, 1).min(1).values


def swiglu(x, gate, up, down, operand=None):
    return _lin(F.silu(_lin(x, gate, None, operand)) * _lin(x, up, None, operand), down,
                None, operand)


def layer(w: dict, cfg: dict, x: torch.Tensor, operand=None) -> dict:
    """One LM layer on (b, T, d) inputs → {"out", "u" (its MoE input),
    "probs" (T·b, n), "sel", "margin"}, tokens flattened batch-major."""
    eps = cfg["rms_norm_eps"]
    b, t, d = x.shape
    hd = d // cfg["num_attention_heads"]
    cos, sin = rope(t, hd, float(cfg["rope_theta"]), cfg["rope_scaling"]["mrope_section"],
                    x.device)
    h = x + attention(w, cfg, rms_norm(x, w["input_layernorm.weight"], eps), cos, sin,
                      operand)
    u = rms_norm(h, w["post_attention_layernorm.weight"], eps).reshape(b * t, d)
    probs = torch.softmax(_lin(u, w["mlp.gate.weight"], None, operand), dim=-1)
    sel, wsel, margin = route(probs, cfg["mlp_dynamic_top_p"], cfg["mlp_dynamic_top_k"])
    y = h.reshape(b * t, d).clone()
    for f in range(cfg["mlp_fixed_expert_num"]):
        p = f"mlp.fixed_experts.{f}."
        y += swiglu(u, w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                    w[p + "down_proj.weight"], operand)
    for e in range(cfg["mlp_dynamic_expert_num"]):
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        p = f"mlp.experts.{e}."
        out = swiglu(u[rows], w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                     w[p + "down_proj.weight"], operand)
        y.index_add_(0, rows, wsel[rows, slot][:, None] * out)
    return {"out": y.reshape(b, t, d), "u": u, "probs": probs, "sel": sel, "margin": margin}


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
