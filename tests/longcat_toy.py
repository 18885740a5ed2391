"""A toy LongCat-Flash-Omni for the tests: the published structure at small
widths (d 64, 4 heads with q/kv latents of 32/16, qk 8 + 4 and v 8, dense
FFNs of 48, 8 routed experts of 16 and 4 identity entries, top 3, a 1-block
Whisper tower of width 32), with seeded random weights in the HuggingFace
layout that ``models/longcat/load.py`` reads. ``held`` gives the share of
the routed experts the checkpoint holds."""

from __future__ import annotations

import math

import torch

from omni_toy import TOWER, tower_weights


def config(layers: int = 2, d: int = 64, heads: int = 4, q_lora: int = 32, kv_lora: int = 16,
           nope: int = 8, rope: int = 4, v: int = 8, ffn: int = 48, width: int = 16,
           n_routed: int = 8, n_zero: int = 4, top_k: int = 3, held=None,
           tower: dict | None = None, prefix=(3, 7, 11), suffix=(5, 9)) -> dict:
    held = (0, n_routed) if held is None else tuple(held)
    return {"model_type": "longcat_flash", "hidden_size": d, "num_layers": layers,
            "num_attention_heads": heads, "q_lora_rank": q_lora, "kv_lora_rank": kv_lora,
            "qk_nope_head_dim": nope, "qk_rope_head_dim": rope, "v_head_dim": v,
            "mla_scale_q_lora": True, "mla_scale_kv_lora": True, "rms_norm_eps": 1e-5,
            "rope_theta": 10000000, "vocab_size": 100, "ffn_hidden_size": ffn,
            "expert_ffn_hidden_size": width, "n_routed_experts": held[1] - held[0],
            "zero_expert_num": n_zero, "zero_expert_type": "identity", "moe_topk": top_k,
            "routed_scaling_factor": 6, "attention_bias": False,
            "deployment": {"n_routed_experts": n_routed, "held_experts": list(held)},
            "audio_tokens": 375, "audio_seconds": 30, "audio_tower": dict(tower or TOWER),
            "audio_prompt": {"prefix_ids": list(prefix), "suffix_ids": list(suffix)}}


def layer_weights(cfg: dict, g: torch.Generator, router_scale: float = 2.0,
                  bias_scale: float = 0.02) -> dict:
    """One double layer's weights (names without ``model.layers.N.``), f32,
    every routed expert of the router included."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    ql, kl = cfg["q_lora_rank"], cfg["kv_lora_rank"]

    def u(*shape, fan):
        return (torch.rand(shape, generator=g) * 2 - 1) / math.sqrt(fan)

    w = {}
    for half in range(2):
        for norm in ("input_layernorm", "post_attention_layernorm"):
            w[f"{norm}.{half}.weight"] = 1 + 0.1 * torch.randn(d, generator=g)
        p = f"self_attn.{half}."
        w[p + "q_a_proj.weight"] = u(ql, d, fan=d)
        w[p + "q_a_layernorm.weight"] = 1 + 0.1 * torch.randn(ql, generator=g)
        w[p + "q_b_proj.weight"] = u(heads * (nope + rd), ql, fan=ql)
        w[p + "kv_a_proj_with_mqa.weight"] = u(kl + rd, d, fan=d)
        w[p + "kv_a_layernorm.weight"] = 1 + 0.1 * torch.randn(kl, generator=g)
        w[p + "kv_b_proj.weight"] = u(heads * (nope + vd), kl, fan=kl)
        w[p + "o_proj.weight"] = u(d, heads * vd, fan=heads * vd)
        p = f"mlps.{half}."
        w[p + "gate_proj.weight"] = u(cfg["ffn_hidden_size"], d, fan=d)
        w[p + "up_proj.weight"] = u(cfg["ffn_hidden_size"], d, fan=d)
        w[p + "down_proj.weight"] = u(d, cfg["ffn_hidden_size"], fan=cfg["ffn_hidden_size"])
    n_routed = cfg["deployment"]["n_routed_experts"]
    n_router = n_routed + cfg["zero_expert_num"]
    w["mlp.router.classifier.weight"] = torch.randn(n_router, d, generator=g) * (
        router_scale / math.sqrt(d))
    w["mlp.router.e_score_correction_bias"] = bias_scale * torch.randn(n_router, generator=g)
    width = cfg["expert_ffn_hidden_size"]
    for e in range(n_routed):
        p = f"mlp.experts.{e}."
        w[p + "gate_proj.weight"] = u(width, d, fan=d)
        w[p + "up_proj.weight"] = u(width, d, fan=d)
        w[p + "down_proj.weight"] = u(d, width, fan=width)
    return w


def checkpoint(cfg: dict, seed: int = 0) -> tuple[dict, dict]:
    """(state dict in the HuggingFace layout, holding the configuration's
    share of the routed experts; the reference's copy: {"layers": per-layer
    f32 weights with every routed expert, "tower": the tower's, and the
    projector's and embedding's under their full names}), from one draw: the
    same seed gives the same model whatever the share."""
    g = torch.Generator().manual_seed(seed)
    d, w = cfg["hidden_size"], cfg["audio_tower"]["n_audio_state"]
    layers = [layer_weights(cfg, g) for _ in range(cfg["num_layers"])]
    tower = tower_weights(cfg["audio_tower"], g)
    sd = {"model.embed_tokens.weight": torch.randn(cfg["vocab_size"], d, generator=g) * 0.02,
          "model.audio_projector.weight": (torch.rand(d, w, generator=g) * 2 - 1) / math.sqrt(w),
          "model.audio_projector.bias": (torch.rand(d, generator=g) * 2 - 1) / math.sqrt(w)}
    other = {k: v.clone() for k, v in sd.items()}
    lo, hi = cfg["deployment"]["held_experts"]
    for i, lw in enumerate(layers):
        for k, v in lw.items():
            if k.startswith("mlp.experts.") and not lo <= int(k.split(".")[2]) < hi:
                continue
            sd[f"model.layers.{i}.{k}"] = v.clone()
    sd.update({f"model.audio_tower.{k}": v.clone() for k, v in tower.items()})
    return sd, {"layers": layers, "tower": tower, **other}
