"""A toy Uni-MoE-2.0-Omni for the tests: the published structure at small
widths (d 64, 4 query heads over 2 KV heads, 4 dynamic experts of width 16
and a null one, 2 fixed experts of width 8, a 1-block Whisper tower of
width 32), with seeded random weights in the HuggingFace layout that
``models/omni/load.py`` reads."""

from __future__ import annotations

import math

import torch

TOWER = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 32, "n_audio_head": 2,
         "n_audio_layer": 1, "n_vocab": 51865, "n_text_ctx": 448, "n_text_state": 32,
         "n_text_head": 2, "n_text_layer": 1}


def config(layers: int = 2, d: int = 64, heads: int = 4, kv: int = 2, sections=(2, 3, 3),
           width: int = 16, fixed: int = 8, tower: dict | None = None,
           prefix=(3, 7, 11), suffix=(5, 9)) -> dict:
    return {"model_type": "grin_qwen2_vl", "hidden_size": d, "num_hidden_layers": layers,
            "num_attention_heads": heads, "num_key_value_heads": kv, "rms_norm_eps": 1e-6,
            "rope_theta": 1000000, "rope_scaling": {"mrope_section": list(sections)},
            "vocab_size": 100, "mlp_dynamic_expert_num": 4, "dynamic_intermediate_size": width,
            "mlp_dynamic_null_expert_num": 1, "mlp_dynamic_top_p": 0.7,
            "mlp_dynamic_top_k": 2, "mlp_fixed_expert_num": 2,
            "shared_intermediate_size": fixed, "whisper_query_tokens_size": 200,
            "whisper_audio_time": 20, "whisper_hidden_size": (tower or TOWER)["n_audio_state"],
            "audio_tower": dict(tower or TOWER),
            "audio_prompt": {"prefix_ids": list(prefix), "suffix_ids": list(suffix)}}


def layer_weights(cfg: dict, g: torch.Generator, router_scale: float = 1.5) -> dict:
    """One LM layer's weights (names without ``model.layers.N.``), f32."""
    d, heads, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads

    def u(*shape, fan):
        return (torch.rand(shape, generator=g) * 2 - 1) / math.sqrt(fan)

    w = {"input_layernorm.weight": 1 + 0.1 * torch.randn(d, generator=g),
         "post_attention_layernorm.weight": 1 + 0.1 * torch.randn(d, generator=g)}
    for name, rows in (("q_proj", heads * hd), ("k_proj", kv * hd), ("v_proj", kv * hd)):
        w[f"self_attn.{name}.weight"] = u(rows, d, fan=d)
        w[f"self_attn.{name}.bias"] = u(rows, fan=d)
    w["self_attn.o_proj.weight"] = u(d, heads * hd, fan=heads * hd)
    n_router = cfg["mlp_dynamic_expert_num"] + cfg["mlp_dynamic_null_expert_num"]
    w["mlp.gate.weight"] = torch.randn(n_router, d, generator=g) * router_scale / math.sqrt(d)
    experts = [(f"mlp.experts.{e}.", cfg["dynamic_intermediate_size"])
               for e in range(cfg["mlp_dynamic_expert_num"])]
    experts += [(f"mlp.fixed_experts.{f}.", cfg["shared_intermediate_size"])
                for f in range(cfg["mlp_fixed_expert_num"])]
    for p, width in experts:
        w[p + "gate_proj.weight"] = u(width, d, fan=d)
        w[p + "up_proj.weight"] = u(width, d, fan=d)
        w[p + "down_proj.weight"] = u(d, width, fan=width)
    return w


def tower_weights(dims: dict, g: torch.Generator) -> dict:
    """A HuggingFace Whisper encoder's weights (without a prefix), f32."""
    w, m = dims["n_audio_state"], dims["n_mels"]
    t = torch.arange(dims["n_audio_ctx"], dtype=torch.float64)[:, None]
    inv = torch.exp(-math.log(10000) / (w // 2 - 1) * torch.arange(w // 2, dtype=torch.float64))
    sd = {"conv1.weight": torch.randn(w, m, 3, generator=g) / math.sqrt(3 * m),
          "conv1.bias": torch.zeros(w),
          "conv2.weight": torch.randn(w, w, 3, generator=g) / math.sqrt(3 * w),
          "conv2.bias": torch.zeros(w),
          "embed_positions.weight": torch.cat([torch.sin(t * inv), torch.cos(t * inv)], 1).float(),
          "layer_norm.weight": torch.ones(w), "layer_norm.bias": torch.zeros(w)}
    for i in range(dims["n_audio_layer"]):
        p = f"layers.{i}."
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[p + ln + ".weight"] = torch.ones(w)
            sd[p + ln + ".bias"] = torch.zeros(w)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}self_attn.{name}.weight"] = (torch.rand(w, w, generator=g) * 2 - 1) / math.sqrt(w)
            if name != "k_proj":
                sd[f"{p}self_attn.{name}.bias"] = (torch.rand(w, generator=g) * 2 - 1) / math.sqrt(w)
        sd[p + "fc1.weight"] = (torch.rand(4 * w, w, generator=g) * 2 - 1) / math.sqrt(w)
        sd[p + "fc1.bias"] = torch.zeros(4 * w)
        sd[p + "fc2.weight"] = (torch.rand(w, 4 * w, generator=g) * 2 - 1) / math.sqrt(4 * w)
        sd[p + "fc2.bias"] = torch.zeros(w)
    return sd


def checkpoint(cfg: dict, seed: int = 0) -> tuple[dict, dict]:
    """(state dict in the HuggingFace layout, the reference's copy: {"layers":
    per-layer f32 weights, "tower": the tower's, and the projector's and
    embedding's under their full names}), from one draw."""
    g = torch.Generator().manual_seed(seed)
    d, w = cfg["hidden_size"], cfg["audio_tower"]["n_audio_state"]
    layers = [layer_weights(cfg, g) for _ in range(cfg["num_hidden_layers"])]
    tower = tower_weights(cfg["audio_tower"], g)
    sd = {"model.embed_tokens.weight": torch.randn(cfg["vocab_size"], d, generator=g) * 0.02,
          "model.audio_projector.weight": (torch.rand(d, w, generator=g) * 2 - 1) / math.sqrt(w),
          "model.audio_projector.bias": (torch.rand(d, generator=g) * 2 - 1) / math.sqrt(w)}
    other = {k: v.clone() for k, v in sd.items()}
    for i, lw in enumerate(layers):
        sd.update({f"model.layers.{i}.{k}": v.clone() for k, v in lw.items()})
    sd.update({f"model.audio_tower.{k}": v.clone() for k, v in tower.items()})
    return sd, {"layers": layers, "tower": tower, **other}
