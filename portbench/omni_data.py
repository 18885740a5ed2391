"""Uni-MoE-2.0-Omni's weights drawn from ``--seed``, in the HuggingFace
layout the program's checkpoint reader hands to its loader
(``freud_tpu_torch/models/omni/load.py``).

Each tensor is drawn on the run's device by a ``torch.Generator`` of its
own, seeded from the run's seed and the tensor's name, so the reference can
draw one layer again, in float32, without drawing the rest. Linears are
uniform ±1/√fan_in (biases too), the tower's convolutions N(0, 1/fan_in),
norms unit, the embedding N(0, 0.02²) (Qwen2's ``initializer_range``).
Every tensor is stored in bfloat16 but the router (f32, ``fp32_gate``); the
reference reads the stored values widened to f32.

The router (``centered_routers``): rows drawn N(0, (router_scale/√d)²),
then, layer by layer, each row made orthogonal to the layer's mean MoE
input over calibration clips (the reference's float32 forward, each layer
under its centred router): the load balancing a trained router has
(``l_aux_weight``). Random weights give every layer's residual stream a
large direction common to all tokens, and a random router reads it and
sends most of a layer's tokens to one expert, how many depending on the
draw, so the routed work would move with the seed. Each centred router is
then scaled to compute the configuration's ``experts_per_token`` (``init``)
on the calibration clips; ``router_scale`` only sets the draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import data

LM = "model.layers.{}."
TOWER = "model.audio_tower."


def hf_config(cfg: dict, prompt_ids: dict) -> dict:
    """The configuration file as the program's HuggingFace config, with the
    run's audio prompt."""
    out = dict(cfg)
    out["audio_prompt"] = prompt_ids
    return out


def layer_specs(cfg: dict) -> dict:
    """name (without ``model.layers.N.``) → (shape, kind, scale)."""
    d, heads, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    i, fw = cfg["dynamic_intermediate_size"], cfg["shared_intermediate_size"]
    n_router = cfg["mlp_dynamic_expert_num"] + cfg["mlp_dynamic_null_expert_num"]
    s = {"input_layernorm.weight": ((d,), "ones", 0.0),
         "post_attention_layernorm.weight": ((d,), "ones", 0.0)}
    for name, rows in (("q_proj", heads * hd), ("k_proj", kv * hd), ("v_proj", kv * hd)):
        s[f"self_attn.{name}.weight"] = ((rows, d), "uniform", 1 / math.sqrt(d))
        s[f"self_attn.{name}.bias"] = ((rows,), "uniform", 1 / math.sqrt(d))
    s["self_attn.o_proj.weight"] = ((d, heads * hd), "uniform", 1 / math.sqrt(heads * hd))
    s["mlp.gate.weight"] = ((n_router, d), "router", cfg["init"]["router_scale"] / math.sqrt(d))
    experts = [(f"mlp.experts.{e}.", i) for e in range(cfg["mlp_dynamic_expert_num"])]
    experts += [(f"mlp.fixed_experts.{f}.", fw) for f in range(cfg["mlp_fixed_expert_num"])]
    for p, width in experts:
        s[p + "gate_proj.weight"] = ((width, d), "uniform", 1 / math.sqrt(d))
        s[p + "up_proj.weight"] = ((width, d), "uniform", 1 / math.sqrt(d))
        s[p + "down_proj.weight"] = ((d, width), "uniform", 1 / math.sqrt(width))
    return s


def tower_specs(dims: dict) -> dict:
    """name (without ``model.audio_tower.``) → (shape, kind, scale): a
    HuggingFace Whisper encoder."""
    w, m = dims["n_audio_state"], dims["n_mels"]
    s = {"conv1.weight": ((w, m, 3), "normal", 1 / math.sqrt(3 * m)),
         "conv1.bias": ((w,), "zeros", 0.0),
         "conv2.weight": ((w, w, 3), "normal", 1 / math.sqrt(3 * w)),
         "conv2.bias": ((w,), "zeros", 0.0),
         "embed_positions.weight": ((dims["n_audio_ctx"], w), "sinusoids", 0.0),
         "layer_norm.weight": ((w,), "ones", 0.0), "layer_norm.bias": ((w,), "zeros", 0.0)}
    for i in range(dims["n_audio_layer"]):
        p = f"layers.{i}."
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            s[p + ln + ".weight"] = ((w,), "ones", 0.0)
            s[p + ln + ".bias"] = ((w,), "zeros", 0.0)
        for name, bias in (("q_proj", True), ("k_proj", False), ("v_proj", True),
                           ("out_proj", True)):
            s[f"{p}self_attn.{name}.weight"] = ((w, w), "uniform", 1 / math.sqrt(w))
            if bias:
                s[f"{p}self_attn.{name}.bias"] = ((w,), "uniform", 1 / math.sqrt(w))
        s[p + "fc1.weight"] = ((4 * w, w), "uniform", 1 / math.sqrt(w))
        s[p + "fc1.bias"] = ((4 * w,), "uniform", 1 / math.sqrt(w))
        s[p + "fc2.weight"] = ((w, 4 * w), "uniform", 1 / math.sqrt(4 * w))
        s[p + "fc2.bias"] = ((w,), "uniform", 1 / math.sqrt(4 * w))
    return s


def other_specs(cfg: dict) -> dict:
    d, w = cfg["hidden_size"], cfg["audio_tower"]["n_audio_state"]
    return {"model.embed_tokens.weight": ((cfg["vocab_size"], d), "normal", 0.02),
            "model.audio_projector.weight": ((d, w), "uniform", 1 / math.sqrt(w)),
            "model.audio_projector.bias": ((d,), "uniform", 1 / math.sqrt(w))}


def draw(seed_for, name: str, spec: tuple, dev, f32: bool = False) -> torch.Tensor:
    """One tensor as stored (bf16; the router f32), or widened to f32."""
    shape, kind, scale = spec
    if kind == "ones":
        t = torch.ones(shape, device=dev)
    elif kind == "zeros":
        t = torch.zeros(shape, device=dev)
    elif kind == "sinusoids":
        t = torch.from_numpy(data.sinusoids(*shape)).to(dev)
    else:
        g = data.generator(dev, seed_for("omni", name))
        if kind == "uniform":
            t = (torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale
        else:  # normal, router
            t = torch.randn(shape, generator=g, device=dev) * scale
    if kind != "router":
        t = t.to(torch.bfloat16)
    return t.float() if f32 else t


def state_dict(seed_for, cfg: dict, dev, routers) -> dict:
    """The whole checkpoint of the configuration's layers, as stored, with
    the centred ``routers``."""
    sd = {}
    for name, spec in other_specs(cfg).items():
        sd[name] = draw(seed_for, name, spec, dev)
    for name, spec in tower_specs(cfg["audio_tower"]).items():
        sd[TOWER + name] = draw(seed_for, TOWER + name, spec, dev)
    specs = layer_specs(cfg)
    for i in range(cfg["num_hidden_layers"]):
        for name, spec in specs.items():
            if spec[1] == "router":
                sd[LM.format(i) + name] = routers[i].to(dev)
            else:
                sd[LM.format(i) + name] = draw(seed_for, LM.format(i) + name, spec, dev)
    return sd


def layer_f32(seed_for, cfg: dict, i: int, dev, routers=None) -> dict:
    """LM layer ``i``'s weights widened to f32, without the prefix; with
    ``routers`` (``centered_routers``), its centred router."""
    w = {name: draw(seed_for, LM.format(i) + name, spec, dev, f32=True)
         for name, spec in layer_specs(cfg).items()}
    if routers is not None:
        w["mlp.gate.weight"] = routers[i].to(dev)
    return w


def experts_per_token(u: torch.Tensor, router: torch.Tensor, cfg: dict) -> float:
    """Dynamic experts the top-p rule computes a token of ``u`` (N, d)."""
    from portbench.reference import omni as ref_omni

    sel = ref_omni.route(torch.softmax(u @ router.T, dim=-1), cfg["mlp_dynamic_top_p"],
                         cfg["mlp_dynamic_top_k"])[0]
    return float(((sel >= 0) & (sel < cfg["mlp_dynamic_expert_num"])).sum()) / len(u)


def centered_routers(seed_for, cfg: dict, x: torch.Tensor) -> list:
    """Each layer's router (module docstring): its rows made orthogonal to
    the layer's mean MoE input over the reference's LM input ``x`` (files,
    T, d) of calibration clips, then scaled so that the top-p rule computes
    the configuration's ``experts_per_token`` on those clips (bisection on
    the scale: the work a layer does stays the same from draw to draw);
    → CPU f32 tensors."""
    from portbench.reference import omni as ref_omni

    target = cfg["init"]["experts_per_token"]
    routers = []
    for i in range(cfg["num_hidden_layers"]):
        w = layer_f32(seed_for, cfg, i, x.device)
        u = ref_omni.layer(w, cfg, x)["u"]
        m = u.mean(0) / u.mean(0).norm()
        r = w["mlp.gate.weight"] - torch.outer(w["mlp.gate.weight"] @ m, m)
        lo, hi = 0.0, 2.0 ** 6  # sharper routers compute fewer experts a token
        for _ in range(40):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if experts_per_token(u, mid * r, cfg) > target else (lo, mid)
        w["mlp.gate.weight"] = hi * r
        routers.append(w["mlp.gate.weight"].cpu())
        x = ref_omni.layer(w, cfg, x)["out"]
        del w, u
    return routers


def tower_f32(seed_for, cfg: dict, dev) -> dict:
    return {name: draw(seed_for, TOWER + name, spec, dev, f32=True)
            for name, spec in tower_specs(cfg["audio_tower"]).items()}


def other_f32(seed_for, cfg: dict, dev, names) -> dict:
    specs = other_specs(cfg)
    return {n: draw(seed_for, n, specs[n], dev, f32=True) for n in names}


def prompt_ids(seed: int, vocab: int, before: int, after: int) -> dict:
    """The audio prompt's token ids, drawn from the seed: ``before`` ids
    ahead of the audio tokens, ``after`` behind them."""
    ids = np.random.default_rng(seed).integers(0, vocab, before + after).tolist()
    return {"prefix_ids": ids[:before], "suffix_ids": ids[before:]}
