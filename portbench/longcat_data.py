"""LongCat-Flash-Omni's weights drawn from ``--seed``, in the HuggingFace
layout the program's loader takes (``freud_tpu_torch/models/longcat/
load.py``), holding the configuration's share of the routed experts.

Each tensor is drawn on the run's device by a ``torch.Generator`` of its
own, seeded from the run's seed and the tensor's name (``omni_data.draw``'s
rule), so the reference can draw one layer again, in float32, without
drawing the rest. Linears are uniform ±1/√fan_in (the projector's bias
too), norms unit, the embedding N(0, 0.02²), the tower as ``omni_data``
draws a Whisper encoder. Every tensor is stored in bfloat16 but the router
and its selection bias (f32); the reference reads the stored values widened
to f32.

The router (``calibrated_routers``), layer by layer on calibration clips
(the reference's float32 forward, each layer under its calibrated router):
its rows drawn N(0, (router_scale/√d)²) over all routed and identity
entries, made orthogonal to the layer's mean MoE input (random weights give
the residual stream a direction common to every token, which a random
router would read as a preference for a few entries), then the selection
bias b set so that the top-k of p + b loads every entry evenly: the routed
experts with ``ffn_experts_per_token`` slots a token between them, the
identity entries with the rest. That is the balance the trained bias
(``e_score_correction_bias``) keeps, and it fixes the rows each held expert
computes from draw to draw.
"""

from __future__ import annotations

import math

import torch

from portbench import omni_data
from portbench.reference import longcat as ref_longcat

LM = "model.layers.{}."
TOWER = omni_data.TOWER
ROUTER = "mlp.router.classifier.weight"
BIAS = "mlp.router.e_score_correction_bias"


def layer_specs(cfg: dict) -> dict:
    """name (without ``model.layers.N.``) → (shape, kind, scale), the held
    experts only."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    ql, kl, ffn = cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["ffn_hidden_size"]
    n_routed, (lo, hi) = ref_longcat.share(cfg)
    s = {}
    for half in range(2):
        for norm in ("input_layernorm", "post_attention_layernorm"):
            s[f"{norm}.{half}.weight"] = ((d,), "ones", 0.0)
        p = f"self_attn.{half}."
        s[p + "q_a_proj.weight"] = ((ql, d), "uniform", 1 / math.sqrt(d))
        s[p + "q_a_layernorm.weight"] = ((ql,), "ones", 0.0)
        s[p + "q_b_proj.weight"] = ((heads * (nope + rd), ql), "uniform", 1 / math.sqrt(ql))
        s[p + "kv_a_proj_with_mqa.weight"] = ((kl + rd, d), "uniform", 1 / math.sqrt(d))
        s[p + "kv_a_layernorm.weight"] = ((kl,), "ones", 0.0)
        s[p + "kv_b_proj.weight"] = ((heads * (nope + vd), kl), "uniform", 1 / math.sqrt(kl))
        s[p + "o_proj.weight"] = ((d, heads * vd), "uniform", 1 / math.sqrt(heads * vd))
        p = f"mlps.{half}."
        s[p + "gate_proj.weight"] = ((ffn, d), "uniform", 1 / math.sqrt(d))
        s[p + "up_proj.weight"] = ((ffn, d), "uniform", 1 / math.sqrt(d))
        s[p + "down_proj.weight"] = ((d, ffn), "uniform", 1 / math.sqrt(ffn))
    n_router = n_routed + cfg["zero_expert_num"]
    s[ROUTER] = ((n_router, d), "router", cfg["init"]["router_scale"] / math.sqrt(d))
    s[BIAS] = ((n_router,), "router_zeros", 0.0)
    width = cfg["expert_ffn_hidden_size"]
    for e in range(lo, hi):
        p = f"mlp.experts.{e}."
        s[p + "gate_proj.weight"] = ((width, d), "uniform", 1 / math.sqrt(d))
        s[p + "up_proj.weight"] = ((width, d), "uniform", 1 / math.sqrt(d))
        s[p + "down_proj.weight"] = ((d, width), "uniform", 1 / math.sqrt(width))
    return s


def other_specs(cfg: dict) -> dict:
    d, w = cfg["hidden_size"], cfg["audio_tower"]["n_audio_state"]
    return {"model.embed_tokens.weight": ((cfg["vocab_size"], d), "normal", 0.02),
            "model.audio_projector.weight": ((d, w), "uniform", 1 / math.sqrt(w)),
            "model.audio_projector.bias": ((d,), "uniform", 1 / math.sqrt(w))}


def draw(seed_for, name: str, spec: tuple, dev, f32: bool = False) -> torch.Tensor:
    """One tensor as stored (bf16; the router and its bias f32), or
    widened to f32."""
    if spec[1] == "router_zeros":
        return torch.zeros(spec[0], device=dev)
    return omni_data.draw(seed_for, name, spec, dev, f32)


def layer_f32(seed_for, cfg: dict, i: int, dev, routers=None) -> dict:
    """Double layer ``i``'s weights widened to f32, without the prefix; with
    ``routers`` (``calibrated_routers``), its calibrated router and bias."""
    w = {name: draw(seed_for, LM.format(i) + name, spec, dev, f32=True)
         for name, spec in layer_specs(cfg).items()}
    if routers is not None:
        w[ROUTER], w[BIAS] = (t.to(dev) for t in routers[i])
    return w


def state_dict(seed_for, cfg: dict, dev, routers) -> dict:
    """The checkpoint of the configuration's layers and share, as stored,
    with the calibrated ``routers``."""
    sd = {}
    for name, spec in other_specs(cfg).items():
        sd[name] = draw(seed_for, name, spec, dev)
    for name, spec in omni_data.tower_specs(cfg["audio_tower"]).items():
        sd[TOWER + name] = draw(seed_for, TOWER + name, spec, dev)
    specs = layer_specs(cfg)
    for i in range(cfg["num_layers"]):
        for name, spec in specs.items():
            sd[LM.format(i) + name] = draw(seed_for, LM.format(i) + name, spec, dev)
        sd[LM.format(i) + ROUTER], sd[LM.format(i) + BIAS] = (t.to(dev) for t in routers[i])
    return sd


def _mla_input(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The layer's MoE input u (T·b, d) on (b, T, d) inputs, without the MoE."""
    eps = cfg["rms_norm_eps"]
    cos, sin = ref_longcat.rope(x.shape[1], cfg["qk_rope_head_dim"], float(cfg["rope_theta"]),
                                x.device)
    h1 = x + ref_longcat.mla(w, cfg, 0, ref_longcat.rms_norm(x, w["input_layernorm.0.weight"],
                                                             eps), cos, sin)
    u = ref_longcat.rms_norm(h1, w["post_attention_layernorm.0.weight"], eps)
    return u.reshape(-1, x.shape[-1])


def balance_bias(p: torch.Tensor, cfg: dict, steps: int = 600) -> torch.Tensor:
    """The selection bias b (n_router,) under which the top-k of p + b
    (``reference.longcat.route``) loads each routed expert with
    ``ffn_experts_per_token``/n_routed of a token's slots and each identity
    entry with the rest evenly: sign steps toward each entry's target load,
    shrinking geometrically from a twentieth of the mean largest p."""
    n_routed, _ = ref_longcat.share(cfg)
    n, n_router = p.shape
    k, f = cfg["moe_topk"], cfg["init"]["ffn_experts_per_token"]
    target = torch.full((n_router,), n * (k - f) / (n_router - n_routed), device=p.device)
    target[:n_routed] = n * f / n_routed
    b = torch.zeros(n_router, device=p.device)
    step = 0.05 * float(p.max(1).values.mean())
    for _ in range(steps):
        sel, _ = ref_longcat.route(p + b, k)
        load = torch.bincount(sel.reshape(-1), minlength=n_router).float()
        b += step * torch.sign(target - load)
        step *= 0.985
    return b


def ffn_experts_per_token(p: torch.Tensor, b: torch.Tensor, cfg: dict) -> float:
    n_routed, _ = ref_longcat.share(cfg)
    sel, _ = ref_longcat.route(p + b, cfg["moe_topk"])
    return float((sel < n_routed).sum()) / len(p)


def calibrated_routers(seed_for, cfg: dict, x: torch.Tensor) -> list:
    """Each layer's (router, bias) (module docstring) from the reference's
    LM input ``x`` (files, T, d) of calibration clips; → CPU f32 tensors."""
    routers = []
    for i in range(cfg["num_layers"]):
        w = layer_f32(seed_for, cfg, i, x.device)
        u = _mla_input(w, cfg, x)
        m = u.mean(0) / u.mean(0).norm()
        r = w[ROUTER] - torch.outer(w[ROUTER] @ m, m)
        w[ROUTER] = r
        w[BIAS] = balance_bias(torch.softmax(u @ r.T, dim=-1), cfg)
        routers.append((w[ROUTER].cpu(), w[BIAS].cpu()))
        x = ref_longcat.layer(w, cfg, x)["out"]
        del w, u
    return routers
