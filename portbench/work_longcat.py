"""Frozen work counts of LongCat-Flash-Omni's audio path on one card of its
expert-parallel deployment: the yardstick of the longcat cell's roofline and
utilization metrics.

``work.py``'s conventions: a (M, K) × (K, N) product counts 2·M·K·N
operations, only products count, a bound is the larger of the bytes over
the memory rate and the operations over the peak. The causal attention
counts the half of its square it computes. The held experts count the rows
the router sent them (the program's ``longcat.routes`` counter); identity
entries and experts other cards hold count nothing.
"""

from __future__ import annotations

from portbench import work

H100 = work.H100


def route_topk_bytes(tokens: int, n_router: int, top_k: int) -> float:
    """The route kernel of one layer (``csrc/moe.cu`` ``route_topk_kernel``),
    bytes read once and written once: the f32 logits and bias read, the f32
    probabilities written, and each slot's int32 entry, f32 weight and int8
    class."""
    return 4.0 * tokens * n_router + 4.0 * n_router + 4.0 * tokens * n_router + 9.0 * tokens * top_k


def held_gemm_bound_s(rows: float, active: int, d: int, width: int) -> float:
    """The grouped gate/up and down products over ``rows`` held rows, whose
    ``active`` experts took at least one: each launch's max(operations over
    the bf16 peak, its bytes over the memory rate), summed; bytes are the
    active experts' bf16 weights and the rows read and written."""
    gateup = max(4.0 * rows * d * width / H100["bf16"],
                 2.0 * (rows * d + 2 * active * width * d + rows * width) / H100["bytes"])
    down = max(2.0 * rows * d * width / H100["bf16"],
               2.0 * (rows * width + active * d * width + rows * d) / H100["bytes"])
    return gateup + down


def mla_flops(cfg: dict, t: int) -> float:
    """One MLA over one clip's ``t`` positions: its five products and the
    causal attention's half square (qk and v widths)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    ql, kl, rd = cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    qk, vd = cfg["qk_nope_head_dim"] + rd, cfg["v_head_dim"]
    proj = 2.0 * t * (d * (ql + kl + rd) + ql * h * qk + kl * h * (qk - rd + vd) + h * vd * d)
    return proj + 1.0 * t * t * h * (qk + vd)


def layer_flops(cfg: dict, t: int, rows: float) -> float:
    """One double layer over one clip's ``t`` positions with ``rows`` held
    rows: two MLAs, two dense SwiGLU FFNs, the router and the held experts."""
    d = cfg["hidden_size"]
    n_router = cfg["deployment"]["n_routed_experts"] + cfg["zero_expert_num"]
    dense = 2 * 2.0 * t * d * cfg["ffn_hidden_size"] * 3
    return (2 * mla_flops(cfg, t) + dense + 2.0 * t * d * n_router
            + 2.0 * rows * d * cfg["expert_ffn_hidden_size"] * 3)


def clip_flops(cfg: dict, positions: int, rows_per_layer) -> float:
    """One clip through the log-mel, the tower, the projector, the double
    layers (``rows_per_layer``: each layer's held rows a clip) and the SAE
    encode of its audio tokens."""
    tw = cfg["audio_tower"]
    q, d, w = cfg["audio_tokens"], cfg["hidden_size"], tw["n_audio_state"]
    tower = work.encoder_flops_to_tap(tw["n_mels"], w, tw["n_audio_ctx"], tw["n_audio_layer"])
    return (tower + 2.0 * q * w * d + sum(layer_flops(cfg, positions, r)
                                          for r in rows_per_layer)
            + work.sae_encode_flops(q, d, d * cfg["sae"]["expansion_factor"]))
