"""Frozen work counts of Uni-MoE-2.0-Omni's audio path: the yardstick of
the omni cell's roofline and utilization metrics.

``work.py``'s conventions: a (M, K) × (K, N) product counts 2·M·K·N
operations, only products count, a bound is the larger of the bytes over
the memory rate and the operations over the peak. The causal attention
counts the half of its square it computes. The routed experts count the
rows the router sent them (the program's ``moe.tokens`` counter), the
null expert's none.
"""

from __future__ import annotations

from portbench import work

H100 = work.H100


def moe_gemm_flops(rows: float, d: int, width: int) -> float:
    """The grouped gate/up and down products over ``rows`` routed rows."""
    return 2.0 * rows * d * width * 3


def moe_route_bytes(tokens: int, d: int, n_router: int, top_k: int, rows: float) -> float:
    """The route, plan, permute and combine launches of one layer, bytes
    read once and written once (``csrc/moe.cu``): the router reads u (T, d)
    bf16 and its f32 weights and writes probs, sel and wsel; the plan reads
    sel and writes the rows; the permute copies the routed rows; the
    combine reads h, the fixed experts' output and the routed rows and
    writes (T, d) bf16."""
    slots = 4.0 * tokens * top_k
    return (2.0 * tokens * d + 4.0 * n_router * d + 4.0 * tokens * n_router + 2 * slots
            + 2 * slots + 4.0 * n_router
            + 2 * 2.0 * rows * d + slots
            + 3 * 2.0 * tokens * d + 2.0 * rows * d + 2 * slots)


def lm_layer_flops(cfg: dict, positions: int, rows: float) -> float:
    """One LM layer over one clip's ``positions`` with ``rows`` routed rows:
    q/k/v and o, the causal attention's half square, the router, the fixed
    experts and the routed ones."""
    d, heads, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    t = positions
    proj = 2.0 * t * d * (heads * hd + 2 * kv * hd) + 2.0 * t * heads * hd * d
    attn = 2.0 * t * t * heads * hd
    router = 2.0 * t * d * (cfg["mlp_dynamic_expert_num"] + cfg["mlp_dynamic_null_expert_num"])
    fixed = 2.0 * t * d * cfg["mlp_fixed_expert_num"] * cfg["shared_intermediate_size"] * 3
    return proj + attn + router + fixed + moe_gemm_flops(rows, d, cfg["dynamic_intermediate_size"])


def clip_flops(cfg: dict, positions: int, rows_per_layer) -> float:
    """One clip through the log-mel, the tower, the projector, the LM layers
    (``rows_per_layer``: each layer's routed rows a clip) and the SAE
    encode of its audio tokens."""
    tw = cfg["audio_tower"]
    q, d, w = cfg["whisper_query_tokens_size"], cfg["hidden_size"], tw["n_audio_state"]
    tower = work.encoder_flops_to_tap(tw["n_mels"], w, tw["n_audio_ctx"], tw["n_audio_layer"])
    return (tower + 2.0 * q * w * d + sum(lm_layer_flops(cfg, positions, r)
                                          for r in rows_per_layer)
            + work.sae_encode_flops(q, d, d * cfg["sae"]["expansion_factor"]))
