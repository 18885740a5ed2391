"""The MoE's route, plan, permute and combine launches' share of their
bytes bound: the frozen ``moe_route_bytes`` of every layer of the profiled
batches (routed rows from the program's ``moe.tokens`` counter) at 3.35
TB/s over those kernels' device time (``csrc/moe.cu``) in the profiled
sub-window. A program without the counter reads nothing."""

from portbench import work_omni

KERNELS = ("route_kernel", "plan_kernel", "permute_kernel", "combine_kernel")


def read(r):
    tables = r.w.get("profiled_tokens") or []
    p = r.profile
    if not tables or p is None:
        return None
    s = sum(k.dur_s for k in p.kernels if k.base in KERNELS)
    if s <= 0:
        return None
    cfg = r.config
    n_dyn = cfg["mlp_dynamic_expert_num"]
    n_router = n_dyn + cfg["mlp_dynamic_null_expert_num"]
    tokens = r.w["batch"] * r.w["positions"]
    nbytes = sum(work_omni.moe_route_bytes(tokens, cfg["hidden_size"], n_router,
                                           cfg["mlp_dynamic_top_k"], float(row[:n_dyn].sum()))
                 for t in tables for row in t)
    return 100.0 * nbytes / work_omni.H100["bytes"] / s
