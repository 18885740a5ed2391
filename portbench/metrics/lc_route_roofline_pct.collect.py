"""The top-k route kernel's share of its bytes bound: the frozen
``route_topk_bytes`` of every layer of the profiled batches at 3.35 TB/s
over ``route_topk_kernel``'s device time (``csrc/moe.cu``) in the profiled
sub-window. A program without the kernel reads nothing."""

from portbench import work_longcat

KERNELS = ("route_topk_kernel",)


def read(r):
    p = r.profile
    if p is None or not p.units:
        return None
    s = sum(k.dur_s for k in p.kernels if k.base in KERNELS)
    if s <= 0:
        return None
    cfg = r.config
    n_router = cfg["deployment"]["n_routed_experts"] + cfg["zero_expert_num"]
    tokens = r.w["batch"] * r.w["positions"]
    nbytes = p.units * cfg["num_layers"] * work_longcat.route_topk_bytes(
        tokens, n_router, cfg["moe_topk"])
    return 100.0 * nbytes / work_longcat.H100["bytes"] / s
