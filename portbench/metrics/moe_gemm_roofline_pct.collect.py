"""The grouped expert products' share of the H100's dense bf16 peak: the
frozen ``moe_gemm_flops`` at the rows the router sent each dynamic expert
(the program's ``moe.tokens`` counter of the profiled batches) over the
device time of ``grouped_kernel`` (``csrc/moe.cu``: gate/up and down) in
the profiled sub-window. A program without the counter reads nothing."""

from portbench import work_omni

KERNELS = ("grouped_kernel",)


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
    rows = sum(float(t[:, :n_dyn].sum()) for t in tables)
    flops = work_omni.moe_gemm_flops(rows, cfg["hidden_size"], cfg["dynamic_intermediate_size"])
    return 100.0 * flops / work_omni.H100["bf16"] / s
