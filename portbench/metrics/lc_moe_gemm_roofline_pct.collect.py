"""The grouped expert products' share of their bound over the held
experts: the frozen ``held_gemm_bound_s`` of every layer of the profiled
batches, at the held rows the program's ``longcat.routes`` counter gives
(operations at 989 TFLOP/s or the active experts' weights and the rows at
3.35 TB/s, whichever is longer), over the device time of ``grouped_kernel``
(``csrc/moe.cu``: gate/up and down) in the profiled sub-window. A program
without the counter reads nothing."""

from portbench import work_longcat

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
    lo, hi = cfg["deployment"]["held_experts"]
    bound = 0.0
    for t in tables:
        for row in t:
            held = row[lo:hi]
            bound += work_longcat.held_gemm_bound_s(float(held.sum()), int((held > 0).sum()),
                                                    cfg["hidden_size"],
                                                    cfg["expert_ffn_hidden_size"])
    return 100.0 * bound / s
