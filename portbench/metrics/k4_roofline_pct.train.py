"""Kernel #4's share of its bound: the frozen ``topk_sae_forward_bound_s`` at
the cell's rows, d_in, n_dict, k and k_aux over the device time a step of
#4's launches (``csrc/topk_fused.cu`` and its select launch from
``csrc/topk_select.cuh``), in the profiled sub-window."""

from portbench import work

KERNELS = ("center_kernel", "encode_kernel", "select_rows", "dead_bits_kernel", "decode_kernel")


def read(r):
    ms = r.kernel_ms_per_unit(lambda k: k.base in KERNELS)
    if ms is None:
        return None
    w = r.w
    bound = work.topk_sae_forward_bound_s(w["rows"], w["d_in"], w["n_dict"], w["k"], w["k_aux"])
    return 100.0 * bound / (ms / 1e3)
