"""Device ms a step in the TopK backward's passes over the (M, n_dict)
latent (``csrc/topk_backward.cu``: the masked pair, the route and the
``encoder_bias`` column sum), in the profiled sub-window. A program without
them reads nothing."""

KERNELS = ("topk_bwd_pair_kernel", "topk_bwd_route_kernel", "topk_bwd_colsum_kernel")


def read(r):
    return r.kernel_ms_per_unit(lambda k: k.base in KERNELS)
