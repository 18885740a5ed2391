"""Device ms a step in PyTorch's own elementwise and reduction kernels (the
TopK backward's passes, the optimizer's and the losses'), in the profiled
sub-window."""

KERNELS = (
    "elementwise_kernel",
    "vectorized_elementwise_kernel",
    "unrolled_elementwise_kernel",
    "reduce_kernel",
    "multi_tensor_apply_kernel",
)


def read(r):
    return r.kernel_ms_per_unit(lambda k: k.base in KERNELS)
