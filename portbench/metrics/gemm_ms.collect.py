"""Device ms a batch in cuBLAS's and cuDNN's kernels (the encoder's
projections, MLP and convolutions, and the SAE encode's product), in the
profiled sub-window; kernels are matched by these parts of their names."""

PARTS = ("gemm", "nvjet", "cutlass", "cudnn", "conv", "implicit_convolve", "winograd",
         "ampere_", "sm80_", "sm90_")


def read(r):
    return r.kernel_ms_per_unit(lambda k: any(p in k.name for p in PARTS))
