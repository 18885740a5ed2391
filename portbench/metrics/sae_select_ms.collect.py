"""Device ms a batch in the SAE encode's top-k selection, in the profiled
sub-window. In a program with the indexed selection (``ops/topk_indexed``,
``csrc/topk_indexed.cu``) that is its select launch and, for a row split
into column segments, its merge launch. In a program whose ``select_topk``
sorts the whole latent instead, it is that sort: cub's segmented radix
sort kernels and PyTorch's index fill for it (its copy of the latent, a
``Memcpy DtoD``, is left out: the collect path copies elsewhere too)."""

KERNELS = ("select_indexed", "topk_merge_kernel", "fill_reverse_indices_kernel")
SORT_PREFIXES = ("DeviceSegmentedRadixSort", "DeviceSegmentedSort", "DeviceRadixSort")


def read(r):
    return r.kernel_ms_per_unit(
        lambda k: k.base in KERNELS or k.base.startswith(SORT_PREFIXES))
