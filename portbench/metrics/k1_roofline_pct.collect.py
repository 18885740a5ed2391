"""Kernel #1's share of its bound: the frozen ``log_mel_bound_s`` at the
batch and the configuration's mel bands over #1's device time a batch
(``csrc/mel.cu``), in the profiled sub-window."""

from portbench import work

KERNELS = ("log10_mel_kernel", "floor_affine_kernel")


def read(r):
    ms = r.kernel_ms_per_unit(lambda k: k.base in KERNELS)
    if ms is None:
        return None
    bound = work.log_mel_bound_s(r.w["batch"], r.config["whisper"]["n_mels"])
    return 100.0 * bound / (ms / 1e3)
