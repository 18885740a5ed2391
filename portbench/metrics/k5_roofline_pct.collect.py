"""Kernel #5's share of its bound: the frozen ``whisper_attention_bound_s``
at the batch, heads and 1500 frames, times the blocks a batch runs, over
#5's device time a batch (``whisper_attention``: its bf16 pre-pass and its
attention launch in ``csrc/attention.cu``), in the profiled sub-window."""

from portbench import work

KERNELS = ("to_bf16_kernel", "attention_kernel")


def read(r):
    ms = r.kernel_ms_per_unit(lambda k: k.base in KERNELS)
    if ms is None:
        return None
    wh = r.config["whisper"]
    heads = wh["n_audio_head"]
    one = work.whisper_attention_bound_s(r.w["batch"], heads, wh["n_audio_ctx"],
                                         wh["n_audio_state"] // heads)
    return 100.0 * one * work.tapped_blocks(r.config["layer_name"]) / (ms / 1e3)
