"""The whole batch's share of the H100's dense bf16 peak: the frozen count
of one clip through the log-mel, the tower, the projector, the LM layers
to the tap (the routed experts at the rows the program's ``moe.tokens``
counter gives, averaged over the window's batches) and the SAE encode,
times the files of the unprofiled part of the traced window over its
seconds. A program without the counter reads nothing."""

from portbench import work_omni


def read(r):
    w = r.w
    tables = w.get("window_tokens") or []
    if not w.get("files") or not tables:
        return None
    cfg = r.config
    n_dyn = cfg["mlp_dynamic_expert_num"]
    per_layer = sum(t[:, :n_dyn].sum(1).astype(float) for t in tables) / (len(tables) * w["batch"])
    flops = work_omni.clip_flops(cfg, w["positions"], per_layer.tolist())
    return 100.0 * flops * w["files"] / w["seconds"] / work_omni.H100["bf16"]
