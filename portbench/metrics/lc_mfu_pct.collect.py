"""The whole batch's share of the H100's dense bf16 peak: the frozen count
of one clip through the log-mel, the tower, the projector, the double layers
to the tap (the held experts at the rows the program's ``longcat.routes``
counter gives, averaged over the window's batches) and the SAE encode,
times the files of the unprofiled part of the traced window over its
seconds. A program without the counter reads nothing."""

from portbench import work_longcat


def read(r):
    w = r.w
    tables = w.get("window_tokens") or []
    if not w.get("files") or not tables:
        return None
    cfg = r.config
    lo, hi = cfg["deployment"]["held_experts"]
    per_layer = sum(t[:, lo:hi].sum(1).astype(float) for t in tables) / (len(tables)
                                                                        * w["batch"])
    flops = work_longcat.clip_flops(cfg, w["positions"], per_layer.tolist())
    return 100.0 * flops * w["files"] / w["seconds"] / work_longcat.H100["bf16"]
