"""The whole step's share of the H100's dense bf16 peak: the frozen
``sae_topk_step_flops`` (8 products with AuxK live, 6 without) times the
steps of the unprofiled part of the traced window over its seconds."""

from portbench import work


def read(r):
    w = r.w
    if not w.get("steps"):
        return None
    flops = work.sae_topk_step_flops(w["rows"], w["d_in"], w["n_dict"], w["auxk_live"])
    return work.peak_share_pct(flops * w["steps"], w["seconds"])
