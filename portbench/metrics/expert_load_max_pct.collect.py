"""The busiest dynamic expert's share of a layer's routed rows, summed over
the window's batches (the program's ``moe.tokens`` counter), averaged over
the LM layers: 25 is an even load over four experts, 100 every row of a
layer on one. A program without the counter reads nothing."""


def read(r):
    tables = r.w.get("window_tokens") or []
    if not tables:
        return None
    n_dyn = r.config["mlp_dynamic_expert_num"]
    total = sum(t[:, :n_dyn].astype(float) for t in tables)
    share = total.max(1) / total.sum(1).clip(min=1)
    return 100.0 * float(share.mean())
