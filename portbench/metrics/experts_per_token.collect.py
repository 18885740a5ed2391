"""Dynamic experts computed a token, over every LM layer and batch of the
window: the program's ``moe.tokens`` counter's dynamic rows over the
tokens (the null expert computes nothing; the top-p rule takes one or two
entries a token). A program without the counter reads nothing."""


def read(r):
    tables = r.w.get("window_tokens") or []
    if not tables:
        return None
    n_dyn = r.config["mlp_dynamic_expert_num"]
    tokens = r.w["batch"] * r.w["positions"]
    return sum(float(t[:, :n_dyn].sum()) for t in tables) / (
        len(tables) * tables[0].shape[0] * tokens)
