"""FFN experts a token, over every double layer and batch of the window:
the program's ``longcat.routes`` counter's slots on the 512 routed experts
(held here or on another card) over the tokens; the rest of the 12 slots
went to identity entries. A program without the counter reads nothing."""


def read(r):
    tables = r.w.get("window_tokens") or []
    if not tables:
        return None
    n_routed = r.config["deployment"]["n_routed_experts"]
    tokens = r.w["batch"] * r.w["positions"]
    return sum(float(t[:, :n_routed].sum()) for t in tables) / (
        len(tables) * tables[0].shape[0] * tokens)
