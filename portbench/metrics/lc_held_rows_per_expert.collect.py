"""Rows a held expert computes a batch: the program's ``longcat.routes``
counter's slots on this card's experts, averaged over the held experts, the
double layers and the window's batches (in the 32-card deployment each
expert would see about 32 times as many). A program without the counter
reads nothing."""


def read(r):
    tables = r.w.get("window_tokens") or []
    if not tables:
        return None
    lo, hi = r.config["deployment"]["held_experts"]
    return sum(float(t[:, lo:hi].mean()) for t in tables) / len(tables)
