"""Share of the profiled sub-window in which no kernel, copy or set runs on
the card: one less the union of the device intervals over its length."""


def read(r):
    return r.idle_pct()
