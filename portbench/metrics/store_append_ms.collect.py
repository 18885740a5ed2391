"""Median ms a batch of the program's ``store_append`` span over the window."""


def read(r):
    return r.median_ms(r.w.get("spans", {}).get("store_append"))
