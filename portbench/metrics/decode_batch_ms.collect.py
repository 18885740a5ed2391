"""Median ms a batch of the program's ``decode_batch`` span over the window."""


def read(r):
    return r.median_ms(r.w.get("spans", {}).get("decode_batch"))
