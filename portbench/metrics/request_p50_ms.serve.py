"""Median ms of the window's requests, timed at the client (the steady
middle beside the tail that ``request_p95_ms`` reads)."""


def read(r):
    return r.median_ms(r.w.get("latencies_s"))
