"""Median ms of the program's ``serve.locked`` span (the work under the device
lock: log-mel, encoder, SAE, sort and the answer's copy to the host) over
the window's requests: the child of each of the last N ``serve.request``
records, N the answered requests the client timed."""

from portbench import spans


def read(r):
    return spans.child_median_ms(spans.window(r, "serve.request", "latencies_s"),
                                 "serve.locked")
