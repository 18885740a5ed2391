"""Median ms of the program's ``serve.read`` span (receiving the upload's
body from the socket) over the window's requests: the child of each of the
last N ``serve.request`` records, N the answered requests the client
timed."""

from portbench import spans


def read(r):
    return spans.child_median_ms(spans.window(r, "serve.request", "latencies_s"),
                                 "serve.read")
