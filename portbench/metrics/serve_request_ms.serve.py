"""Median ms of the program's ``serve.request`` span over the window's
requests (the last N, N the answered requests the client timed): the
server's own part of a request, from its request line to the last byte of
the answer written. The whole that its children's medians are read
against; what the client's ``request_p50_ms.serve`` holds beyond it is the
client's and the connection's."""

from portbench import spans


def read(r):
    calls = spans.window(r, "serve.request", "latencies_s")
    return None if calls is None else spans.median_ms(c.dur_s for c in calls)
