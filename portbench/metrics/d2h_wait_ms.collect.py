"""Median ms a batch of the program's ``d2h_fetch`` span (the loop's wait for
the batch's device-to-host copy, which waits for the device) over the
window."""


def read(r):
    return r.median_ms(r.w.get("spans", {}).get("d2h_fetch"))
