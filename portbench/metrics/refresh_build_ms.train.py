"""Median ms of the program's ``cache_refresh_build`` span (one refresh's
store read and padding resample, the host's own work on the device cache's
producer thread; the upload is ``cache_refresh_stage``) over the builds
that start in the window: at or after the start of the first of the last N
``train_chunk`` records, N the chunks the window timed."""

from portbench import spans


def read(r):
    chunks = spans.window(r, "train_chunk", "chunk_call_s")
    if chunks is None:
        return None
    start = chunks[0].start_ns
    return spans.median_ms(b.dur_s for b in spans.records("cache_refresh_build") or ()
                           if b.start_ns >= start)
