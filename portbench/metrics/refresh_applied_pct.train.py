"""Share of the window's chunks (the last N ``train_chunk`` records, N the
chunks the window timed) under which the device cache applied a refresh
(a ``cache_refresh_apply`` child): at most one a chunk, none when the
producer had none staged."""

from portbench import spans


def read(r):
    chunks = spans.window(r, "train_chunk", "chunk_call_s")
    if chunks is None or spans.records("cache_refresh_apply") is None:
        return None
    applied = spans.children(chunks, "cache_refresh_apply")
    return 100.0 * sum(1 for a in applied if a) / len(chunks)
