"""Median ms of the program's ``train_chunk`` span less its ``chunk_replay``
child (its self time: the refresh applied, the index draw and the index
copy) over the window's chunks, the last N ``train_chunk`` records, N the
chunks the window timed."""

from portbench import spans


def read(r):
    chunks = spans.window(r, "train_chunk", "chunk_call_s")
    if chunks is None:
        return None
    replays = spans.children(chunks, "chunk_replay")
    if not any(replays):
        return None
    return spans.median_ms(c.dur_s - sum(k.dur_s for k in ks)
                           for c, ks in zip(chunks, replays))
