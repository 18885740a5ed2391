"""Median ms of the program's ``chunk_replay`` span (the K-step graph's
launch, which returns once the card has taken much of its work) under each
of the window's chunks, the last N ``train_chunk`` records, N the chunks
the window timed."""

from portbench import spans


def read(r):
    return spans.child_median_ms(spans.window(r, "train_chunk", "chunk_call_s"),
                                 "chunk_replay")
