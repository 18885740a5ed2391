"""Median ms from entry to return of ``SAETrainer.train_chunk`` in the
unprofiled part of the traced window (the benchmark's own span): the
refresh applied, the index draw and the graph's replay launched, and the
wait inside that launch for the card to take a K-step graph's work (about
half a chunk's device time), so it moves with the device as well as with
the host's own work."""


def read(r):
    return r.median_ms(r.w.get("chunk_call_s"))
