"""Seconds of the program's ``chunk_capture`` span over the run: every CUDA
graph capture of a train chunk (its warm-up step included), all in
set-up."""

from portbench import spans


def read(r):
    caps = spans.records("chunk_capture")
    return sum(c.dur_s for c in caps) if caps else None
