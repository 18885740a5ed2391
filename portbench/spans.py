"""The program's own spans (``freud_tpu_torch.profiling.records``), as the
per-layer readers read them after a run.

A span keeps its newest calls, so the window's calls are the last N
records of their name, N the calls the window counted itself (answered
requests, chunks); a call's children are the records whose ``parent`` is
its id. Against a program whose spans keep no records every function here
gives None, and the reader leaves its metric out.
"""

from __future__ import annotations

import statistics
from typing import Optional


def records(name: str) -> Optional[list]:
    """Every kept record of span ``name``, oldest first; None when the
    program keeps none."""
    from freud_tpu_torch import profiling

    get = getattr(profiling, "records", None)
    return None if get is None else get(name)


def window(r, name: str, key: str) -> Optional[list]:
    """The window's calls of span ``name``: its last N records, N the length
    of the window's own list ``r.w[key]``; None when fewer were kept."""
    n = len(r.w.get(key) or ())
    recs = records(name)
    if not n or recs is None or len(recs) < n:
        return None
    return recs[-n:]


def children(parents: list, name: str) -> list:
    """For each of ``parents``, its child records of span ``name``."""
    by_id = {p.id: [] for p in parents}
    for c in records(name) or ():
        if c.parent in by_id:
            by_id[c.parent].append(c)
    return [by_id[p.id] for p in parents]


def median_ms(seconds) -> Optional[float]:
    seconds = list(seconds)
    return 1e3 * statistics.median(seconds) if seconds else None


def child_median_ms(parents: Optional[list], name: str) -> Optional[float]:
    """Median ms over ``parents`` of each one's time in its children
    ``name``; None when no parent has one."""
    if not parents:
        return None
    kids = children(parents, name)
    if not any(kids):
        return None
    return median_ms(sum(c.dur_s for c in k) for k in kids)
