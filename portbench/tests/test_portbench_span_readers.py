"""The readers of the program's spans (``portbench/spans.py`` and the
``metrics/`` files that use it) on a hand-built span table: the window's
calls are the last N records of their name, a call's children are found by
parent id, ``chunk_host_ms.train`` is ``train_chunk``'s self time,
``refresh_build_ms.train`` takes the builds that start in the window, and
against a program that keeps no records every reader gives None."""

import types

import pytest
from helpers import PB

from freud_tpu_torch import profiling
from portbench import core

Record = profiling.Record
SERVE = ("serve_request_ms.serve", "serve_read_ms.serve", "serve_parse_ms.serve",
         "serve_decode_ms.serve", "serve_locked_ms.serve", "serve_respond_ms.serve")
TRAIN = ("chunk_host_ms.train", "chunk_replay_ms.train", "refresh_applied_pct.train",
         "refresh_build_ms.train", "graph_capture_s.train")


class Table:
    """A span table: ``add`` appends a record as a span's close would."""

    def __init__(self):
        self.by_name: dict = {}
        self.next_id = 1

    def add(self, name, dur_s, parent=None):
        rec = Record(self.next_id, None if parent is None else parent.id, 7,
                     1_000 * self.next_id, dur_s)
        self.next_id += 1
        self.by_name.setdefault(name, []).append(rec)
        return rec

    def records(self, name):
        return list(self.by_name.get(name, ()))


@pytest.fixture
def table(monkeypatch):
    t = Table()
    monkeypatch.setattr(profiling, "records", t.records)
    return t


def _reading(**w):
    run = types.SimpleNamespace(config={}, traffic={}, profiled=None)
    return core.Reading(run, core.Window({}, 0, 0, dict(w)))


def _read(name, r):
    return core.metric_reader(name, PB).read(r)


def test_serve_readers_take_the_window_requests(table):
    # two warm-up requests, then the window's three; children by parent id
    for req_s, part_s in ((9.0, 1.0), (8.0, 1.0), (0.050, 0.001), (0.060, 0.003),
                          (0.070, 0.002)):
        req = table.add("serve.request", req_s)
        for i, name in enumerate(("serve.read", "serve.parse", "serve.decode",
                                  "serve.locked", "serve.respond")):
            table.add(name, part_s * (i + 1), parent=req)
        table.add("serve.lock_wait", part_s, parent=req)  # no reader
    r = _reading(latencies_s=[0.1, 0.1, 0.1])
    assert _read("serve_request_ms.serve", r) == pytest.approx(60.0)
    for i, name in enumerate(SERVE[1:]):
        assert _read(name, r) == pytest.approx(2.0 * (i + 1)), name
    # a window longer than the records kept reads nothing
    assert _read("serve_parse_ms.serve", _reading(latencies_s=[0.1] * 6)) is None
    assert _read("serve_request_ms.serve", _reading(latencies_s=[])) is None


def test_train_readers_take_the_window_chunks_and_self_time(table):
    table.add("chunk_capture", 2.5)
    table.add("cache_refresh_build", 0.05)  # in set-up, before the window
    setup = table.add("train_chunk", 5.0)  # the check's chunk, in set-up
    table.add("chunk_replay", 1.0, parent=setup)
    table.add("cache_refresh_apply", 0.001, parent=setup)
    table.add("chunk_capture", 1.5)
    table.add("cache_refresh_build", 0.07)  # before the window's first chunk
    builds = iter((0.1, 0.3, 0.2))
    for host_s, replay_s, applied in ((0.010, 3.0, True), (0.030, 3.2, False),
                                      (0.020, 3.1, True), (0.040, 3.3, False)):
        chunk = table.add("train_chunk", host_s + replay_s)
        if applied:
            table.add("cache_refresh_apply", 0.002, parent=chunk)
        table.add("chunk_replay", replay_s, parent=chunk)
        table.add("cache_refresh_build", next(builds, 0.25))
    r = _reading(chunk_call_s=[3.0] * 4)
    assert _read("chunk_host_ms.train", r) == pytest.approx(25.0)
    assert _read("chunk_replay_ms.train", r) == pytest.approx(3150.0)
    assert _read("refresh_applied_pct.train", r) == pytest.approx(50.0)
    # the window's four builds: the two before its first chunk are left out
    assert _read("refresh_build_ms.train", r) == pytest.approx(225.0)
    assert _read("graph_capture_s.train", r) == pytest.approx(4.0)
    # the set-up chunk joins a window one longer
    r5 = _reading(chunk_call_s=[3.0] * 5)
    assert _read("refresh_applied_pct.train", r5) == pytest.approx(60.0)
    assert _read("chunk_replay_ms.train", r5) == pytest.approx(3100.0)
    assert _read("refresh_build_ms.train", r5) == pytest.approx(200.0)


def test_refresh_share_reads_zero_when_none_applied(table):
    for _ in range(3):
        chunk = table.add("train_chunk", 1.0)
        table.add("chunk_replay", 0.9, parent=chunk)
    assert _read("refresh_applied_pct.train", _reading(chunk_call_s=[1.0] * 3)) == 0.0
    assert _read("refresh_build_ms.train", _reading(chunk_call_s=[1.0] * 3)) is None
    assert _read("graph_capture_s.train", _reading()) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_span_reader_reads_nothing_without_records(monkeypatch, name):
    monkeypatch.delattr(profiling, "records")
    r = _reading(latencies_s=[0.1] * 3, chunk_call_s=[1.0] * 3)
    assert _read(name, r) is None
