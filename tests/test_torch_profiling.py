"""freud_tpu_torch's spans (``profiling.py``) on the CPU: each call's record
(id, parent by nesting per thread, thread, start on ``time.time_ns()``),
the newest calls kept, the ``record_function`` annotation only under a
profiler and on the trace's own clock, ``start_trace`` catching a worker
thread, and the spans the program opens: a ``/top_features`` request's
stages, a train chunk's replay, the device cache's refreshes."""

import dataclasses
import http.client
import io
import json
import threading
import time
import wave

import numpy as np
import pytest
import torch

from freud_tpu_torch import profiling
from freud_tpu_torch.data.device_cache import DeviceShuffleCache
from freud_tpu_torch.data.store import ActivationStoreWriter
from freud_tpu_torch.models.whisper.model import WhisperDims, init_encoder
from freud_tpu_torch.server import app
from freud_tpu_torch.train.trainer import SAETrainer

SERVE_CHILDREN = ("serve.read", "serve.parse", "serve.decode", "serve.lock_wait",
                  "serve.locked", "serve.respond")


@pytest.fixture(autouse=True)
def _fresh_table():
    profiling.reset()
    yield
    profiling.reset()


def _only(name):
    recs = profiling.records(name)
    assert len(recs) == 1, (name, recs)
    return recs[0]


def _children(parent, name):
    return [r for r in profiling.records(name) if r.parent == parent.id]


def test_span_records_nest_per_thread():
    ready = threading.Barrier(2, timeout=30)

    def nest(tag):
        with profiling.span(f"outer.{tag}"):
            ready.wait()  # both threads hold their outer span at once
            with profiling.span("inner"):
                pass

    worker = threading.Thread(target=nest, args=("worker",))
    worker.start()
    nest("main")
    worker.join(timeout=30)
    assert not worker.is_alive()
    outers = {tag: _only(f"outer.{tag}") for tag in ("main", "worker")}
    inners = profiling.records("inner")
    assert len(inners) == 2
    assert {r.parent for r in inners} == {o.id for o in outers.values()}
    for r in inners:
        outer = next(o for o in outers.values() if o.id == r.parent)
        assert r.thread == outer.thread
        assert outer.start_ns <= r.start_ns
        assert r.dur_s <= outer.dur_s
    assert outers["main"].thread == threading.get_native_id()
    assert outers["worker"].thread != outers["main"].thread
    assert all(o.parent is None for o in outers.values())
    ids = [r.id for r in (*outers.values(), *inners)]
    assert len(set(ids)) == 4
    assert profiling.calls("inner") == [r.dur_s for r in inners]
    assert profiling.stats()["inner"]["count"] == 2


def test_span_start_on_time_ns():
    before = time.time_ns()
    with profiling.span("clocked"):
        time.sleep(0.002)
    after = time.time_ns()
    r = _only("clocked")
    assert before <= r.start_ns <= after
    assert 0.002 <= r.dur_s <= (after - before) / 1e9


def test_span_keeps_the_newest_calls():
    n = profiling._MAX_CALLS_KEPT
    assert n == 2048
    for _ in range(n + 5):
        with profiling.span("many"):
            pass
    recs = profiling.records("many")
    assert len(recs) == n
    assert profiling.stats()["many"]["count"] == n + 5
    assert [r.id for r in recs] == sorted(r.id for r in recs)
    # the first five calls are the ones dropped
    assert recs[-1].id - recs[0].id == n - 1


def _annotations(trace: dict) -> dict:
    return {e["name"]: e for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"}


def test_annotation_only_under_a_profiler_on_the_trace_clock(tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profiling.span("unprofiled"):
        pass
    assert opened == []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with profiling.span("profiled"):
            torch.ones(16) + 1
    finally:
        prof.stop()
    assert opened == ["profiled"]
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    ann = _annotations(trace)
    assert "profiled" in ann and "unprofiled" not in ann
    # ts (µs) counts from baseTimeNanoseconds on the records' clock
    r = _only("profiled")
    start_ns = trace["baseTimeNanoseconds"] + 1e3 * ann["profiled"]["ts"]
    end_ns = start_ns + 1e3 * ann["profiled"]["dur"]
    slack = 100e3
    assert r.start_ns - slack <= start_ns
    assert end_ns <= r.start_ns + 1e9 * r.dur_s + slack


def test_start_trace_catches_a_worker_thread(tmp_path):
    def work():
        with profiling.span("worker.stage"):
            torch.ones(16) + 1

    profiling.start_trace(str(tmp_path))
    try:
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    finally:
        profiling.stop_trace()
    (path,) = tmp_path.glob("*.pt.trace.json")
    ann = _annotations(json.loads(path.read_text()))
    assert "worker.stage" in ann
    assert ann["worker.stage"]["tid"] == _only("worker.stage").thread


# ------------------------------------------------------ the program's spans


def _wav_bytes(seconds: float) -> bytes:
    buf = io.BytesIO()
    audio = np.random.default_rng(1).standard_normal(int(16000 * seconds)) * 0.1
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def test_top_features_request_spans(tmp_path, monkeypatch):
    dims = WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=32, n_audio_head=2,
                       n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=32,
                       n_text_head=2, n_text_layer=1)
    sd = {f"encoder.{k}": v for k, v in init_encoder(dims, seed=2).state_dict().items()}
    (tmp_path / "whisper").mkdir()
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": sd},
               tmp_path / "whisper" / "tiny.pt")
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(tmp_path / "whisper"))
    audio = tmp_path / "audio"
    audio.mkdir()
    upload = _wav_bytes(0.5)
    (audio / "c0.wav").write_bytes(upload)
    state = app.GuiState({"whisper_model": "tiny", "layer_name": "encoder.blocks.1",
                          "data_path": str(audio), "batch_size": 1, "device": "cpu"})
    server = app.create_server(state, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    boundary = "span-test"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"audio\"; "
            f"filename=\"u.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
        + upload + f"\r\n--{boundary}--\r\n".encode()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        for _ in range(2):  # one connection kept alive: two request lines
            conn.request("POST", "/top_features?top_n=4", body=body,
                         headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
            resp = conn.getresponse()
            answer = json.loads(resp.read())
            assert resp.status == 200 and len(answer["top_indices"]) == 4
        conn.request("GET", "/status")
        assert conn.getresponse().read()
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    requests = profiling.records("serve.request")
    assert len(requests) == 2  # the GET opens none
    for req in requests:
        assert req.parent is None
        total = 0.0
        for name in SERVE_CHILDREN:
            (child,) = _children(req, name)
            assert child.thread == req.thread
            assert req.start_ns <= child.start_ns
            total += child.dur_s
        assert total <= req.dur_s
    for name in SERVE_CHILDREN:
        assert len(profiling.records(name)) == 2


N_FILES, T, D = 12, 4, 6


def _store(folder):
    data = np.random.default_rng(0).standard_normal((N_FILES, T, D)).astype(np.float32)
    w = ActivationStoreWriter(str(folder), "L", (T, D), (T, D))
    w.append_batch([f"f{i}" for i in range(N_FILES)], data)
    w.close()
    return str(folder)


def _trainer():
    return SAETrainer("topk", {"expansion_factor": 2, "k": 2, "auxk_alpha": 1 / 32,
                               "dead_feature_threshold": 6}, D, optimizer="adam",
                      scheduler="linear", scheduler_params={"num_warmup_steps": 1},
                      lr=1e-2, steps=12, seed=3, device="cpu")


def test_train_chunk_holds_its_replay(tmp_path):
    cache = DeviceShuffleCache(_store(tmp_path / "s"), "L", capacity_files=N_FILES,
                               refresh_files=0, seed=7, device="cpu")
    try:
        trainer = _trainer()
        for _ in range(2):
            trainer.train_chunk(cache, 4, 3)
    finally:
        cache.close()
    chunks = profiling.records("train_chunk")
    assert len(chunks) == 2
    for c in chunks:
        (replay,) = _children(c, "chunk_replay")
        assert c.start_ns <= replay.start_ns and replay.dur_s <= c.dur_s
    assert profiling.records("chunk_capture") == []  # the CPU runs no graph
    assert profiling.records("cache_refresh_apply") == []  # nothing to refresh


def test_cache_refresh_spans(tmp_path):
    cache = DeviceShuffleCache(_store(tmp_path / "s"), "L", capacity_files=4,
                               refresh_files=2, seed=7, device="cpu")
    try:
        deadline = time.monotonic() + 60
        while cache._q.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cache._q.qsize() == 2, "the producer staged no refresh"
        trainer = _trainer()
        for _ in range(2):
            trainer.train_chunk(cache, 4, 2)
    finally:
        cache.close()
    builds = profiling.records("cache_refresh_build")
    stages = profiling.records("cache_refresh_stage")
    assert len(builds) >= 2 and len(stages) >= 2
    for b, st in zip(builds, stages):  # the build ends before its staging starts
        assert b.thread == st.thread != threading.get_native_id()
        assert b.parent is None and st.parent is None
        assert b.start_ns + 1e9 * b.dur_s <= st.start_ns + 1e6
    chunks = profiling.records("train_chunk")
    applies = profiling.records("cache_refresh_apply")
    assert len(applies) == 2
    assert sorted(a.parent for a in applies) == sorted(c.id for c in chunks)
