"""The GUI/HTTP server: freud_tpu_torch's against freud_tpu's, each on
port 0 in this process, on the same config (``"device": "cpu"``, which
JAX's ignores), the same weights (a ``tiny.pt`` of narrow dims both
packages load) and the same stores (collected once by freud_tpu).

From disk, with and without a TopK SAE: ``/status`` and ``/top_files``
answer byte-identical bodies, on the scan and on the feature-major fast
path. Fly mode: the same files in the same order, values within
FLY_TOL of the largest |value|. Every endpoint answers the same keys and
types; the upload endpoints' indices are equal and traces within FLY_TOL;
transcripts equal. Error codes (400, 403, 404, 413, 416, a JSON 500),
``Range`` answers, CORS and the static page are the same; ``/transcribe``'s
long forms (``long=1``, ``word_timestamps=1``, ``format=txt|srt|vtt|tsv``,
an upload over 30 s) answer as JAX's with both seek loops pinned to t = 0
(srt, vtt, tsv and txt byte for byte, JSON up to the statistics' 1e-4);
an out-of-range request is followed by a good one."""

import http.client
import io
import json
import threading
import urllib.parse
import wave

import jax
import numpy as np
import pytest
import torch

import freud_tpu.server.app as japp
import freud_tpu_torch.server.app as tapp
from freud_tpu.models.sae import init_topk, state_dict_from_params
from freud_tpu.models.sae.config import config_for_variant
from freud_tpu.models.whisper.config import WhisperDims as JaxDims
from freud_tpu.models.whisper.model import init_params
from freud_tpu.scripts.collect_activations import get_activations as jax_collect
from freud_tpu_torch.data import feature_store as tfs
from freud_tpu_torch.models.whisper import WhisperDims, state_dict_from_jax

FLY_TOL = 1e-4  # computed values, relative to the largest |value|
LAYER = "encoder.blocks.1"
DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=1)
MODES = ["disk", "disk_topk", "fly"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav_bytes(seconds, seed=1):
    buf = io.BytesIO()
    audio = np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _serve(app, config, from_disk, **kw):
    state = app.GuiState(config, from_disk=from_disk, **kw)
    state.runtime.max_new_tokens = 3
    server = app.create_server(state, host="127.0.0.1", port=0)
    server.state = state
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("server")
    wdir = root / "whisper"
    wdir.mkdir()
    np_params = jax.tree_util.tree_map(np.asarray, init_params(JaxDims(**DIMS), seed=2))
    torch.save({"dims": dict(DIMS),
                "model_state_dict": state_dict_from_jax(np_params, WhisperDims(**DIMS))},
               wdir / "tiny.pt")
    audio = root / "audio"
    audio.mkdir()
    for i, secs in enumerate((1.0, 0.5, 2.0, 1.5)):
        (audio / f"c{i}.wav").write_bytes(_wav_bytes(secs, seed=10 + i))
    raw = {"expansion_factor": 2, "k": 8}
    ckpt = root / "topk.pth"
    torch.save({"model": state_dict_from_params(
                    "topk", init_topk(64, config_for_variant("topk", raw), seed=4)),
                "hparams": {"autoencoder_variant": "topk", "autoencoder_config": raw,
                            "activation_size": 64}}, ckpt)
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))
    configs = {}
    for mode, sae in (("disk", None), ("disk_topk", str(ckpt)), ("fly", None)):
        out = root / f"store_{mode}"
        if mode != "fly":
            jax_collect(data_path=str(audio), layer_name=LAYER, whisper_model="tiny",
                        sae_model=sae, batch_size=2, out_folder=str(out), verbose=False)
        configs[mode] = {"whisper_model": "tiny", "sae_model": sae, "layer_name": LAYER,
                         "batch_size": 3, "data_path": str(audio), "out_folder": str(out),
                         "dl_max_workers": 0, "device": "cpu"}
    servers = {mode: tuple(_serve(app, cfg, mode != "fly") for app in (japp, tapp))
               for mode, cfg in configs.items()}
    yield root, audio, configs, servers
    for pair in servers.values():
        for s in pair:
            s.shutdown()
            s.server_close()
    mp.undo()


def request(server, method, path, body=None, headers=None):
    """→ (status, headers dict, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def post_audio(server, path, data, filename="u.wav"):
    boundary = "b42"
    body = (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="audio"; filename="{filename}"\r\n'
            "Content-Type: audio/wav\r\n\r\n").encode() + data + \
        f"\r\n--{boundary}--\r\n".encode()
    return request(server, "POST", path, body,
                   {"Content-Type": f"multipart/form-data; boundary={boundary}"})


def both(pair, method, path, **kw):
    fn = post_audio if method == "POST" else request
    args = (path, kw.pop("data")) if method == "POST" else (method, path)
    return [fn(s, *args, **kw) for s in pair]


def _schema(obj):
    """Keys and value types, recursively (lists by their first element)."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return ["list", _schema(obj[0]) if obj else None]
    return type(obj).__name__


TOP_FILES = ["/top_files?feature_idx=0", "/top_files?feature_idx=5&n_files=2",
             "/top_files?feature_idx=7&absolute_magnitude=true&n_files=3",
             "/top_files?feature_idx=3&min_val=0.0&max_val=0.5",
             "/top_files?feature_idx=60&absolute_magnitude=1&min_val=-0.5"]


@pytest.mark.parametrize("mode", ["disk", "disk_topk"])
def test_status_and_top_files_byte_identical(env, mode):
    """From disk: the scan, then the fast path over the index the port
    builds (removed again after), answer the same bytes as JAX's."""
    root, _, configs, servers = env
    pair = servers[mode]
    (jc, _, jb), (tc, th, tb) = both(pair, "GET", "/status")
    assert jc == tc == 200 and tb == jb
    assert th["Content-Type"] == "application/json"
    assert th["Access-Control-Allow-Origin"] == "*"
    scans = []
    for path in TOP_FILES:
        (jc, _, jb), (tc, _, tb) = both(pair, "GET", path)
        assert jc == tc == 200 and tb == jb, path
        scans.append(tb)
    folder = configs[mode]["out_folder"]
    if mode == "disk":
        tfs.build_feature_major_index(folder, LAYER, verbose=False)
    else:
        tfs.build_sparse_feature_major_index(folder, LAYER, verbose=False)
    try:
        for path, scan in zip(TOP_FILES, scans):
            (jc, _, jb), (tc, _, tb) = both(pair, "GET", path)
            assert jc == tc == 200 and tb == jb == scan, path
    finally:
        for p in root.glob(f"store_{mode}/{LAYER}_feature_major*"):
            p.unlink()


def _close(got, want, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0.0) <= FLY_TOL * scale


def test_fly_top_files_match(env):
    _, _, _, servers = env
    for path in TOP_FILES[:3]:
        (jc, _, jb), (tc, _, tb) = both(servers["fly"], "GET", path)
        assert jc == tc == 200
        j, t = json.loads(jb), json.loads(tb)
        assert _schema(t) == _schema(j) and t["top_files"] == j["top_files"]
        scale = max(abs(v) for v in j["max_per_file"])
        _close(t["max_per_file"], j["max_per_file"], scale)
        for a, b in zip(t["activations"], j["activations"]):
            _close(a, b, scale)


@pytest.mark.parametrize("mode", MODES)
def test_upload_endpoints_match(env, mode):
    """/top_features and /manipulate_feature on a 1.3-s upload: equal keys
    and types, indices and transcripts, traces within FLY_TOL."""
    _, _, _, servers = env
    pair = servers[mode]
    data = _wav_bytes(1.3, seed=5)
    (jc, _, jb), (tc, _, tb) = both(pair, "POST", "/top_features?top_n=5", data=data)
    assert jc == tc == 200
    j, t = json.loads(jb), json.loads(tb)
    assert _schema(t) == _schema(j) and len(t["top_indices"]) == 5
    scale = max(np.abs(np.asarray(j["top_activations"])).max(), 1e-30)
    jmax = [max(a) for a in j["top_activations"]]
    for i in range(4):
        if all(abs(jmax[i] - jmax[n]) > FLY_TOL * scale for n in (i - 1, i + 1) if n >= 0):
            assert t["top_indices"][i] == j["top_indices"][i]
    _close(t["top_activations"], j["top_activations"], scale)
    for factor in ("1.0", "3.0"):
        path = f"/manipulate_feature?feat_idx={j['top_indices'][0]}&manipulation_factor={factor}"
        (jc, _, jb), (tc, _, tb) = both(pair, "POST", path, data=data)
        assert jc == tc == 200
        jm, tm = json.loads(jb), json.loads(tb)
        assert _schema(tm) == _schema(jm)
        for key in ("baseline_text", "manipulated_text", "standard_text"):
            assert tm[key] == jm[key], key
        scale = max(np.abs(np.asarray(jm["manipulated_activations"])).max(), 1e-30)
        for key in ("standard_activations", "manipulated_activations"):
            _close(tm[key], jm[key], scale)
        if factor == "1.0" and mode != "disk_topk":
            assert len({tm["baseline_text"], tm["manipulated_text"], tm["standard_text"]}) == 1


@pytest.fixture()
def t0_long(monkeypatch):
    """Both packages' seek loops at t = 0 with 8 history slots: the server
    takes transcribe_long's default ladder, whose sampled rungs draw from
    different generators in the two packages."""
    import functools

    from freud_tpu.models.whisper import long_audio as jla
    from freud_tpu_torch.models.whisper import long_audio as tla

    for mod in (jla, tla):
        monkeypatch.setattr(mod, "transcribe_long", functools.partial(
            mod.transcribe_long, temperatures=(0.0,), history_budget=8))


def _json_close(got, want):
    if isinstance(want, float):
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _json_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _json_close(g, w)
    else:
        assert got == want


def test_transcribe(env, t0_long):
    """Plain and fallback requests on a clip of 30 s or less answer as
    JAX's (plain: equal text; the ladder's sampled rungs draw from other
    generators, so only its form); the long forms answer as JAX's: JSON
    with ``long=1``, ``word_timestamps=1`` on a short clip (text only),
    ``format=txt`` and a 31-s upload without ``long``; a bad format or a
    subtitle format without timed segments answers JAX's 400."""
    _, _, _, servers = env
    pair = servers["fly"]
    data = _wav_bytes(1.0, seed=6)
    (jc, _, jb), (tc, _, tb) = both(pair, "POST", "/transcribe", data=data)
    assert jc == tc == 200 and tb == jb
    code, _, body = post_audio(pair[1], "/transcribe?fallback=1", data)
    assert code == 200 and _schema(json.loads(body)) == {"text": "str"}
    for path, payload in (("/transcribe?long=1", data), ("/transcribe?word_timestamps=1", data),
                          ("/transcribe?format=txt", data),
                          ("/transcribe", _wav_bytes(31.0, seed=6))):
        (jc, jh, jb), (tc, th, tb) = both(pair, "POST", path, data=payload)
        assert jc == tc == 200, (path, tb)
        assert th["Content-Type"] == jh["Content-Type"], path
        if "format=txt" in path:
            assert tb == jb
        else:
            _json_close(json.loads(tb), json.loads(jb))
    for path in ("/transcribe?format=xml", "/transcribe?format=srt"):
        (jc, _, jb), (tc, _, tb) = both(pair, "POST", path, data=data)
        assert jc == tc == 400 and tb == jb, path


@pytest.mark.parametrize("path", [
    "/transcribe?long=1&word_timestamps=1",
    "/transcribe?long=1&word_timestamps=1&format=srt&max_line_width=10&max_line_count=2",
    "/transcribe?long=1&format=vtt&word_timestamps=1&highlight_words=1",
    "/transcribe?long=1&format=tsv",
    "/transcribe"])
def test_long_transcribe_matches_jax(env, t0_long, path):
    """A 45-s upload: JSON (with words), srt (split on word boundaries),
    vtt (one cue a word), tsv, and without ``long`` (routed to the seek loop
    by its length) — each JAX's answer."""
    _, _, _, servers = env
    data = _wav_bytes(45.0, seed=7)
    (jc, jh, jb), (tc, th, tb) = both(servers["disk"], "POST", path, data=data)
    assert jc == tc == 200, tb
    assert th["Content-Type"] == jh["Content-Type"]
    if "format=" in path:
        assert tb == jb and tb.strip()
    else:
        got = json.loads(tb)
        _json_close(got, json.loads(jb))
        assert set(got) == {"text", "segments", "language"} and got["segments"]
        assert all(s["start"] >= 30.0 for s in got["segments"] if s["seek"] >= 3000)


def test_bad_subtitle_option_is_refused_before_device_work(env, monkeypatch):
    _, _, _, servers = env
    state = servers["disk"][1].state
    monkeypatch.setattr(state, "transcribe", lambda *a: pytest.fail("device work"))
    code, _, body = post_audio(servers["disk"][1],
                               "/transcribe?long=1&format=srt&max_line_width=wide",
                               _wav_bytes(1.0))
    assert code == 400 and "max_line_width" in json.loads(body)["error"]


def test_error_codes_match(env, monkeypatch):
    _, audio, _, servers = env
    pair = servers["disk"]
    good = _wav_bytes(0.5)
    cases = [("GET", "/nope", None), ("GET", "/audio/etc/passwd", None),
             ("GET", "/audio" + str(audio / "missing.wav"), None),
             ("GET", "/top_files?feature_idx=64", None),
             ("GET", "/top_files?feature_idx=-1", None),
             ("POST", "/nope", good), ("POST", "/top_features", b""),
             ("POST", "/top_features?top_n=0", good),
             ("POST", "/top_features?top_n=65", good),
             ("POST", "/manipulate_feature?feat_idx=64", good),
             ("POST", "/manipulate_feature?feat_idx=-3", good),
             ("POST", "/transcribe", b"not audio")]
    for method, path, data in cases:
        if method == "GET":
            got = both(pair, "GET", path)
        else:
            got = both(pair, "POST", path, data=data)
        (jc, jh, jb), (tc, th, tb) = got
        assert tc == jc and tc in (400, 403, 404), (path, tc, jc)
        assert th["Content-Type"] == jh["Content-Type"] == "application/json"
        assert tb == jb or _schema(json.loads(tb)) == _schema(json.loads(jb)), path
    # 413 from the header alone, before the body is read
    for s in pair:
        code, _, body = request(s, "POST", "/transcribe", b"x",
                                {"Content-Length": str(300 * 1024 * 1024),
                                 "Content-Type": "multipart/form-data; boundary=b"})
        assert code == 413 and json.loads(body) == {"error": "upload too large"}
    # an unexpected exception answers a JSON 500 in both

    def boom(*a, **k):
        raise RuntimeError("kaboom")

    monkeypatch.setattr(japp, "top_activations", boom)
    monkeypatch.setattr(tapp, "top_activations", boom)
    (jc, _, jb), (tc, _, tb) = both(pair, "GET", "/top_files?feature_idx=1")
    assert jc == tc == 500 and tb == jb and b"kaboom" in tb


def test_upload_disabled_and_cors(env):
    _, _, configs, servers = env
    pair = tuple(_serve(app, configs["disk"], True, no_audio_upload=True)
                 for app in (japp, tapp))
    try:
        (jc, _, jb), (tc, _, tb) = both(pair, "POST", "/top_features", data=_wav_bytes(0.5))
        assert jc == tc == 403 and tb == jb
        (jc, _, jb), (tc, _, tb) = both(pair, "GET", "/status")
        assert tb == jb and json.loads(tb)["allow_audio_upload"] is False
    finally:
        for s in pair:
            s.shutdown()
            s.server_close()
    (jc, jh, _), (tc, th, _) = both(servers["disk"], "OPTIONS", "/top_files")
    assert jc == tc == 204
    for key in ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
                "Access-Control-Allow-Headers", "Content-Length"):
        assert th[key] == jh[key], key


def test_range_answers_match(env):
    _, audio, _, servers = env
    path = "/audio" + urllib.parse.quote(str(audio / "c2.wav"))
    for rng in (None, "bytes=0-99", "bytes=100-", "bytes=-50", "bytes=10-5",
                "bytes=99999999-", "bytes=0-99999999", "items=0-3"):
        headers = {"Range": rng} if rng else {}
        (jc, jh, jb), (tc, th, tb) = [request(s, "GET", path, headers=headers)
                                      for s in servers["disk"]]
        assert tc == jc and tb == jb, rng
        for key in ("Content-Type", "Content-Range", "Content-Length", "Accept-Ranges"):
            assert th.get(key) == jh.get(key), (rng, key)
    assert [request(s, "GET", path, headers={"Range": "bytes=0-99"})[0]
            for s in servers["disk"]] == [206, 206]


def test_static_page_identical(env):
    from pathlib import Path

    page = Path(tapp.__file__).parent / "static" / "index.html"
    assert page.read_bytes() == (Path(japp.__file__).parent / "static" / "index.html").read_bytes()
    for route in ("/", "/index.html"):
        (jc, jh, jb), (tc, th, tb) = both(env[3]["fly"], "GET", route)
        assert jc == tc == 200 and tb == jb == page.read_bytes()
        assert th["Content-Type"] == jh["Content-Type"]


@pytest.mark.parametrize("mode", MODES)
def test_out_of_range_then_a_good_request(env, mode):
    """An out-of-range index answers 400 before any device work, and the
    next request still answers 200."""
    server = env[3][mode][1]
    n = json.loads(request(server, "GET", "/status")[2])["n_features"]
    data = _wav_bytes(0.5)
    for bad, good in ((f"/top_files?feature_idx={n}", "/top_files?feature_idx=1&n_files=1"),):
        assert request(server, "GET", bad)[0] == 400
        assert request(server, "GET", good)[0] == 200
    for bad, good in ((f"/manipulate_feature?feat_idx={n}", "/manipulate_feature?feat_idx=1"),
                      (f"/top_features?top_n={n + 1}", "/top_features?top_n=2")):
        assert post_audio(server, bad, data)[0] == 400
        assert post_audio(server, good, data)[0] == 200


def test_server_needs_the_card_unless_the_config_says_cpu(env, monkeypatch):
    _, _, configs, _ = env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {**configs["disk"], "device": "tpu"}
    with pytest.raises(RuntimeError, match="server"):
        tapp.GuiState(cfg, from_disk=True)
    assert tapp.GuiState(configs["disk"], from_disk=True).device == torch.device("cpu")


def test_concurrent_requests_are_serialized(env):
    """Eight clients at once on the port's TopK server (searches and
    uploads, each on its own handler thread, with a short switch
    interval): every answer is 200 and equal to the same request's answer
    made alone — the device lock serializes the work, and each handler
    thread runs it under its own inference mode."""
    import sys

    server = env[3]["disk_topk"][1]
    data = _wav_bytes(0.7, seed=8)
    jobs = [("GET", "/top_files?feature_idx=9&n_files=3"), ("POST", "/top_features?top_n=4")] * 4
    alone = {job: (request(server, *job) if job[0] == "GET"
                   else post_audio(server, job[1], data)) for job in set(jobs)}
    got = [None] * len(jobs)

    def run(i, job):
        got[i] = request(server, *job) if job[0] == "GET" else post_audio(server, job[1], data)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i, job)) for i, job in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for job, answer in zip(jobs, got):
        assert answer[0] == 200 and answer[2] == alone[job][2], job
