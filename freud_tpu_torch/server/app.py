"""GUI backend HTTP API on one device (the card unless the config says
``"device": "cpu"``).

The port of ``freud_tpu/server/app.py``, with its routes, schemas, status
codes and headers, so the stock React GUI and the bundled page
(``static/index.html``, byte-identical to the JAX package's) work
unchanged:

  GET  /status                 {"status", "n_features", "layer_name",
                                "allow_audio_upload"}
  GET  /top_files              {"top_files", "activations", "max_per_file"}
  GET  /audio/<path>           audio file bytes (single ``Range`` form)
  POST /top_features?top_n     {"top_indices", "top_activations"}
  POST /manipulate_feature     {"baseline_text", "manipulated_text",
       ?feat_idx&manipulation_factor
                                "standard_text", "standard_activations",
                                "manipulated_activations"}
  POST /transcribe             {"text"}; with ?long=1 (or a clip over
       ?long&word_timestamps     30 s) {"text", "segments", "language"};
       &fallback&format          ?format=txt|srt|vtt|tsv renders the result
                                 as text (models/whisper/writers.py)

Implementation is stdlib ``http.server`` (threaded) with permissive CORS.
Device work is serialized behind one lock, and runs under
``torch.inference_mode()`` in the request's own thread (grad mode is per
thread: a ``no_grad`` of the main thread does not reach a request's).
Every index a request names is range-checked on the host before any device
work: on CUDA an out-of-range gather fires a device-side assert, which
poisons the process's CUDA context for every later request.

``/audio/<path>`` serves only paths that resolve inside the configured
dataset roots unless ``allow_any_audio_path`` is set.

``/transcribe`` routes ``long=1`` and any upload over 30 s through the
long-form seek loop (``WhisperRuntime.transcribe_long``, word times with
``word_timestamps=1``), as the JAX server does; its query parameters are
checked on the host before any device work, and a bad one answers 400.

Every POST opens the span ``serve.request`` (``profiling.span``) from its
request line to the last byte written, with the children ``serve.read``
(receiving the body), ``serve.parse`` (the multipart parse),
``serve.decode`` (the upload's decode), ``serve.lock_wait`` (the queue
behind the device lock), ``serve.locked`` (the work under it, which ends
with the answer's copy to the host) and ``serve.respond`` (the answer's
JSON or text and its write).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import threading
import urllib.parse
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import profiling
from ..analysis.features import FeatureAnalyzer
from ..analysis.search import top_activations
from ..audio.decode import load_audio
from ..audio.mel import mels_from_array
from ..constants import N_SAMPLES
from ..data.loaders import FlyActivationLoader, MemoryMappedActivationLoader, load_sae
from ..device import resolve_device
from ..models.whisper import WhisperRuntime
from ..models.whisper.writers import get_writer

_MIME = {
    ".flac": "audio/flac",
    ".wav": "audio/wav",
    ".mp3": "audio/mpeg",
    ".ogg": "audio/ogg",
    ".m4a": "audio/mp4",
}


class GuiState:
    """Server-owned models + search closure."""

    def __init__(
        self,
        config: dict,
        from_disk: bool = False,
        files_to_search: Optional[int] = None,
        no_audio_upload: bool = False,
        allow_any_audio_path: bool = False,
    ):
        layer_name = config["layer_name"]
        whisper_model = config["whisper_model"]
        sae_checkpoint = config.get("sae_model") or None
        # "device": "cpu" serves from the CPU; anything else (the repo's
        # configs say "tpu") means the card, and raises without one
        self.device = resolve_device(config.get("device"), "server")
        # "precision": "bfloat16" in the config (or gui_server --precision)
        # switches the serving runtime — encoder AND decoder — to bf16 in
        # both modes
        cdt = (torch.bfloat16 if config.get("precision") == "bfloat16"
               else torch.float32)

        if from_disk:
            self.loader = MemoryMappedActivationLoader(
                config["out_folder"], layer_name, config["batch_size"],
                subset_size=files_to_search,
            )
            self.runtime = WhisperRuntime(whisper_model, layer_name,
                                          compute_dtype=cdt, device=self.device)
            sae = None
            if sae_checkpoint:
                variant, cfg, _, params = load_sae(sae_checkpoint, self.device)
                sae = (variant, cfg, params.eval())
        else:
            self.loader = FlyActivationLoader(
                config["data_path"], whisper_model, sae_checkpoint, layer_name,
                config["batch_size"], subset_size=files_to_search,
                compute_dtype=cdt, device=self.device,
            )
            self.runtime = self.loader.runtime
            sae = self.loader.sae
        self.sae = sae
        self.analyzer = FeatureAnalyzer(self.runtime, self.sae)
        self.layer_name = layer_name
        self.n_features = self.loader.activation_shape[-1]
        self.allow_audio_upload = not no_audio_upload
        self.allow_any_audio_path = allow_any_audio_path
        # realpath the roots too: requested files are realpath'd before the
        # containment check, so a symlinked dataset root (abspath ≠ realpath)
        # would otherwise 403 every legitimate file
        self.audio_roots = [
            os.path.realpath(p)
            for p in (config.get("data_path"), config.get("out_folder"))
            if p
        ]
        self.lock = threading.Lock()

    def audio_path_allowed(self, path: str) -> bool:
        if self.allow_any_audio_path:
            return True
        real = os.path.realpath(path)
        return any(
            os.path.commonpath([real, root]) == root
            for root in self.audio_roots
            if os.path.exists(root)
        )

    def top_files(self, feature_idx, n_files, max_val, min_val, absolute_magnitude):
        results, max_per_file = top_activations(
            self.loader, feature_idx, n_files, max_val, min_val,
            absolute_magnitude, return_max_per_file=True, device=self.device,
        )
        return {
            "top_files": [r[0] for r in results],
            "activations": [np.asarray(r[1]).tolist() for r in results],
            "max_per_file": max_per_file,
        }

    def transcribe(self, audio: np.ndarray, long_mode: bool, fallback: bool,
                   word_timestamps: bool) -> dict:
        """``/transcribe``'s result: with ``long_mode`` or more than 30 s of
        audio the long-form seek loop ({"text", "segments", "language"},
        words with ``word_timestamps``); else {"text"} of one 30-s window,
        greedy or through the temperature ladder with ``fallback``."""
        rt = self.runtime
        if long_mode or len(audio) > N_SAMPLES:
            return rt.transcribe_long(audio, word_timestamps=word_timestamps)
        mel = mels_from_array(audio, rt.dims.n_mels, device=rt.device)
        if fallback:
            return {"text": rt.transcribe_with_fallback(mel)[0]}
        return {"text": rt.transcribe(mel)[0]}


def decode_uploaded_audio(data: bytes, filename: str = "upload") -> np.ndarray:
    """Decode uploaded bytes to 16 kHz mono float32 via the native decoder
    (stdlib ``wave`` for WAV where the library is absent)."""
    suffix = Path(filename).suffix or ".wav"
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
        f.write(data)
        tmp = f.name
    try:
        return load_audio(tmp)
    finally:
        os.unlink(tmp)


def parse_multipart(content_type: str, body: bytes):
    """{name: (filename, bytes)} from a multipart/form-data body."""
    header = f"Content-Type: {content_type}\r\n\r\n".encode()
    msg = BytesParser(policy=HTTP).parsebytes(header + body)
    out = {}
    if msg.is_multipart():
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name:
                out[name] = (part.get_filename() or "", part.get_payload(decode=True))
    return out


_UPLOAD_ROUTES = ("/top_features", "/manipulate_feature", "/transcribe")


def make_handler(state: GuiState):
    @contextlib.contextmanager
    def device_lock():
        """The one device lock, its wait and its hold as spans, the hold
        under inference mode."""
        with profiling.span("serve.lock_wait"):
            state.lock.acquire()
        try:
            with profiling.span("serve.locked"), torch.inference_mode():
                yield
        finally:
            state.lock.release()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # ---- helpers ----
        def _send_json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_text(self, text, mime, code=200):
            data = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", f"{mime}; charset=utf-8")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_audio(self, fpath):
            """Serve a file with HTTP Range support (single range form):
            browser <audio>/wavesurfer seek issues `Range: bytes=N-` and
            breaks on long files without 206 responses."""
            size = os.path.getsize(fpath)
            mime = _MIME.get(Path(fpath).suffix.lower(), "audio/flac")
            start, end = 0, size - 1
            rng = self.headers.get("Range", "")
            is_partial = False
            m = re.fullmatch(r"bytes=(\d*)-(\d*)", rng.strip()) if rng else None
            if m and (m.group(1) or m.group(2)):
                if m.group(1):
                    start = int(m.group(1))
                    if m.group(2):
                        end = min(int(m.group(2)), size - 1)
                else:  # suffix form: last N bytes
                    start = max(size - int(m.group(2)), 0)
                if start >= size:
                    self.send_response(416)
                    self.send_header("Content-Range", f"bytes */{size}")
                    self.send_header("Access-Control-Allow-Origin", "*")
                    # explicit empty body: a keep-alive client would
                    # otherwise wait forever for an unterminated body
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if end < start:
                    # RFC 7233: a byte-range with last-byte-pos <
                    # first-byte-pos is syntactically invalid — IGNORE the
                    # Range header and serve the full file with 200
                    start, end = 0, size - 1
                    is_partial = False
                else:
                    is_partial = True
            length = end - start + 1
            self.send_response(206 if is_partial else 200)
            self.send_header("Content-Type", mime)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Accept-Ranges", "bytes")
            if is_partial:
                self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
            self.send_header("Content-Length", str(length))
            self.end_headers()
            with open(fpath, "rb") as f:
                f.seek(start)
                remaining = length
                while remaining > 0:
                    chunk = f.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    remaining -= len(chunk)

        def _query(self):
            parsed = urllib.parse.urlparse(self.path)
            return parsed.path, dict(urllib.parse.parse_qsl(parsed.query))

        # ---- routes ----
        def handle_one_request(self):
            # unexpected handler exceptions must answer 500 JSON, not drop
            # the connection mid-response (Flask's behavior the React client
            # expects); headers-already-sent errors can only close
            with contextlib.ExitStack() as self._request_span:
                try:
                    super().handle_one_request()
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
                except Exception as e:  # noqa: BLE001 — last-resort boundary
                    try:
                        self._send_json({"error": f"internal error: {e}"}, 500)
                    except Exception:  # noqa: BLE001
                        self.close_connection = True

        def parse_request(self):
            # a POST's serve.request opens once its request line has been
            # read and closes with handle_one_request, after the last byte
            if self.raw_requestline.startswith(b"POST "):
                self._request_span.enter_context(profiling.span("serve.request"))
            return super().parse_request()

        def do_OPTIONS(self):
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            path, q = self._query()
            if path in ("/", "/index.html"):
                page = Path(__file__).parent / "static" / "index.html"
                data = page.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/status":
                self._send_json(
                    {
                        "status": "Initialization complete",
                        "n_features": int(state.n_features),
                        "layer_name": state.layer_name,
                        "allow_audio_upload": state.allow_audio_upload,
                    }
                )
            elif path == "/top_files":
                feat = int(q.get("feature_idx", 0))
                if not (0 <= feat < state.n_features):
                    # JSON body: the GUI surfaces {"error": ...} messages
                    self._send_json(
                        {"error": f"feature_idx {feat} outside "
                                  f"[0, {state.n_features})"}, 400)
                    return
                args = {
                    "feature_idx": feat,
                    "n_files": int(q.get("n_files", 10)),
                    "max_val": float(q["max_val"]) if q.get("max_val") else None,
                    "min_val": float(q["min_val"]) if q.get("min_val") else None,
                    "absolute_magnitude": q.get("absolute_magnitude", "")
                    not in ("", "false", "False", "0"),
                }
                with state.lock, torch.inference_mode():
                    self._send_json(state.top_files(**args))
            elif path.startswith("/audio/"):
                fname = urllib.parse.unquote(path[len("/audio/") :])
                fpath = "/" + fname if not fname.startswith("/") else fname
                if not state.audio_path_allowed(fpath):
                    self._send_json({"error": "path outside dataset roots"}, 403)
                    return
                if not os.path.exists(fpath):
                    self._send_json({"error": "not found"}, 404)
                    return
                self._send_audio(fpath)
            else:
                self._send_json({"error": "not found"}, 404)

        MAX_UPLOAD_BYTES = 256 * 1024 * 1024  # ~2.3 h of 16 kHz wav

        def do_POST(self):
            path, q = self._query()
            length = int(self.headers.get("Content-Length", 0))
            if length > self.MAX_UPLOAD_BYTES:
                # reject before reading: an unbounded body would be decoded
                # to a temp file and a float32 buffer ~8x its size
                self._send_json({"error": "upload too large"}, 413)
                return
            if path not in _UPLOAD_ROUTES or not state.allow_audio_upload:
                # read either way: the kept-alive connection's next request
                # starts after this body
                self.rfile.read(length)
                if path not in _UPLOAD_ROUTES:
                    self._send_json({"error": "not found"}, 404)
                else:
                    self._send_json({"error": "audio upload disabled"}, 403)
                return
            try:
                with profiling.span("serve.read"):
                    body = self.rfile.read(length)
                with profiling.span("serve.parse"):
                    parts = parse_multipart(self.headers.get("Content-Type", ""), body)
                if "audio" not in parts:
                    raise ValueError("No audio file provided")
                filename, payload = parts["audio"]
                if not payload:
                    raise ValueError("No selected file")
                with profiling.span("serve.decode"):
                    audio = decode_uploaded_audio(payload, filename)
            except (ValueError, RuntimeError) as e:
                self._send_json({"error": str(e)}, 400)
                return

            if path == "/transcribe":
                # multipart ``audio`` → transcript JSON; ``?long=1`` (or a
                # clip over 30 s) takes the seek loop with the per-window
                # ladder, ``&word_timestamps=1`` adds word times;
                # ``?fallback=1`` walks the ladder on one 30-s window. The
                # decode precision is the server runtime's compute_dtype
                truthy = ("1", "true", "yes")
                long_mode = q.get("long", "0").lower() in truthy
                fallback = q.get("fallback", "0").lower() in truthy
                fmt = q.get("format", "json").lower()
                if fmt not in ("json", "txt", "srt", "vtt", "tsv"):
                    self._send_json(
                        {"error": f"format must be json|txt|srt|vtt|tsv, "
                                  f"got {fmt!r}"}, 400)
                    return
                if fmt in ("srt", "vtt", "tsv") and not (
                        long_mode or len(audio) > N_SAMPLES):
                    self._send_json(
                        {"error": f"format={fmt} needs timed segments — "
                                  "pass long=1"}, 400)
                    return
                wts = q.get("word_timestamps", "0").lower() in truthy
                # whisper's subtitle options ride query params on the srt/vtt
                # forms (word-boundary cues need word_timestamps=1)
                opts = {}
                if fmt in ("srt", "vtt"):
                    for key in ("max_line_width", "max_line_count"):
                        if not q.get(key):
                            continue
                        try:
                            opts[key] = int(q[key])
                        except ValueError:
                            self._send_json({"error": f"{key} must be an integer, "
                                                      f"got {q[key]!r}"}, 400)
                            return
                    if q.get("highlight_words", "0").lower() in truthy:
                        opts["highlight_words"] = True
                with device_lock():
                    result = state.transcribe(audio, long_mode, fallback, wts)
                with profiling.span("serve.respond"):
                    if fmt == "json":
                        self._send_json(result)
                    else:
                        mime = ("text/vtt" if fmt == "vtt" else
                                "text/tab-separated-values" if fmt == "tsv" else
                                "text/plain")
                        self._send_text(get_writer(fmt)(result, **opts), mime)
            elif path == "/top_features":
                top_n = int(q.get("top_n", 32))
                if not (1 <= top_n <= state.n_features):
                    self._send_json(
                        {"error": f"top_n must be in [1, "
                                  f"{state.n_features}], got {top_n}"}, 400)
                    return
                with device_lock():
                    idx, traces = state.analyzer.top_features_for_audio(audio, top_n)
                with profiling.span("serve.respond"):
                    self._send_json(
                        {
                            "top_indices": idx,
                            "top_activations": [np.asarray(t).tolist() for t in traces],
                        }
                    )
            else:
                feat_idx = int(q.get("feat_idx", 0))
                factor = float(q.get("manipulation_factor", 1.5))
                if not (0 <= feat_idx < state.n_features):
                    self._send_json(
                        {"error": f"feat_idx {feat_idx} outside "
                                  f"[0, {state.n_features})"}, 400)
                    return
                with device_lock():
                    (
                        baseline_text, manipulated_text, standard_text,
                        standard_acts, manipulated_acts,
                    ) = state.analyzer.manipulate(audio, feat_idx, factor)
                with profiling.span("serve.respond"):
                    self._send_json(
                        {
                            "baseline_text": baseline_text,
                            "manipulated_text": manipulated_text,
                            "standard_text": standard_text,
                            "standard_activations": np.asarray(standard_acts).tolist(),
                            "manipulated_activations":
                                np.asarray(manipulated_acts).tolist(),
                        }
                    )

    return Handler


def create_server(state: GuiState, host: str = "0.0.0.0", port: int = 5555):
    return ThreadingHTTPServer((host, port), make_handler(state))


def serve_forever(
    config: dict,
    from_disk: bool = False,
    files_to_search: Optional[int] = None,
    no_audio_upload: bool = False,
    host: str = "0.0.0.0",
    port: int = 5555,
):
    state = GuiState(config, from_disk, files_to_search, no_audio_upload)
    print("GUI data initialized.")
    server = create_server(state, host, port)
    print(f"Serving on http://{host}:{port}")
    server.serve_forever()
