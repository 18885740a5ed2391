"""Build directory and native builds: the audio decoder and the CUDA kernels.

Everything the package compiles lands in ``freud_tpu_torch/_build/`` (listed
in ``.gitignore``), at first use, from sources in the checkout:

* ``libfreud_audio.so`` from the port's own copy of the decoder sources
  (``audio/native/{Makefile,decoder.cpp}``, byte-identical to the JAX
  package's; the port reads nothing of that package);
* one ``lib<name>-<hash>.so`` per ``csrc/<name>.cu`` (which may include the
  shared ``csrc/*.cuh``), compiled by ``nvcc`` for ``sm_90a`` into a shared
  library with a plain C interface and loaded with ``ctypes``. The file name
  carries a hash of the sources, so an edited kernel never loads a stale
  build.

A file lock serialises builds across processes (parallel test workers, the
collection CLI started beside a smoke run).

This module is also the one binding seam of the kernels: ``SIGNATURES``
declares every entry point of every library once, each library's entry
points are bound when it loads, and a ``Kernel`` launches one of them
(device, stream, status check, launch count). A wrapper in ``ops/`` keeps
its plain version, its checks and its allocations, and marks itself
``@counted(kernel)``; ``train/graph.py`` counts every wrapper so marked
under CUDA graph replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
CSRC_DIR = PACKAGE_DIR / "csrc"
AUDIO_NATIVE_DIR = PACKAGE_DIR / "audio" / "native"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# The entry points of each kernel library ``csrc/<library>.cu``, one letter
# a parameter of the C prototype: p a pointer (a tensor's data, or None for
# NULL), i an int, f a float, q a long long array (a sequence of ints), s the
# stream, which ends a launcher's list. A launcher returns its cudaError_t;
# an entry without s is a limit query, which returns the limit. Spaces only
# group the letters. tests/test_torch_native.py holds each signature to its
# prototype.
SIGNATURES = {
    "mel": {"freud_log_mel": "ppp i ppp ii s"},
    "attention": {
        "freud_qkv_attention": "p i ppp q pppp iiii f s",
        "freud_whisper_attention": "pppp iiii q f i p s",
    },
    "topk_threshold": {
        "freud_topk_thresholds_max_n": "ii",
        "freud_topk_thresholds": "p ii pp iiiiii pppp s",
    },
    "topk_fused": {
        "freud_topk_fused_max_n": "",
        "freud_topk_sae_forward": "pppppp iiiii pppppppp s",
        "freud_topk_sae_encode": "pppp iii pp s",
        "freud_topk_sae_decode": "ppppp iii ppp s",
    },
    "topk_sharded": {
        "freud_shard_max_local": "",
        "freud_shard_candidates": "p i pp iiii p i s",
        "freud_shard_combine": "p iiiii p iiiiii pppp s",
    },
    "topk_backward": {
        "freud_topk_bwd_pair": "p i ppp iii p s",
        "freud_topk_bwd_route": "pp i ppp iii ppp s",
    },
    "topk_indexed": {
        "freud_topk_indexed_max_n": "i",
        "freud_topk_indexed": "p i p iiii pppp s",
    },
    "moe": {
        "freud_moe_max_all": "i",
        "freud_moe_route": "pp iii f i ppp s",
        "freud_moe_route_topk": "pp iii f iiii pppp s",
        "freud_moe_plan": "p iiii ppp s",
        "freud_moe_permute": "pp iii p s",
        "freud_moe_gateup": "p ii pp ii pppp s",
        "freud_moe_down": "p ii p ii pppp s",
        "freud_moe_combine": "ppppppp iiiii p s",
    },
    "gemm_f32x3": {"freud_gemm_f32x3": "pppppp iii s"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "q": ctypes.POINTER(ctypes.c_longlong), "s": ctypes.c_void_p}

_thread_lock = threading.Lock()
_cuda_libs: dict[str, ctypes.CDLL] = {}
_entry_points: dict[str, dict] = {}  # library → name → bound ctypes function
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}  # nvcc/ptxas output (registers, spills)


@contextlib.contextmanager
def build_lock():
    """Exclusive across threads and processes for the duration of a build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _thread_lock, open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_audio_decoder() -> Path | None:
    """``libfreud_audio.so`` in the build dir (built with the decoder's own
    Makefile); None when the sources or the ffmpeg libraries are missing."""
    out = BUILD_DIR / "libfreud_audio.so"
    if out.exists():
        return out
    if not (AUDIO_NATIVE_DIR / "decoder.cpp").exists():
        return None
    with build_lock():
        if out.exists():
            return out
        try:
            subprocess.run(
                ["make", "-C", str(BUILD_DIR), "-f",
                 str(AUDIO_NATIVE_DIR / "Makefile"),
                 # the source is found in place; the target stays local
                 f"--eval=vpath decoder.cpp {AUDIO_NATIVE_DIR}",
                 "libfreud_audio.so"],
                capture_output=True, check=True, timeout=300,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    return out if out.exists() else None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if cuda_home:
        candidates.insert(0, os.path.join(cuda_home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of freud_tpu_torch build from source at first use"
    )


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # the shared headers
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def cuda_libraries(*names: str) -> list[ctypes.CDLL]:
    """Build (once) and load ``csrc/<name>.cu`` for each name as a ctypes
    library; the missing ones compile in parallel, one nvcc each."""
    if all(n in _cuda_libs for n in names):
        return [_cuda_libs[n] for n in names]
    with build_lock():
        todo = [n for n in names if n not in _cuda_libs]
        outs = {n: _library_path(n) for n in todo}
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            if not outs[n].exists():
                tmp = outs[n].with_name(outs[n].name + f".{os.getpid()}.tmp")
                procs[n] = (tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            build_seconds[n] = time.perf_counter() - t0
            build_logs[n] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu:\n{log}")
            else:
                os.replace(tmp, outs[n])
        if failed:
            raise RuntimeError("\n".join(failed))
        for n in todo:
            _bind(n, ctypes.CDLL(str(outs[n])))
    return [_cuda_libs[n] for n in names]


def _bind(name: str, lib: ctypes.CDLL) -> None:
    """Declare ``SIGNATURES[name]`` and ``freud_cuda_error_string`` (which
    ``csrc/common.cuh`` gives every library) on ``lib``, and launch library
    ``name``'s entry points from it."""
    fns = {}
    for entry, sig in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in sig.replace(" ", "")]
        fns[entry] = fn
    fns["freud_cuda_error_string"] = lib.freud_cuda_error_string
    fns["freud_cuda_error_string"].restype = ctypes.c_char_p
    fns["freud_cuda_error_string"].argtypes = [ctypes.c_int]
    _cuda_libs[name], _entry_points[name] = lib, fns
    limit.cache_clear()


def swap_library(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Launch library ``name``'s entry points from ``lib`` (a build of a
    patched copy of its source, to time a knock-out); → the library they
    came from, to swap back."""
    old = cuda_libraries(name)[0]
    _bind(name, lib)
    return old


def check_cuda_status(status: int, what: str, error_string) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher, in the
    words of ``error_string`` (a library's ``freud_cuda_error_string``)."""
    if status != 0:
        msg = error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


@functools.cache
def limit(library: str, name: str, *args: int) -> int:
    """The value of a limit query (an entry without a stream), read from the
    library once for each ``args``."""
    cuda_libraries(library)
    return _entry_points[library][name](*args)


def count_launch(fn) -> None:
    """One launch of ``fn``'s kernel: into ``fn.captured`` while the stream
    captures a CUDA graph (each replay adds it to ``fn.launches``,
    ``train/graph.py``), else into ``fn.launches``."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


class Kernel:
    """A launcher of ``csrc/<library>.cu``, bound when its library loads.

    A call takes the prototype's parameters but the stream: tensors (their
    ``data_ptr()``), None (NULL), ints, floats and sequences of ints (as
    long long arrays). It launches on the first tensor's device and that
    device's current stream, raises with ``what`` on a nonzero status, and
    counts one launch of the wrapper that ``counted`` marked. It neither
    synchronises nor allocates on the card, so it runs under CUDA graph
    capture."""

    def __init__(self, library: str, name: str, what: str):
        sig = SIGNATURES[library][name].replace(" ", "")
        if not sig.endswith("s"):
            raise ValueError(f"{name} is a limit query, not a launcher (see limit)")
        self.library, self.name, self.what = library, name, what
        self.arity = len(sig) - 1
        self.counter = None  # the wrapper whose launches this counts

    def __call__(self, *args) -> None:
        if len(args) != self.arity:
            raise TypeError(f"{self.name} takes {self.arity} arguments and the "
                            f"stream, got {len(args)}")
        fns = _entry_points.get(self.library)
        if fns is None:
            cuda_libraries(self.library)
            fns = _entry_points[self.library]
        device = None
        c_args = []
        for a in args:
            if isinstance(a, torch.Tensor):
                device = a.device if device is None else device
                a = a.data_ptr()
            elif isinstance(a, (tuple, list)):
                a = (ctypes.c_longlong * len(a))(*a)
            c_args.append(a)
        with torch.cuda.device(device):
            status = fns[self.name](*c_args, torch.cuda.current_stream(device).cuda_stream)
        check_cuda_status(status, self.what, fns["freud_cuda_error_string"])
        if self.counter is not None:
            count_launch(self.counter)


# every wrapper ``counted`` marked, in import order
COUNTED: list = []


def counted(kernel: Kernel):
    """Decorator of a public kernel wrapper that launches ``kernel``:
    ``.launches`` counts its launches and ``.captured`` those captured into
    a CUDA graph, to which ``train/graph.py`` adds each replay's."""

    def mark(fn):
        fn.launches = fn.captured = 0
        kernel.counter = fn
        COUNTED.append(fn)
        return fn

    return mark
