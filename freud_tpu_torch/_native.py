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
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
CSRC_DIR = PACKAGE_DIR / "csrc"
AUDIO_NATIVE_DIR = PACKAGE_DIR / "audio" / "native"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_thread_lock = threading.Lock()
_cuda_libs: dict[str, ctypes.CDLL] = {}
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
            _cuda_libs[n] = ctypes.CDLL(str(outs[n]))
    return [_cuda_libs[n] for n in names]


def cuda_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu`` as a ctypes library."""
    return cuda_libraries(name)[0]


def check_cuda_status(status: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher (each
    kernel library exports ``freud_cuda_error_string``)."""
    if status != 0:
        msg = lib.freud_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
