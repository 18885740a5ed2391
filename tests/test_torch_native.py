"""The binding seam of freud_tpu_torch's CUDA kernels (``_native``), on the
CPU: no card and no nvcc. A signature in ``_native.SIGNATURES`` that drifts
from its ``extern "C"`` prototype in ``csrc/*.cu`` would show only on the
card, as a crash or as wrong numbers; here it fails a test."""

import contextlib
import ctypes
import importlib
import re
from types import SimpleNamespace

import pytest
import torch

from freud_tpu_torch import _native


def _kind(param: str) -> str:
    """A C parameter's kind in ``SIGNATURES``' letters."""
    if "*" in param:
        return "q" if "long long" in param else "p"
    ctype = param.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": "i", "float": "f"}[ctype]


def _prototypes() -> dict:
    """(library, entry point) → its parameters' kinds, stream as s, for
    every ``freud_*`` function in an ``extern "C"`` block of csrc/*.cu."""
    out = {}
    for src in sorted(_native.CSRC_DIR.glob("*.cu")):
        text = src.read_text()
        blocks = re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text, re.S)
        assert blocks, f"{src.name} has no extern \"C\" block"
        for block in blocks:
            for name, params in re.findall(r"^int (freud_\w+)\(([^)]*)\)", block, re.M):
                params = [" ".join(p.split()) for p in params.split(",") if p.strip()]
                kinds = "".join(_kind(p) for p in params)
                if params and params[-1] == "void* stream":
                    kinds = kinds[:-1] + "s"
                out[(src.stem, name)] = kinds
    return out


PROTOTYPES = _prototypes()


@pytest.mark.parametrize("library,name", sorted(PROTOTYPES))
def test_prototype_has_one_matching_signature(library, name):
    """Declared once, in its own library's table, with the prototype's
    count and kinds of parameters; a launcher's stream last, a limit
    query's none."""
    declared = [lib for lib, entries in _native.SIGNATURES.items() if name in entries]
    assert declared == [library]
    sig = _native.SIGNATURES[library][name].replace(" ", "")
    assert sig == PROTOTYPES[library, name]
    assert "s" not in sig[:-1]
    if not name.endswith(("_max_n", "_max_all", "_max_local")):
        assert sig.endswith("s"), f"{name} launches without a stream"
    else:
        assert "s" not in sig


def test_every_declared_entry_point_exists():
    declared = {(lib, name) for lib, entries in _native.SIGNATURES.items()
                for name in entries}
    assert declared - set(PROTOTYPES) == set()
    assert set(_native.SIGNATURES) == {src.stem for src in _native.CSRC_DIR.glob("*.cu")}


COUNTED_WRAPPERS = [
    # what a train step can launch (counted under CUDA graph replay)
    ("topk_fused", "topk_sae_forward"), ("topk_fused", "topk_sae_encode"),
    ("topk_fused", "topk_sae_decode"), ("topk_threshold", "topk_thresholds_fired"),
    ("topk_sharded", "shard_candidates"), ("topk_sharded", "combine_shard_thresholds"),
    ("topk_backward", "topk_masked_pair"), ("topk_backward", "topk_route"),
    # collection, serving and the omni model
    ("moe", "route"), ("moe", "route_topk"), ("moe", "plan"), ("moe", "permute"), ("moe", "gateup"),
    ("moe", "down"), ("moe", "combine"), ("topk_indexed", "topk_indexed"),
    ("mel", "log_mel_spectrogram_cuda"), ("attention", "fused_qkv_attention"),
    ("attention", "whisper_attention"), ("gemm_f32x3", "gemm_f32x3"),
]


@pytest.mark.parametrize("module,name", COUNTED_WRAPPERS)
def test_wrapper_is_counted(module, name):
    """Registered for graph counting, with the counters, and the counter of
    exactly one launcher of its module."""
    mod = importlib.import_module(f"freud_tpu_torch.ops.{module}")
    fn = getattr(mod, name)
    assert fn in _native.COUNTED
    assert isinstance(fn.launches, int) and isinstance(fn.captured, int)
    kernels = [k for k in vars(mod).values()
               if isinstance(k, _native.Kernel) and k.counter is fn]
    assert len(kernels) == 1
    assert kernels[0].library == module


def test_every_launcher_has_a_counted_wrapper():
    for module in _native.SIGNATURES:
        importlib.import_module(f"freud_tpu_torch.ops.{module}")
    launchers = {(lib, name) for lib, entries in _native.SIGNATURES.items()
                 for name, sig in entries.items() if sig.endswith("s")}
    wrapped = {(k.library, k.name) for fn in _native.COUNTED
               for k in vars(importlib.import_module(fn.__module__)).values()
               if isinstance(k, _native.Kernel) and k.counter is fn}
    assert wrapped == launchers


@pytest.fixture
def fake_library(monkeypatch):
    """A stand-in for a loaded library: its launcher records what it was
    passed and returns ``status``; the card's device, its stream and
    whether that stream captures (``capturing``) are faked."""
    calls, status, capturing = [], [0], [False]

    def launcher(*args):
        calls.append(args)
        return status[0]

    monkeypatch.setitem(_native._entry_points, "fake", {
        "freud_fake": launcher, "freud_fake_max_n": lambda: calls.append("max_n") or 77,
        "freud_cuda_error_string": lambda s: b"an error string"})
    monkeypatch.setitem(_native._cuda_libs, "fake", None)  # loaded: nothing to build
    monkeypatch.setitem(_native.SIGNATURES, "fake", {"freud_fake": "p i q f p s",
                                                     "freud_fake_max_n": ""})
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0x5EED))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    return calls, status, capturing


def test_kernel_launch_passes_pointers_and_the_stream_and_counts(fake_library):
    calls, _, capturing = fake_library
    kernel = _native.Kernel("fake", "freud_fake", "fake kernel")

    def wrapper():
        pass

    _native.counted(kernel)(wrapper)
    try:
        x = torch.zeros(4)
        kernel(x, 3, (1, 2, 3), 0.5, None)
        (args,) = calls
        assert args[0] == x.data_ptr() and args[1] == 3 and args[3] == 0.5
        assert args[4] is None and args[5] == 0x5EED
        assert isinstance(args[2], ctypes.Array) and list(args[2]) == [1, 2, 3]
        assert (wrapper.launches, wrapper.captured) == (1, 0)
        with pytest.raises(TypeError, match="freud_fake takes 5 arguments"):
            kernel(x, 3)
        assert len(calls) == 1 and wrapper.launches == 1
        capturing[0] = True  # a launch into a CUDA graph: counted on replay
        kernel(x, 3, [4], 0.5, x)
        assert (wrapper.launches, wrapper.captured) == (1, 1)
    finally:
        _native.COUNTED.remove(wrapper)


def test_kernel_raises_in_the_wrappers_words(fake_library):
    _, status, _ = fake_library
    status[0] = 700
    kernel = _native.Kernel("fake", "freud_fake", "fake kernel")
    with pytest.raises(RuntimeError, match=r"fake kernel: CUDA error 700 \(an error string\)"):
        kernel(torch.zeros(1), 0, (), 0.0, None)
    with pytest.raises(ValueError, match="limit query"):
        _native.Kernel("fake", "freud_fake_max_n", "fake limit")


def test_limit_is_read_once(fake_library):
    calls, _, _ = fake_library
    try:
        assert [_native.limit("fake", "freud_fake_max_n") for _ in range(3)] == [77] * 3
        assert calls == ["max_n"]
    finally:
        _native.limit.cache_clear()
