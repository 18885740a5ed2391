"""freud_tpu_torch host layer against freud_tpu: constants, filterbank,
decode, prefetch and the activation store (byte-identical files), plus the
import rule — the port never imports jax or freud_tpu."""

import ast
import json
import wave
from pathlib import Path

import numpy as np
import pytest

from freud_tpu import constants as jconst
from freud_tpu.audio import decode as jdecode
from freud_tpu.audio.filters import mel_filterbank as jax_filterbank
from freud_tpu.data.store import ActivationStoreWriter as JaxWriter
from freud_tpu_torch import constants as tconst
from freud_tpu_torch.audio import decode as tdecode
from freud_tpu_torch.audio.filters import mel_filterbank as torch_filterbank
from freud_tpu_torch.data.prefetch import prefetch_iter
from freud_tpu_torch.data.store import ActivationStoreReader
from freud_tpu_torch.data.store import ActivationStoreWriter as TorchWriter

PORT_DIR = Path(__file__).resolve().parent.parent / "freud_tpu_torch"


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
    for name in ("tiny", "large-v3"):
        assert tconst.get_n_mels(name) == jconst.get_n_mels(name)
    assert tconst.is_audio_file("A.WAV") and not tconst.is_audio_file("a.txt")


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_equal(n_mels):
    np.testing.assert_array_equal(torch_filterbank(n_mels), jax_filterbank(n_mels))


def _write_store(writer_cls, folder, store_dtype, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    w = writer_cls(folder, "encoder.blocks.2", tensor_shape=(5, 3),
                   activation_shape=(5, 3), store_dtype=store_dtype)
    w.append_batch(["a.wav", "b.wav"],
                   rng.standard_normal((2, 5, 3)).astype(np.float32),
                   n_frames=[5, 2])
    w.flush()
    w.append_batch(["c.wav"], rng.standard_normal((1, 5, 3)).astype(np.float32),
                   n_frames=[4])
    w.close()


@pytest.mark.parametrize("store_dtype", [np.float32, np.float16])
def test_store_writer_byte_identical(tmp_path, store_dtype):
    _write_store(JaxWriter, tmp_path / "jax", store_dtype)
    _write_store(TorchWriter, tmp_path / "torch", store_dtype)
    for name in ("encoder.blocks.2_tensors.npy", "encoder.blocks.2_metadata.json"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "torch" / name).read_bytes(), name
    r = ActivationStoreReader(tmp_path / "torch", "encoder.blocks.2")
    assert len(r) == 3 and r.n_frames == [5, 2, 4]
    assert r.batch(np.array([0, 2]))[0].shape == (2, 5, 3)


def test_store_writer_resume_matches(tmp_path):
    """Append mode resumes the existing store the same way in both."""
    for cls, sub in ((JaxWriter, "jax"), (TorchWriter, "torch")):
        _write_store(cls, tmp_path / sub, np.float32)
        w = cls(tmp_path / sub, "encoder.blocks.2", (5, 3), (5, 3), overwrite=False)
        w.append_batch(["d.wav"], np.ones((1, 5, 3), np.float32), n_frames=[1])
        w.close()
    for name in ("encoder.blocks.2_tensors.npy", "encoder.blocks.2_metadata.json"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "torch" / name).read_bytes(), name
    meta = json.loads((tmp_path / "torch" / "encoder.blocks.2_metadata.json").read_text())
    assert meta["filenames"] == ["a.wav", "b.wav", "c.wav", "d.wav"]


def _write_wav(path, seconds, seed):
    audio = (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


def test_wave_fallback_batch_decode_matches(tmp_path, monkeypatch):
    """Without the native library both packages decode WAVs through stdlib
    ``wave`` to the same buffer; a broken file is marked -1 in both."""
    files = []
    for i, secs in enumerate((0.5, 1.25)):
        p = tmp_path / f"c{i}.wav"
        _write_wav(p, secs, i)
        files.append(str(p))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    files.append(str(bad))
    monkeypatch.setenv("FREUD_DISABLE_NATIVE_AUDIO", "1")
    monkeypatch.setenv("PATH", "")  # no ffmpeg CLI either
    for mod in (jdecode, tdecode):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_checked", False)
    want, wlen = jdecode.load_audio_batch(files, frame_len=32000)
    got, glen = tdecode.load_audio_batch(files, frame_len=32000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(glen, wlen)
    assert list(glen) == [8000, 20000, -1]
    # decoding into a caller's buffer zeroes it first
    out = np.full((3, 32000), 7.0, np.float32)
    tdecode.load_audio_batch(files, frame_len=32000, out=out)
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError):
        tdecode.load_audio_batch(files, frame_len=32000,
                                 out=np.zeros((2, 32000), np.float32))


def test_prefetch_forwards_errors():
    def gen():
        yield 1
        raise KeyError("boom")

    it = prefetch_iter(gen(), 2)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    assert list(prefetch_iter(range(5), 0)) == list(range(5))


def _imports(tree: ast.AST, module_parts: list[str]) -> list[str]:
    """Absolute names of every import in a module of the package."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = module_parts[: len(module_parts) - node.level]
                names.append(".".join(base + ([node.module] if node.module else [])))
            else:
                names.append(node.module)
    return names


def test_profiler_trace_helpers(tmp_path):
    """``trace``/``start_trace``/``stop_trace`` keep JAX's signatures; a
    None logdir is a no-op, a folder receives a torch.profiler trace."""
    import inspect

    import torch

    from freud_tpu import profiling as jprof
    from freud_tpu_torch import profiling as tprof

    for name in ("trace", "start_trace", "stop_trace"):
        assert str(inspect.signature(getattr(tprof, name))) == \
            str(inspect.signature(getattr(jprof, name))), name
    with tprof.trace(None):
        pass
    assert tprof._trace is None
    with tprof.trace(str(tmp_path / "tb")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert tprof._trace is None
    assert list((tmp_path / "tb").glob("*.pt.trace.json"))
    tprof.start_trace(str(tmp_path / "tb2"))
    tprof.stop_trace()
    assert list((tmp_path / "tb2").glob("*.pt.trace.json"))
    with pytest.raises(RuntimeError, match="start_trace"):
        tprof.stop_trace()


def test_port_never_imports_jax_or_freud_tpu():
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        rel = f.relative_to(PORT_DIR.parent).with_suffix("")
        parts = list(rel.parts)
        for name in _imports(ast.parse(f.read_text()), parts):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "freud_tpu"), (f, name)
    # chip_smoke.py drives the port on the card and must not pull in JAX
    smoke = PORT_DIR.parent / "chip_smoke.py"
    for name in _imports(ast.parse(smoke.read_text()), ["chip_smoke"]):
        assert name.split(".")[0] not in ("jax", "jaxlib", "freud_tpu"), name


def test_port_package_data_patterns_match():
    """pyproject ships the CUDA and decoder sources the port builds from,
    the server's static page, and the port's copies of the bundled assets
    (the polysemanticity CSV and the example FLAC)."""
    import tomllib

    cfg = tomllib.loads((PORT_DIR.parent / "pyproject.toml").read_text())
    setuptools_cfg = cfg["tool"]["setuptools"]
    assert "freud_tpu*" in setuptools_cfg["packages"]["find"]["include"]
    patterns = setuptools_cfg["package-data"]["freud_tpu_torch"]
    assert sorted(patterns) == ["assets/*", "audio/native/Makefile",
                                "audio/native/decoder.cpp", "csrc/*.cu", "csrc/*.cuh",
                                "server/static/*"]
    shipped = {p.name for pat in patterns for p in PORT_DIR.glob(pat)}
    assert {"mel.cu", "attention.cu", "common.cuh", "hopper.cuh", "Makefile",
            "decoder.cpp", "index.html", "polyesemantic_count.csv",
            "example_audio.flac"} <= shipped


def test_decoder_builds_from_the_ports_copy(tmp_path, monkeypatch):
    """The port keeps its own copy of the decoder source, byte-identical to
    the JAX package's, and builds the library from it alone."""
    from freud_tpu_torch import _native

    jax_dir = PORT_DIR.parent / "freud_tpu" / "audio" / "native"
    assert _native.AUDIO_NATIVE_DIR == PORT_DIR / "audio" / "native"
    for name in ("decoder.cpp", "Makefile"):
        assert (_native.AUDIO_NATIVE_DIR / name).read_bytes() == \
            (jax_dir / name).read_bytes(), name
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "AUDIO_NATIVE_DIR", tmp_path / "nowhere")
    assert _native.build_audio_decoder() is None  # no source, no library
    monkeypatch.setattr(_native, "AUDIO_NATIVE_DIR", PORT_DIR / "audio" / "native")
    built = _native.build_audio_decoder()
    assert built == tmp_path / "build" / "libfreud_audio.so" and built.stat().st_size > 0



def _index_layouts(root: Path, layer: str):
    """Folders of index files: none; the dense base; a dense growth segment
    without its base; one complete sparse group; a sparse group missing a
    part; two sparse groups; both kinds; another layer's index."""
    from freud_tpu.data import feature_store as fs

    def touch(folder, names):
        folder.mkdir()
        for name in names:
            (folder / name).write_bytes(b"")
        return folder

    sparse = [f"{layer}_feature_major.sparse{{k}}.{p}.npy" for p in fs.SPARSE_PARTS]
    group = lambda k: [n.format(k=k) for n in sparse]  # noqa: E731
    return [
        touch(root / "none", []),
        touch(root / "dense", [f"{layer}_feature_major.npy"]),
        touch(root / "segment_only", [f"{layer}_feature_major.seg1.npy"]),
        touch(root / "sparse", group(0)),
        touch(root / "sparse_partial", group(0)[:-1]),
        touch(root / "sparse_two", group(0) + group(1)),
        touch(root / "gap", group(1)),
        touch(root / "both", [f"{layer}_feature_major.npy"] + group(0)),
        touch(root / "other_layer", ["encoder.blocks.9_feature_major.npy"]),
    ]


def test_feature_index_checks_equal_feature_store(tmp_path):
    """The port's feature_store finds the index files freud_tpu's does on
    every folder layout: the same paths, segments and groups."""
    from freud_tpu.data import feature_store as fs
    from freud_tpu_torch.data import feature_store as tfs

    layer = "encoder.blocks.2"
    assert tfs.SPARSE_PARTS == fs.SPARSE_PARTS
    for folder in _index_layouts(tmp_path, layer):
        assert tfs.index_path(folder, layer) == fs.index_path(folder, layer)
        assert tfs.segment_paths(folder, layer) == fs.segment_paths(folder, layer)
        assert tfs.sparse_segment_groups(folder, layer) == fs.sparse_segment_groups(folder, layer)
        assert tfs.FeatureMajorReader.exists(folder, layer) == \
            fs.FeatureMajorReader.exists(folder, layer), folder.name
        assert tfs.SparseFeatureMajorReader.exists(folder, layer) == \
            fs.SparseFeatureMajorReader.exists(folder, layer), folder.name


# -------------------------------------------- framework-free copies


@pytest.mark.parametrize("rel", ["models/whisper/timing.py", "models/whisper/writers.py",
                                 "analysis/wer.py"])
def test_framework_free_copies_byte_identical(rel):
    """The port keeps its own copies of the JAX package's numpy-only
    modules: word timing (DTW, alignment heads), the subtitle writers and
    the word error rate, byte-identical to their originals."""
    assert (PORT_DIR / rel).read_bytes() == \
        (PORT_DIR.parent / "freud_tpu" / rel).read_bytes(), rel


def test_alignment_heads_search_the_port_assets(tmp_path, monkeypatch):
    """``load_alignment_heads`` reads ``alignment_heads.json`` from
    $FREUD_WHISPER_DIR, then $FREUD_TOKENIZER_DIR, then the port's own
    ``models/whisper/assets``; without a table ``random:``/``test:`` models
    take the upper half of the decoder layers, as JAX's copy does."""
    from freud_tpu.models.whisper import timing as jt
    from freud_tpu_torch.models.whisper import timing as tt

    monkeypatch.delenv("FREUD_WHISPER_DIR", raising=False)
    monkeypatch.delenv("FREUD_TOKENIZER_DIR", raising=False)
    for name in ("random:tiny", "test:large-v3", "tiny"):
        assert tt.load_alignment_heads(name, 4, 6) == jt.load_alignment_heads(name, 4, 6) \
            == [(l, h) for l in (2, 3) for h in range(6)]
    read = []
    real_exists = Path.exists

    def spy(self):
        if self.name == "alignment_heads.json":
            read.append(self.parent)
        return real_exists(self)

    monkeypatch.setattr(Path, "exists", spy)
    (tmp_path / "w").mkdir()
    (tmp_path / "t").mkdir()
    (tmp_path / "t" / "alignment_heads.json").write_text(json.dumps({"tiny": [[0, 1]]}))
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(tmp_path / "w"))
    monkeypatch.setenv("FREUD_TOKENIZER_DIR", str(tmp_path / "t"))
    assert tt.load_alignment_heads("random:tiny", 4, 6) == [(0, 1)]
    assert read == [tmp_path / "w", tmp_path / "t"]
    read.clear()
    monkeypatch.delenv("FREUD_TOKENIZER_DIR")
    tt.load_alignment_heads("tiny", 4, 6)
    assert read == [tmp_path / "w", PORT_DIR / "models" / "whisper" / "assets"]


# ------------------------------------------------------------- tokenizer


def _synthetic_ranks(folder: Path) -> None:
    """A tiny multilingual tiktoken table: the 256 single bytes plus a few
    merges (tests/test_suppression.py's table)."""
    import base64

    merges = [b" -", b" '", b"((", b"<<", b"\xe2\x99", b"\xe2\x99\xaa", b" (", b"  ",
              b"he", b"hel", b"hell", b"hello", b" w", b" wo"]
    lines = [base64.b64encode(bytes([b])) + b" " + str(b).encode() for b in range(256)]
    lines += [base64.b64encode(m) + b" " + str(256 + i).encode()
              for i, m in enumerate(merges)]
    (folder / "multilingual.tiktoken").write_bytes(b"\n".join(lines))


@pytest.mark.parametrize("assets", [False, True], ids=["no-assets", "synthetic-ranks"])
def test_tokenizer_equals_jax(tmp_path, monkeypatch, assets):
    """The port's tokenizer copy answers as freud_tpu's: the special-token
    layout of every vocabulary, language indices, and (without and with a
    rank table) text rendering, pieces, BPE encoding and the suppression
    lists."""
    from freud_tpu.models.whisper import tokenizer as jt
    from freud_tpu_torch.models.whisper import tokenizer as tt

    monkeypatch.setenv("FREUD_TOKENIZER_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # no user cache
    if assets:
        _synthetic_ranks(tmp_path)
    for mod in (jt, tt):
        mod.clear_asset_caches()
    try:
        assert tt.LANGUAGES == jt.LANGUAGES
        for n_vocab in (51864, 51865, 51866):
            assert tt.special_tokens(n_vocab).__dict__ == jt.special_tokens(n_vocab).__dict__
            st = tt.special_tokens(n_vocab)
            for flags in ((0, False, True), (3, True, True), (5, False, False)):
                assert st.sot_sequence(*flags) == jt.special_tokens(n_vocab).sot_sequence(*flags)
        for code in ("en", "de", "yue"):
            for n_vocab in (51865, 51866):
                try:
                    want = jt.language_index(code, n_vocab)
                except ValueError:
                    with pytest.raises(ValueError):
                        tt.language_index(code, n_vocab)
                else:
                    assert tt.language_index(code, n_vocab) == want
        with pytest.raises(ValueError):
            tt.special_tokens(1000)
        tokens = [104, 101, 108, 108, 111, 32, 119, 259, 50257, 50364, 300, 2]
        for n_vocab in (51865, 51866):
            assert tt.decode_text(tokens, n_vocab) == jt.decode_text(tokens, n_vocab)
            assert tt.token_pieces(tokens, n_vocab) == jt.token_pieces(tokens, n_vocab)
            assert tt.tokenizer_available(n_vocab) == jt.tokenizer_available(n_vocab) == assets
            assert tt.encode_text("hello world ((x", n_vocab) == \
                jt.encode_text("hello world ((x", n_vocab)
            assert tt.suppress_token_ids(n_vocab) == jt.suppress_token_ids(n_vocab)
            assert tt.non_speech_token_ids(n_vocab) == jt.non_speech_token_ids(n_vocab)
            assert tt.blank_token_id(n_vocab) == jt.blank_token_id(n_vocab)
        if assets:
            assert tt.decode_text(tokens, 51865).startswith("hello w")
        else:
            assert tt.decode_text(tokens, 51865).startswith("<tok:104>")
    finally:
        for mod in (jt, tt):
            mod.clear_asset_caches()
