"""Activation search: freud_tpu_torch's ``top_activations`` against
freud_tpu's on the same stores and audio.

Store-backed search (dense f32, dense f16 and indexed stores, scan and
feature-major fast path, plain and abs-magnitude ranking, min/max filters,
traces trimmed to ``n_frames`` including a file with 0 frames) must give
the same filenames in the same order and bit-equal values, times, traces
and per-file maxima: the values are the store's own, so the masked maxima
are exact. The fly loader at tiny width (weights both packages load from
one ``tiny.pt``) agrees within 1e-4 of the largest |value| (f32 on the
CPU, only summation order differs). Bad loaders and indices raise."""

import json
import wave

import jax
import numpy as np
import pytest
import torch

from freud_tpu.analysis.search import top_activations as jax_top
from freud_tpu.audio import decode as jdecode
from freud_tpu.data.loaders import FlyActivationLoader as JaxFly
from freud_tpu.data.loaders import MemoryMappedActivationLoader as JaxLoader
from freud_tpu.models.whisper.config import WhisperDims as JaxDims
from freud_tpu.models.whisper.model import init_params
from freud_tpu_torch.analysis.search import top_activations
from freud_tpu_torch.audio import decode as tdecode
from freud_tpu_torch.data import feature_store as tfs
from freud_tpu_torch.data.loaders import FlyActivationLoader, MemoryMappedActivationLoader
from freud_tpu_torch.data.store import ActivationStoreWriter
from freud_tpu_torch.models.whisper import WhisperDims, state_dict_from_jax
from tests.test_torch_feature_store import KINDS, LAYER, build, write_store

FLY_TOL = 1e-4  # fly-mode values and traces, relative to the largest |value|
DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=1)
QUERIES = [
    dict(),
    dict(absolute_magnitude=True),
    dict(min_val=0.5, max_val=1.8),
    dict(absolute_magnitude=True, min_val=-1.0, max_val=1.0),
    dict(return_max_per_file=False),
]


def _same(got, want):
    """Equal filenames and order, bit-equal values, times and traces."""
    assert [(f, v, t) for f, _, v, t in got[0]] == [(f, v, t) for f, _, v, t in want[0]]
    for (_, a, _, _), (_, b, _, _) in zip(got[0], want[0]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    if want[1] is None:
        assert got[1] is None
    else:
        assert got[1] == [float(v) for v in want[1]]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("indexed_plane", [False, True], ids=["scan", "fast"])
def test_store_search_matches_jax(tmp_path, kind, indexed_plane):
    """11 files at batch 4 (a ragged tail chunk), every feature, every
    query form, n_frames from 0 to T."""
    write_store(tmp_path, kind, 11, seed=1)
    if indexed_plane:
        build(tfs, tmp_path, kind)
    loader = MemoryMappedActivationLoader(str(tmp_path), LAYER, batch_size=4)
    jloader = JaxLoader(str(tmp_path), LAYER, batch_size=4)
    assert loader.reader.n_frames[1] == 0
    for feat in range(loader.activation_shape[-1]):
        for q in QUERIES:
            got = top_activations(loader, feat, 4, device="cpu", **q)
            _same(got, jax_top(jloader, feat, 4, **q))
            assert all(len(tr) == n for (_, tr, _, _), n in zip(
                got[0], [loader.reader.n_frames[loader.reader.filenames.index(f)]
                         for f, _, _, _ in got[0]]))


def test_store_without_n_frames_reads_audio_headers(tmp_path):
    """A store whose metadata has no n_frames trims each trace to the
    duration its audio header gives (``audio_duration_s``, equal in both
    packages), and a missing file to the full 1500 frames."""
    audio = tmp_path / "audio"
    audio.mkdir()
    names = []
    for i, secs in enumerate((0.5, 1.3, 0.02)):
        path = audio / f"c{i}.wav"
        _write_wav(path, secs, i)
        names.append(str(path))
        assert tdecode.audio_duration_s(str(path)) == jdecode.audio_duration_s(str(path))
    names.append(str(audio / "missing.wav"))
    rng = np.random.default_rng(0)
    w = ActivationStoreWriter(tmp_path / "s", LAYER, (1500, 3), (1500, 3))
    w.append_batch(names, rng.standard_normal((4, 1500, 3)).astype(np.float32))
    w.close()
    loader = MemoryMappedActivationLoader(str(tmp_path / "s"), LAYER, batch_size=3)
    assert loader.reader.n_frames is None
    got = top_activations(loader, 2, 4, device="cpu")
    _same(got, jax_top(JaxLoader(str(tmp_path / "s"), LAYER, batch_size=3), 2, 4))
    assert sorted(len(tr) for _, tr, _, _ in got[0]) == [1, 25, 65, 1500]


def test_bad_requests_raise(tmp_path):
    write_store(tmp_path, "dense_f32", 5, seed=0)
    loader = MemoryMappedActivationLoader(str(tmp_path), LAYER, batch_size=2)
    for feat in (-1, loader.activation_shape[-1]):
        with pytest.raises(ValueError, match="out of range"):
            top_activations(loader, feat, 2, device="cpu")
    shuffled = MemoryMappedActivationLoader(str(tmp_path), LAYER, batch_size=2, shuffle=True)
    with pytest.raises(ValueError, match="unshuffled"):
        top_activations(shuffled, 0, 2, device="cpu")
    tail = MemoryMappedActivationLoader(str(tmp_path), LAYER, batch_size=2, drop_last=True)
    with pytest.raises(ValueError, match="drop_last"):
        top_activations(tail, 0, 2, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        top_activations(loader, 0, 2, mesh=object(), device="cpu")
    # a one-process mesh is the one-rank search, bit for bit (the ranks'
    # split is test_torch_distributed.py's)
    from freud_tpu_torch.parallel.mesh import Mesh

    _same(top_activations(loader, 1, 3, mesh=Mesh("cpu")),
          top_activations(loader, 1, 3, device="cpu"))


def _write_wav(path, seconds, seed):
    audio = (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def fly_env(tmp_path_factory):
    """A ``tiny.pt`` of narrow dims both packages load, and 5 short WAVs."""
    root = tmp_path_factory.mktemp("fly_search")
    wdir = root / "whisper"
    wdir.mkdir()
    np_params = jax.tree_util.tree_map(np.asarray, init_params(JaxDims(**DIMS), seed=2))
    torch.save({"dims": dict(DIMS),
                "model_state_dict": state_dict_from_jax(np_params, WhisperDims(**DIMS))},
               wdir / "tiny.pt")
    audio = root / "audio"
    audio.mkdir()
    for i, secs in enumerate((2.0, 0.7, 1.3, 0.4, 1.0)):
        _write_wav(audio / f"clip{i}.wav", secs, i)
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))
    yield audio
    mp.undo()


def test_fly_search_matches_jax(fly_env):
    """Fly mode at batch 2 (a ragged tail): the port keeps each batch's
    activations on its device; files and order equal JAX's, values, traces
    and per-file maxima within FLY_TOL of the largest |value|."""
    audio = str(fly_env)
    loader = FlyActivationLoader(audio, "tiny", None, "encoder.blocks.1", 2, device="cpu")
    jloader = JaxFly(audio, "tiny", None, "encoder.blocks.1", 2)
    for feat, q in ((3, {}), (17, dict(absolute_magnitude=True)), (40, dict(min_val=0.0))):
        got = top_activations(loader, feat, 3, **q)
        want = jax_top(jloader, feat, 3, **q)
        scale = max(abs(v) for v in want[1])
        assert [f for f, *_ in got[0]] == [f for f, *_ in want[0]]
        for (_, a, va, ta), (_, b, vb, tb) in zip(got[0], want[0]):
            assert a.shape == b.shape and ta == tb
            assert abs(va - vb) <= FLY_TOL * scale
            assert np.abs(a - np.asarray(b)).max() <= FLY_TOL * scale
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=FLY_TOL * scale)
    lens = sorted(len(tr) for _, tr, _, _ in top_activations(loader, 0, 5)[0])
    assert lens == [20, 35, 50, 65, 100]  # each clip's frames, from its decode
    bad = FlyActivationLoader(audio, "tiny", None, "encoder.blocks.1", 2, drop_last=True, device="cpu")
    with pytest.raises(ValueError, match="drop_last"):
        top_activations(bad, 0, 2)
    with pytest.raises(ValueError, match="out of range"):
        top_activations(loader, 64, 2)
    assert json.dumps(got[1])  # plain Python floats
