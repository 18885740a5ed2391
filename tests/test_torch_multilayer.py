"""freud_tpu_torch's multi-layer collection against freud_tpu's: both
collection CLIs run one config (a list of three capture points, three WAVs
and an undecodable one at batch 2, ``build_index``) with the same Whisper
weights (an OpenAI-layout ``.pt`` of narrow dims written through
``state_dict_from_jax``). Each layer's metadata JSON is identical, its store
within 1e-4 of max of JAX's (f32 on the CPU; only summation order differs)
and equal to the port's single-layer collection of that layer; the indexes
built at the end equal byte for byte the ones JAX builds over the port's
stores. The refusals keep JAX's meaning, and a batch whose
files all fail to decode is skipped where JAX's store writer raises."""

import json
import shutil
import wave

import jax
import numpy as np
import pytest
import torch

from freud_tpu.data import feature_store as jfs
from freud_tpu.data.multilayer import collect_multilayer as jax_collect_multilayer
from freud_tpu.models.whisper.config import WhisperDims as JaxDims
from freud_tpu.models.whisper.model import init_params
from freud_tpu.scripts import collect_activations as jcollect
from freud_tpu_torch.data.multilayer import (
    MultiLayerActivationLoader,
    collect_multilayer,
)
from freud_tpu_torch.models.whisper import WhisperDims, state_dict_from_jax
from freud_tpu_torch.scripts import collect_activations as tcollect

LAYERS = ["encoder.blocks.0", "encoder.blocks.1", "encoder.blocks.1.mlp.1"]
DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=1)


def _write_wav(path, seconds, seed):
    audio = (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("multilayer")
    wdir = root / "whisper"
    wdir.mkdir()
    np_params = jax.tree_util.tree_map(
        np.asarray, init_params(JaxDims(**DIMS), seed=3))
    sd = state_dict_from_jax(np_params, WhisperDims(**DIMS))
    torch.save({"dims": dict(DIMS), "model_state_dict": sd}, wdir / "tiny.pt")
    audio = root / "audio"
    audio.mkdir()
    for i, secs in enumerate((2.0, 0.7, 1.3)):
        _write_wav(audio / f"clip{i}.wav", secs, i)
    # sorts last: the second batch is clip2 and the broken file
    (audio / "clip_broken.wav").write_bytes(b"RIFF, but not a wav file")
    return root, wdir, audio


def _read(folder, layer):
    meta = (folder / f"{layer}_metadata.json").read_text()
    return meta, np.load(folder / f"{layer}_tensors.npy")


def _config(audio, out, **over):
    return {"whisper_model": "tiny", "layer_name": LAYERS, "batch_size": 2,
            "data_path": str(audio), "device": "cpu", "out_folder": str(out),
            "build_index": True, **over}


def _run_cli(module, cfg, path):
    path.write_text(json.dumps(cfg))
    module.main(["--config", str(path)])


def test_multilayer_cli_matches_jax_and_single_layer(setup, monkeypatch, capsys):
    root, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    # one config, both CLIs (JAX's list branch takes no "device")
    _run_cli(jcollect, _config(audio, root / "jax"), root / "jax.json")
    _run_cli(tcollect, _config(audio, root / "torch"), root / "torch.json")
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats == {"n_files": 3, "layers": LAYERS}
    for layer in LAYERS:
        jmeta, jrows = _read(root / "jax", layer)
        tmeta, trows = _read(root / "torch", layer)
        assert tmeta == jmeta, layer
        meta = json.loads(tmeta)
        width = 4 * 64 if layer.endswith("mlp.1") else 64
        assert meta["tensor_shape"] == [1500, width]
        assert meta["n_frames"] == [100, 35, 65]
        assert meta["filenames"] == [str(audio / f"clip{i}.wav") for i in range(3)]
        assert trows.shape == jrows.shape == (3, 1500 * width)
        assert np.max(np.abs(trows - jrows)) / np.max(np.abs(jrows)) < 1e-4, layer
        # the index the port's collection built equals, byte for byte, the
        # one JAX builds over the port's store; JAX's collection built the
        # same files over its own
        jfiles = sorted(p.name for p in (root / "jax").glob(f"{layer}_feature_major*"))
        tfiles = sorted(p.name for p in (root / "torch").glob(f"{layer}_feature_major*"))
        assert jfiles and tfiles == jfiles
        copy = root / "reindexed" / layer
        copy.mkdir(parents=True)
        for suffix in ("_metadata.json", "_tensors.npy"):
            shutil.copy(root / "torch" / f"{layer}{suffix}", copy)
        jfs.extend_feature_major_index(str(copy), layer, verbose=False)
        for name in tfiles:
            assert (root / "torch" / name).read_bytes() == (copy / name).read_bytes(), name
    # each layer equals the port's single-layer collection of that layer
    for layer in LAYERS:
        tcollect.get_activations(
            data_path=str(audio), layer_name=layer, whisper_model="tiny",
            sae_model=None, batch_size=2, out_folder=str(root / "single"),
            verbose=False, device="cpu")
        smeta, srows = _read(root / "single", layer)
        tmeta, trows = _read(root / "torch", layer)
        assert smeta == tmeta
        np.testing.assert_array_equal(trows, srows)


def test_loader_yields_every_layer_one_pass(setup, monkeypatch):
    """The loader stops the encoder after the deepest captured block and
    yields every layer for the decodable files of each batch."""
    _, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    loader = MultiLayerActivationLoader(str(audio), "tiny", ["encoder.blocks.0"], 2,
                                        device="cpu")
    calls = []
    block1 = loader.runtime.encoder.blocks[1]
    block1.register_forward_hook(lambda *a: calls.append(1))
    batches = list(loader)
    assert not calls  # block 1 never ran for a block-0 capture
    assert [names for _, names, _ in batches] == [
        [str(audio / "clip0.wav"), str(audio / "clip1.wav")], [str(audio / "clip2.wav")]]
    assert [list(n) for _, _, n in batches] == [[100, 35], [65]]
    assert all(c["encoder.blocks.0"].shape == (len(n), 1500, 64) for c, n, _ in batches)


def test_multilayer_refusals(setup, tmp_path):
    _, _, audio = setup
    cfg_path = tmp_path / "cfg.json"
    with pytest.raises(ValueError, match="decoder layers"):
        MultiLayerActivationLoader(str(audio), "random:tiny",
                                   ["encoder.blocks.0", "decoder.blocks.0"], 2,
                                   device="cpu")
    for over in ({"sae_model": "x.pth"}, {"resume": True}):
        for module in (jcollect, tcollect):  # the same refusal in both
            with pytest.raises(SystemExit):
                _run_cli(module, _config(audio, tmp_path / "out", **over), cfg_path)
    cfg_path.write_text(json.dumps(_config(audio, tmp_path / "out")))
    with pytest.raises(SystemExit):
        tcollect.main(["--config", str(cfg_path), "--resume"])
    # data_parallel without a process group: the one-card collection into
    # the folder itself (the ranks' shards are test_torch_distributed.py's)
    collect_multilayer(str(audio), LAYERS[:1], "random:tiny", 2, str(tmp_path / "o"),
                       data_parallel=True, device="cpu", verbose=False)
    assert (tmp_path / "o" / f"{LAYERS[0]}_tensors.npy").exists()
    assert not list((tmp_path / "o").glob("shard*"))
    with pytest.raises(TypeError, match="Mesh"):
        MultiLayerActivationLoader(str(audio), "random:tiny", LAYERS, 2,
                                   device="cpu", mesh=object())
    # shard=(i, n): every n-th file from i, as JAX's pipeline keeps
    files = [MultiLayerActivationLoader(str(audio), "random:tiny", LAYERS, 2, device="cpu",
                                        shard=(i, 2)).pipeline.files for i in (0, 1)]
    full = MultiLayerActivationLoader(str(audio), "random:tiny", LAYERS, 2,
                                      device="cpu").pipeline.files
    assert files == [full[0::2], full[1::2]]
    with pytest.raises(ValueError, match="bad shard"):
        MultiLayerActivationLoader(str(audio), "random:tiny", LAYERS, 2, device="cpu",
                                   shard=(2, 2))
    assert not (tmp_path / "out").exists()


def test_all_undecodable_batch_is_skipped(setup, tmp_path, monkeypatch):
    """Two good WAVs and a broken one at batch 2: the second batch is the
    broken file alone. The port skips it and writes what JAX writes for the
    two good files alone; JAX's collection over the same folder raises on
    the zero-row batch (its store writer reshapes it), a known divergence
    (ROADMAP Queue 3)."""
    _, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    folder = tmp_path / "mixed"
    folder.mkdir()
    for name, src in (("a.wav", "clip0.wav"), ("b.wav", "clip1.wav")):
        (folder / name).write_bytes((audio / src).read_bytes())
    layers = LAYERS[:2]
    jax_collect_multilayer(str(folder), layers, "tiny", 2, str(tmp_path / "jax"),
                           verbose=False)
    (folder / "c.wav").write_bytes(b"RIFF, but not a wav file")
    stats = collect_multilayer(str(folder), layers, "tiny", 2, str(tmp_path / "torch"),
                               verbose=False, device="cpu")
    assert stats["n_files"] == 2
    for layer in layers:
        jmeta, jrows = _read(tmp_path / "jax", layer)
        tmeta, trows = _read(tmp_path / "torch", layer)
        assert tmeta == jmeta
        assert np.max(np.abs(trows - jrows)) / np.max(np.abs(jrows)) < 1e-4
    with pytest.raises(ValueError):
        jax_collect_multilayer(str(folder), layers, "tiny", 2, str(tmp_path / "jax_all"),
                               verbose=False)
