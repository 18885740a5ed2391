"""The collection slice end to end: freud_tpu and freud_tpu_torch collect
the same WAV folder with the same Whisper weights (an OpenAI-layout ``.pt``
of narrow dims, written through ``state_dict_from_jax``), and must write
identical metadata JSON and stores that agree within 1e-4 of the stored
activations' max |value| (both run f32 on the CPU; only summation order
differs). With an SAE attached (one checkpoint both read), the L1 latents
agree within 1e-4 of max and the TopK indexed stores hold the same indices
wherever the selection is not a near-tie, values within 1e-4 of max."""

import json
import wave

import jax
import numpy as np
import pytest
import torch

from freud_tpu.models.whisper.config import WhisperDims as JaxDims
from freud_tpu.models.whisper.model import init_params
from freud_tpu.scripts.collect_activations import get_activations as jax_collect
from freud_tpu_torch.models.whisper import WhisperDims, state_dict_from_jax
from freud_tpu_torch.scripts import collect_activations as tcollect

LAYER = "encoder.blocks.1"
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
    root = tmp_path_factory.mktemp("collect")
    wdir = root / "whisper"
    wdir.mkdir()
    np_params = jax.tree_util.tree_map(
        np.asarray, init_params(JaxDims(**DIMS), seed=2))
    sd = state_dict_from_jax(np_params, WhisperDims(**DIMS))
    torch.save({"dims": dict(DIMS), "model_state_dict": sd}, wdir / "tiny.pt")
    audio = root / "audio"
    audio.mkdir()
    for i, secs in enumerate((2.0, 0.7, 1.3)):
        _write_wav(audio / f"clip{i}.wav", secs, i)
    return root, wdir, audio


def _read(folder):
    meta = (folder / f"{LAYER}_metadata.json").read_text()
    return meta, np.load(folder / f"{LAYER}_tensors.npy")


def test_collection_matches_jax(setup, monkeypatch):
    root, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    common = dict(data_path=str(audio), layer_name=LAYER, whisper_model="tiny",
                  sae_model=None, batch_size=2, verbose=False)
    jstats = jax_collect(out_folder=str(root / "jax"), **common)
    tstats = tcollect.get_activations(out_folder=str(root / "torch"),
                                      device="cpu", **common)
    assert jstats["n_files"] == tstats["n_files"] == 3
    jmeta, jt = _read(root / "jax")
    tmeta, tt = _read(root / "torch")
    assert tmeta == jmeta
    meta = json.loads(tmeta)
    assert meta["tensor_shape"] == [1500, 64]
    assert meta["n_frames"] == [100, 35, 65]
    assert tt.shape == jt.shape == (3, 1500 * 64) and tt.dtype == jt.dtype
    assert np.max(np.abs(tt - jt)) / np.max(np.abs(jt)) < 1e-4


def test_cli_main_and_resume(setup, monkeypatch):
    root, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    out = root / "cli"
    cfg = {"whisper_model": "tiny", "sae_model": None, "layer_name": LAYER,
           "batch_size": 2, "data_path": str(audio), "device": "cpu",
           "out_folder": str(out), "dl_max_workers": 0, "collect_max": 2,
           "store_dtype": "float16"}
    path = root / "cfg.json"
    path.write_text(json.dumps(cfg))
    tcollect.main(["--config", str(path)])
    meta, first = _read(out)
    assert json.loads(meta)["filenames"] == [str(audio / "clip0.wav"),
                                              str(audio / "clip1.wav")]
    assert first.dtype == np.float16
    # resume picks up the third file and appends
    cfg["collect_max"] = None
    path.write_text(json.dumps(cfg))
    tcollect.main(["--config", str(path), "--resume"])
    meta, grown = _read(out)
    assert len(json.loads(meta)["filenames"]) == 3 and grown.shape[0] == 3
    np.testing.assert_array_equal(grown[:2], first)


def test_bfloat16_precision_collects(setup, monkeypatch):
    """precision: bfloat16 runs the encoder in bf16 and stores float32 rows
    close to the f32 run (bf16 keeps ~3 significant digits)."""
    root, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    common = dict(data_path=str(audio), layer_name=LAYER, whisper_model="tiny",
                  sae_model=None, batch_size=2, verbose=False, device="cpu",
                  collect_max=2)
    tcollect.get_activations(out_folder=str(root / "f32"), **common)
    tcollect.get_activations(out_folder=str(root / "bf16"), precision="bfloat16",
                             **common)
    _, full = _read(root / "f32")
    _, half = _read(root / "bf16")
    assert half.dtype == np.float32 and half.shape == full.shape
    assert np.max(np.abs(half - full)) / np.max(np.abs(full)) < 5e-2


def test_undecodable_file_is_skipped(setup, tmp_path, monkeypatch):
    _, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    folder = tmp_path / "mixed"
    folder.mkdir()
    (folder / "a.wav").write_bytes((audio / "clip1.wav").read_bytes())
    (folder / "b.wav").write_bytes(b"RIFF, but not a wav file")
    stats = tcollect.get_activations(
        data_path=str(folder), layer_name=LAYER, whisper_model="tiny",
        sae_model=None, batch_size=2, out_folder=str(tmp_path / "out"),
        verbose=False, device="cpu")
    assert stats["n_files"] == 1
    meta, rows = _read(tmp_path / "out")
    assert json.loads(meta)["filenames"] == [str(folder / "a.wav")]
    assert rows.shape == (1, 1500 * 64)


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_sae_attached_stores_match_jax(setup, monkeypatch, variant):
    from freud_tpu.models.sae import init_l1, init_topk, state_dict_from_params
    from freud_tpu.models.sae.config import config_for_variant

    root, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    raw = ({"n_dict_components": 96, "recon_alpha": 10.0} if variant == "l1"
           else {"expansion_factor": 2, "k": 8})
    cfg = config_for_variant(variant, raw)
    init = init_l1 if variant == "l1" else init_topk
    sd = state_dict_from_params(variant, init(64, cfg, seed=4))
    ckpt = root / f"{variant}.pth"
    torch.save({"model": sd, "hparams": {"autoencoder_variant": variant,
                                         "autoencoder_config": raw,
                                         "activation_size": 64}}, ckpt)
    common = dict(data_path=str(audio), layer_name=LAYER, whisper_model="tiny",
                  sae_model=str(ckpt), batch_size=2, verbose=False)
    jax_collect(out_folder=str(root / f"jax_{variant}"), **common)
    tcollect.get_activations(out_folder=str(root / f"torch_{variant}"),
                             device="cpu", **common)
    meta = {}
    for pkg in ("jax", "torch"):
        meta[pkg] = (root / f"{pkg}_{variant}" / f"{LAYER}_metadata.json").read_text()
    assert meta["torch"] == meta["jax"]
    assert json.loads(meta["torch"])["activation_shape"] == [1500, 96 if variant == "l1" else 128]
    if variant == "l1":
        jt, tt = (np.load(root / f"{p}_l1" / f"{LAYER}_tensors.npy") for p in ("jax", "torch"))
        assert tt.shape == jt.shape == (3, 1500 * 96)
        assert np.abs(tt - jt).max() / np.abs(jt).max() < 1e-4
        return
    name = f"{LAYER}_activation_values.npy"
    jv, tv = (np.load(root / f"{p}_topk" / name) for p in ("jax", "torch"))
    name = f"{LAYER}_feature_indices.npy"
    ji, ti = (np.load(root / f"{p}_topk" / name) for p in ("jax", "torch"))
    assert tv.shape == jv.shape == ti.shape == (3, 1500 * 8) and ti.dtype == np.int64
    assert np.abs(tv - jv).max() / np.abs(jv).max() < 1e-4
    # indices agree except where two latents' values are within rounding
    assert (ti == ji).mean() > 0.999


@pytest.mark.parametrize("change", [
    {"layer_name": [LAYER, "encoder.blocks.0"], "data_parallel": True},
    {"data_parallel": True},
])
def test_unported_options_raise(setup, tmp_path, change):
    """``data_parallel`` (single- and multi-layer) is ported: with one
    process and no process group it is the one-card collection into
    ``out_folder`` itself, bit for bit (the ranks' shards are
    tests/test_torch_distributed.py's); a loader given something that is
    not a mesh refuses it."""
    _, _, audio = setup
    layers = change.get("layer_name", [LAYER])
    for name, over in (("dp", change), ("plain", {**change, "data_parallel": False})):
        cfg = {"whisper_model": "random:tiny", "layer_name": LAYER, "batch_size": 2,
               "data_path": str(audio), "device": "cpu",
               "out_folder": str(tmp_path / name), **over}
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        tcollect.main(["--config", str(path)])
    assert not list((tmp_path / "dp").glob("shard*"))
    for layer in layers:
        for suffix in ("_metadata.json", "_tensors.npy"):
            assert ((tmp_path / "dp" / f"{layer}{suffix}").read_bytes()
                    == (tmp_path / "plain" / f"{layer}{suffix}").read_bytes())
    from freud_tpu_torch.data.loaders import FlyActivationLoader
    from freud_tpu_torch.data.multilayer import MultiLayerActivationLoader

    with pytest.raises(TypeError, match="Mesh"):
        FlyActivationLoader(str(audio), "random:tiny", None, LAYER, 2, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        MultiLayerActivationLoader(str(audio), "random:tiny", layers, 2, device="cpu",
                                   mesh=object())


def test_decoder_layer_collects(setup, tmp_path, monkeypatch):
    """A ``decoder.blocks.0`` config through the CLI: each file stores
    n_prompt + max_new_tokens rows (3 + 8 on this multilingual vocabulary),
    and ``n_frames`` counts the positions its greedy decode processed
    (tests/test_torch_decoder_capture.py holds it to JAX's)."""
    _, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    layer = "decoder.blocks.0"
    out = tmp_path / "out"
    cfg = {"whisper_model": "tiny", "layer_name": layer, "batch_size": 2,
           "data_path": str(audio), "device": "cpu", "out_folder": str(out),
           "max_new_tokens": 8}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    tcollect.main(["--config", str(path)])
    meta = json.loads((out / f"{layer}_metadata.json").read_text())
    rows = np.load(out / f"{layer}_tensors.npy")
    assert meta["tensor_shape"] == meta["activation_shape"] == [11, 64]
    assert rows.shape == (3, 11 * 64) and np.isfinite(rows).all()
    assert len(meta["n_frames"]) == 3 and all(4 <= n <= 11 for n in meta["n_frames"])


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_collection_extends_an_indexed_folder(setup, tmp_path, monkeypatch, kind):
    """A folder that freud_tpu collected (2 of the 3 files) and indexed:
    the dense index, or the sparse one of a TopK store. Resuming the
    collection into it extends the index by one segment for the third
    file, as freud_tpu's own resumed collection does in a copy of the
    folder: the same index files, the base segment untouched, byte-identical
    meta JSON, and the port's fast path equal to its scan, bit for bit."""
    import shutil

    from freud_tpu.data import feature_store as fs
    from freud_tpu_torch.analysis.search import top_activations
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader

    root, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    sae = None
    if kind == "sparse":
        from freud_tpu.models.sae import init_topk, state_dict_from_params
        from freud_tpu.models.sae.config import config_for_variant

        raw = {"expansion_factor": 2, "k": 8}
        sd = state_dict_from_params("topk", init_topk(64, config_for_variant("topk", raw),
                                                      seed=4))
        sae = str(tmp_path / "topk.pth")
        torch.save({"model": sd, "hparams": {"autoencoder_variant": "topk",
                                             "autoencoder_config": raw,
                                             "activation_size": 64}}, sae)
    common = dict(data_path=str(audio), layer_name=LAYER, whisper_model="tiny",
                  sae_model=sae, batch_size=2, verbose=False)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jax_collect(out_folder=str(jdir), collect_max=2, build_index=True, **common)
    shutil.copytree(jdir, tdir)
    before = {p.name: p.read_bytes() for p in tdir.iterdir() if "feature_major" in p.name}
    assert before
    jax_collect(out_folder=str(jdir), resume=True, **common)
    tcollect.get_activations(out_folder=str(tdir), resume=True, device="cpu", **common)

    names = sorted(p.name for p in jdir.iterdir() if "feature_major" in p.name)
    assert sorted(p.name for p in tdir.iterdir() if "feature_major" in p.name) == names
    assert len(names) == len(before) + (1 if kind == "dense" else 5)
    meta = f"{LAYER}_feature_major.meta.json"
    assert (tdir / meta).read_bytes() == (jdir / meta).read_bytes()
    assert json.loads((tdir / meta).read_text())["covered"] == 3
    for name, data in before.items():
        if name != meta:
            assert (tdir / name).read_bytes() == data, name
    current = fs.index_is_current if kind == "dense" else fs.sparse_index_is_current
    assert current(tdir, LAYER, 3)
    loader = MemoryMappedActivationLoader(str(tdir), LAYER, batch_size=2)
    for feat in (0, 5, 63):
        fast = top_activations(loader, feat, 3, device="cpu")
        for p in tdir.glob(f"{LAYER}_feature_major*"):
            p.rename(tmp_path / p.name)
        scan = top_activations(loader, feat, 3, device="cpu")
        for p in tmp_path.glob(f"{LAYER}_feature_major*"):
            p.rename(tdir / p.name)
        assert [(f, v, t) for f, _, v, t in fast[0]] == [(f, v, t) for f, _, v, t in scan[0]]
        for (_, a, _, _), (_, b, _, _) in zip(fast[0], scan[0]):
            np.testing.assert_array_equal(a, b)
        assert fast[1] == scan[1]


def test_all_undecodable_batch_is_skipped(setup, tmp_path, monkeypatch):
    """Two good WAVs and a broken one at batch 2, sorted so that the second
    batch is the broken file alone: the port's collection skips the empty
    batch and writes the metadata JAX writes for the two good files alone.
    JAX's collection over the same folder raises on the zero-row batch (its
    store writer reshapes it): a known divergence (ROADMAP Queue 3)."""
    _, wdir, audio = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    folder = tmp_path / "mixed"
    folder.mkdir()
    (folder / "a.wav").write_bytes((audio / "clip0.wav").read_bytes())
    (folder / "b.wav").write_bytes((audio / "clip1.wav").read_bytes())
    common = dict(data_path=str(folder), layer_name=LAYER, whisper_model="tiny",
                  sae_model=None, batch_size=2, verbose=False)
    jax_collect(out_folder=str(tmp_path / "jax"), **common)
    (folder / "c.wav").write_bytes(b"RIFF, but not a wav file")
    stats = tcollect.get_activations(out_folder=str(tmp_path / "torch"),
                                     device="cpu", **common)
    assert stats["n_files"] == 2
    jmeta, jt = _read(tmp_path / "jax")
    tmeta, tt = _read(tmp_path / "torch")
    assert tmeta == jmeta
    assert json.loads(tmeta)["filenames"] == [str(folder / "a.wav"), str(folder / "b.wav")]
    assert np.max(np.abs(tt - jt)) / np.max(np.abs(jt)) < 1e-4
    with pytest.raises(ValueError):
        jax_collect(out_folder=str(tmp_path / "jax_all"), **common)


def test_no_decodable_file_writes_nothing(setup, tmp_path, monkeypatch, capsys):
    _, wdir, _ = setup
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    folder = tmp_path / "broken"
    folder.mkdir()
    for name in ("a.wav", "b.wav", "c.wav"):
        (folder / name).write_bytes(b"RIFF, but not a wav file")
    out = tmp_path / "out"
    stats = tcollect.get_activations(
        data_path=str(folder), layer_name=LAYER, whisper_model="tiny",
        sae_model=None, batch_size=2, out_folder=str(out), verbose=False,
        device="cpu")
    assert stats["n_files"] == 0
    assert not (out / f"{LAYER}_metadata.json").exists()
    assert "nothing written" in capsys.readouterr().err
