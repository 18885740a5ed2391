"""Decoder-layer capture in freud_tpu_torch against freud_tpu's, on the same
weights (the JAX package's ``init_params`` carried across by
``state_dict_from_jax``) and the same seeded inputs, f32 on the CPU:

* every ``decoder.blocks.N…`` capture name of ``decoder_forward``, and one
  substitution, within 1e-5 of the reference's max |value|;
* ``WhisperRuntime(…, "decoder.blocks.1").activations_with_decode`` at
  ``test:tiny`` geometry (a ``tiny.pt`` in ``$FREUD_WHISPER_DIR``): tokens
  and ``n_valid`` equal, activations within 1e-4 of max; the causal prefix
  of a 4-token decode equal to the 8-token one's; ``.mlp.1``'s width;
* the collection CLI on ``decoder.blocks.0`` at narrow dims (the pattern
  of tests/test_torch_collection.py), without an SAE and with an L1 or a
  TopK one: identical metadata JSON (``n_frames`` the decode's valid
  positions), stores within 1e-4 of max, TopK indices equal where the
  selection is not a near-tie.
"""

import dataclasses
import json
import wave
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.models.whisper import runtime as jruntime
from freud_tpu.models.whisper.config import WhisperDims as JaxDims
from freud_tpu.models.whisper.config import dims_for as jax_dims_for
from freud_tpu.models.whisper.model import decoder_forward as jax_decoder_forward
from freud_tpu.models.whisper.model import init_params
from freud_tpu.models.whisper.tokenizer import special_tokens
from freud_tpu.scripts.collect_activations import get_activations as jax_collect
from freud_tpu_torch.models.whisper import (
    WhisperDims,
    WhisperRuntime,
    decoder_forward,
    dims_for,
    state_dict_from_jax,
)
from freud_tpu_torch.models.whisper.load import decoder_from_state_dict
from freud_tpu_torch.scripts import collect_activations as tcollect

DIMS = dims_for("test:tiny")
MAX_NEW = 8
SUB_NAMES = ("attn_ln", "attn.out", "cross_attn.weights", "mlp_ln", "mlp.0",
             "mlp.1", "mlp.2", "mlp")
CAPTURE = tuple(f"decoder.blocks.{i}" for i in range(DIMS.n_text_layer)) + tuple(
    f"decoder.blocks.1.{n}" for n in SUB_NAMES)
# the collection's narrow model: 16 decoder positions hold 3 + 8
NARROW = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
              n_text_head=4, n_text_layer=1)
LAYER = "decoder.blocks.0"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module: the tier-1 run puts several pytest
    workers on one machine, and torch's OpenMP pool at full width in each
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _write_wav(path, seconds, seed):
    audio = (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


# ------------------------------------------------------- decoder_forward


@pytest.fixture(scope="module")
def forward():
    """One teacher-forced pass of each package capturing every name, and
    one with ``decoder.blocks.0`` substituted."""
    params = init_params(jax_dims_for("test:tiny"), seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    decoder = decoder_from_state_dict(state_dict_from_jax(np_params, DIMS), DIMS).eval()
    rng = np.random.default_rng(0)
    encoded = rng.standard_normal((2, 1500, DIMS.n_text_state)).astype(np.float32)
    st = special_tokens(DIMS.n_vocab)
    text = rng.integers(0, st.eot, (2, 9))
    tokens = np.concatenate([np.tile(st.sot_sequence(0), (2, 1)), text], axis=1)
    sub = (rng.standard_normal((2, tokens.shape[1], DIMS.n_text_state)) * 0.5
           ).astype(np.float32)
    jargs = (params, jax_dims_for("test:tiny"), jnp.asarray(tokens), jnp.asarray(encoded))
    _, jcaps = jax_decoder_forward(*jargs, capture=CAPTURE)
    jsub, _ = jax_decoder_forward(*jargs, substitute={"decoder.blocks.0": jnp.asarray(sub)})
    targs = (decoder, DIMS, torch.from_numpy(tokens), torch.from_numpy(encoded))
    with torch.inference_mode():
        _, tcaps = decoder_forward(*targs, capture=CAPTURE)
        tsub, _ = decoder_forward(*targs, substitute={"decoder.blocks.0": torch.from_numpy(sub)})
    return SimpleNamespace(jcaps=jcaps, tcaps=tcaps, jsub=jsub, tsub=tsub, tokens=tokens)


@pytest.mark.parametrize("name", CAPTURE)
def test_capture_name_matches_jax(forward, name):
    got, want = forward.tcaps[name], np.asarray(forward.jcaps[name])
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    t = forward.tokens.shape[1]
    width = {"mlp.0": 4, "mlp.1": 4}.get(name.split(".", 3)[-1], 1) * DIMS.n_text_state
    if name.endswith("cross_attn.weights"):
        assert want.shape == (2, DIMS.n_text_head, t, 1500)
    else:
        assert want.shape == (2, t, width)
    assert _rel(got, want) < 1e-5, name


def test_substitution_matches_jax(forward):
    assert _rel(forward.tsub, forward.jsub) < 1e-5
    assert set(forward.tcaps) == set(CAPTURE)


# ------------------------------------------------------- the runtime


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    """``tiny`` in ``$FREUD_WHISPER_DIR``: JAX's test:tiny weights as an
    OpenAI-layout checkpoint both packages load."""
    wdir = tmp_path_factory.mktemp("decoder_capture") / "whisper"
    wdir.mkdir()
    np_params = jax.tree_util.tree_map(
        np.asarray, init_params(jax_dims_for("test:tiny"), seed=3))
    torch.save({"dims": dataclasses.asdict(DIMS),
                "model_state_dict": state_dict_from_jax(np_params, DIMS)}, wdir / "tiny.pt")
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))
    yield wdir
    mp.undo()


def test_activations_with_decode_match_jax(whisper_dir):
    mels = (np.random.default_rng(4).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32)
    layer = "decoder.blocks.1"
    jrt = jruntime.WhisperRuntime("tiny", layer, max_new_tokens=MAX_NEW)
    trt = WhisperRuntime("tiny", layer, max_new_tokens=MAX_NEW, device="cpu")
    assert trt.activation_frames == jrt.activation_frames == 3 + MAX_NEW
    assert trt.activation_width == jrt.activation_width == DIMS.n_text_state
    jacts, jn, jtok = jrt.activations_with_decode(mels)
    acts, n_valid, tokens = trt.activations_with_decode(torch.from_numpy(mels))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(jn))
    assert n_valid.dtype == torch.int32
    assert tuple(acts.shape) == (2, 3 + MAX_NEW, DIMS.n_text_state)
    assert _rel(acts, jacts) < 1e-4
    # activations() and activations_with_lengths() are the same capture
    again, n_again = trt.activations_with_lengths(torch.from_numpy(mels))
    assert torch.equal(again, acts) and torch.equal(n_again, n_valid)
    # causal: a 4-token decode's rows are the 8-token decode's prefix
    short = WhisperRuntime("tiny", layer, max_new_tokens=4, device="cpu")
    s_acts, s_n, s_tok = short.activations_with_decode(torch.from_numpy(mels))
    assert torch.equal(s_tok, tokens[:, :7])
    assert (s_acts - acts[:, :7]).abs().max() / acts.abs().max() < 1e-5
    assert torch.equal(s_n, torch.clamp(n_valid, max=7))
    # the MLP's hidden width
    wide = WhisperRuntime("tiny", "decoder.blocks.1.mlp.1", max_new_tokens=4, device="cpu")
    assert wide.activation_width == 4 * DIMS.n_text_state
    w_acts = wide.activations(torch.from_numpy(mels))
    assert tuple(w_acts.shape) == (2, 7, 4 * DIMS.n_text_state)
    with pytest.raises(ValueError, match="decoder"):
        WhisperRuntime("tiny", "encoder.blocks.0", device="cpu").activations_with_decode(mels)


# ------------------------------------------------------- collection


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    root = tmp_path_factory.mktemp("decoder_collect")
    wdir = root / "whisper"
    wdir.mkdir()
    np_params = jax.tree_util.tree_map(np.asarray, init_params(JaxDims(**NARROW), seed=2))
    sd = state_dict_from_jax(np_params, WhisperDims(**NARROW))
    torch.save({"dims": dict(NARROW), "model_state_dict": sd}, wdir / "tiny.pt")
    audio = root / "audio"
    audio.mkdir()
    for i, secs in enumerate((2.0, 0.7, 1.3)):
        _write_wav(audio / f"clip{i}.wav", secs, i)
    return root, wdir, audio


def _sae_checkpoint(root, variant):
    from freud_tpu.models.sae import init_l1, init_topk, state_dict_from_params
    from freud_tpu.models.sae.config import config_for_variant

    raw = ({"n_dict_components": 96, "recon_alpha": 10.0} if variant == "l1"
           else {"expansion_factor": 2, "k": 8})
    init = init_l1 if variant == "l1" else init_topk
    sd = state_dict_from_params(variant, init(64, config_for_variant(variant, raw), seed=4))
    ckpt = root / f"{variant}.pth"
    torch.save({"model": sd, "hparams": {"autoencoder_variant": variant,
                                         "autoencoder_config": raw,
                                         "activation_size": 64}}, ckpt)
    return str(ckpt)


@pytest.mark.parametrize("sae", [None, "l1", "topk"])
def test_decoder_collection_matches_jax(narrow, monkeypatch, sae):
    root, wdir, audio = narrow
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(wdir))
    tag = sae or "dense"
    common = dict(data_path=str(audio), layer_name=LAYER, whisper_model="tiny",
                  sae_model=_sae_checkpoint(root, sae) if sae else None,
                  batch_size=2, verbose=False, max_new_tokens=MAX_NEW)
    jax_collect(out_folder=str(root / f"jax_{tag}"), **common)
    # the port's CLI, from a config file as a user runs it
    cfg = {**common, "out_folder": str(root / f"torch_{tag}"), "device": "cpu"}
    cfg.pop("verbose")
    path = root / f"{tag}.json"
    path.write_text(json.dumps(cfg))
    tcollect.main(["--config", str(path)])
    meta = {p: (root / f"{p}_{tag}" / f"{LAYER}_metadata.json").read_text()
            for p in ("jax", "torch")}
    assert meta["torch"] == meta["jax"]
    m = json.loads(meta["torch"])
    width = {None: 64, "l1": 96, "topk": 128}[sae]
    assert m["activation_shape"] == [3 + MAX_NEW, width]
    assert all(1 <= n <= 3 + MAX_NEW for n in m["n_frames"])
    if sae == "topk":
        name = f"{LAYER}_activation_values.npy"
        jv, tv = (np.load(root / f"{p}_topk" / name) for p in ("jax", "torch"))
        ji, ti = (np.load(root / f"{p}_topk" / f"{LAYER}_feature_indices.npy")
                  for p in ("jax", "torch"))
        assert tv.shape == jv.shape == ti.shape == (3, (3 + MAX_NEW) * 8)
        assert (ti == ji).mean() > 0.99
    else:
        jv, tv = (np.load(root / f"{p}_{tag}" / f"{LAYER}_tensors.npy")
                  for p in ("jax", "torch"))
        assert tv.shape == jv.shape == (3, (3 + MAX_NEW) * width)
    assert np.abs(tv - jv).max() / np.abs(jv).max() < 1e-4
