"""freud_tpu_torch Whisper encoder against freud_tpu on shared weights.

Weights cross over with ``state_dict_from_jax`` (the inverse of the JAX
``params_from_openai_state_dict``, checked exactly). Captures and a
substitution are held to 1e-4 of the reference's max |value|: both sides
compute in f32 on the CPU (JAX's einsum attention, the port's plain path),
so only summation order differs."""

import jax
import numpy as np
import pytest
import torch

from freud_tpu.models.whisper.config import WhisperDims as JaxDims
from freud_tpu.models.whisper.load import params_from_openai_state_dict
from freud_tpu.models.whisper.model import encoder_forward as jax_encoder_forward
from freud_tpu.models.whisper.model import init_params
from freud_tpu_torch.models.whisper import (
    WhisperDims,
    WhisperRuntime,
    encoder_forward,
    load_model,
    state_dict_from_jax,
)
from freud_tpu_torch.models.whisper.load import encoder_from_state_dict
from freud_tpu_torch.scripts.collect_activations import resolve_device

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=100, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=1)
CAPTURE = ("encoder.conv1", "encoder.blocks.0.attn_ln", "encoder.blocks.1.mlp.1",
           "encoder.blocks.1", "encoder.ln_post")


@pytest.fixture(scope="module")
def shared():
    jdims = JaxDims(**DIMS)
    np_params = jax.tree_util.tree_map(np.asarray, init_params(jdims, seed=1))
    tdims = WhisperDims(**DIMS)
    sd = state_dict_from_jax(np_params, tdims)
    mels = (np.random.default_rng(0).standard_normal((2, 80, 3000)) * 0.5
            ).astype(np.float32)
    return jdims, np_params, tdims, sd, mels


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


def test_state_dict_round_trips_exactly(shared):
    jdims, np_params, _, sd, _ = shared
    assert "encoder.blocks.0.attn.key.bias" not in sd
    assert sd["encoder.conv1.weight"].shape == (64, 80, 3)
    assert sd["encoder.blocks.1.mlp.0.weight"].shape == (256, 64)
    back = params_from_openai_state_dict({k: v.numpy() for k, v in sd.items()}, jdims)
    want = jax.tree_util.tree_leaves_with_path(np_params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))


def test_encoder_captures_match_jax(shared):
    jdims, np_params, tdims, sd, mels = shared
    enc = encoder_from_state_dict(sd, tdims)
    jenc, jcaps = jax_encoder_forward(np_params, jdims, mels, capture=CAPTURE)
    with torch.inference_mode():
        tenc, tcaps = encoder_forward(enc, tdims, torch.from_numpy(mels),
                                      capture=CAPTURE)
    assert set(tcaps) == set(CAPTURE)
    assert tcaps["encoder.conv1"].shape == (2, 3000, 64)
    assert tcaps["encoder.blocks.1.mlp.1"].shape == (2, 1500, 256)
    for name in CAPTURE:
        assert _rel(tcaps[name], jcaps[name]) < 1e-4, name
    assert _rel(tenc, jenc) < 1e-4


def test_encoder_substitute_matches_jax(shared):
    jdims, np_params, tdims, sd, mels = shared
    enc = encoder_from_state_dict(sd, tdims)
    sub = np.random.default_rng(1).standard_normal((2, 1500, 64)).astype(np.float32)
    cap = ("encoder.blocks.1", "encoder.ln_post")
    _, jcaps = jax_encoder_forward(np_params, jdims, mels, capture=cap,
                                   substitute={"encoder.blocks.0": sub})
    with torch.inference_mode():
        _, tcaps = encoder_forward(enc, tdims, torch.from_numpy(mels), capture=cap,
                                   substitute={"encoder.blocks.0": torch.from_numpy(sub)})
    for name in cap:
        assert _rel(tcaps[name], jcaps[name]) < 1e-4, name


def test_stop_after_capture_and_compute_dtype(shared):
    _, _, tdims, sd, mels = shared
    enc = encoder_from_state_dict(sd, tdims)
    x = torch.from_numpy(mels)
    with torch.inference_mode():
        full, caps = encoder_forward(enc, tdims, x, capture=("encoder.blocks.0",))
        stopped, early = encoder_forward(enc, tdims, x, capture=("encoder.blocks.0",),
                                         stop_after_capture=True)
        half, hcaps = encoder_forward(enc, tdims, x, capture=("encoder.blocks.0",),
                                      compute_dtype=torch.bfloat16)
    assert full is not None and stopped is None
    torch.testing.assert_close(early["encoder.blocks.0"], caps["encoder.blocks.0"],
                               rtol=0, atol=0)
    # bf16 runs on cast copies; the module itself stays f32
    assert hcaps["encoder.blocks.0"].dtype == torch.bfloat16
    assert enc.conv1.weight.dtype == torch.float32
    assert _rel(hcaps["encoder.blocks.0"].float(), caps["encoder.blocks.0"]) < 5e-2
    with pytest.raises(ValueError):
        encoder_forward(enc, WhisperDims(**{**DIMS, "n_audio_layer": 3}), x)


def test_random_models_and_runtime():
    enc, dims = load_model("test:tiny")
    assert dims.n_audio_layer == 2 and dims.n_audio_state == 384
    again, _ = load_model("test:tiny")
    torch.testing.assert_close(enc.state_dict(), again.state_dict(), rtol=0, atol=0)
    assert enc.blocks[0].attn.key.bias is None
    rt = WhisperRuntime("test:tiny", "encoder.blocks.0.mlp.1", device="cpu")
    assert (rt.activation_frames, rt.activation_width) == (1500, 1536)
    mels = torch.zeros(80, 3000)
    acts, n_valid = rt.activations_with_lengths(mels)
    assert acts.shape == (1, 1500, 1536) and n_valid.tolist() == [1500]


def test_unported_paths_raise():
    """Decoder layers are capture layers now (their frames the decode's
    buffer, their width the decoder's); an unknown layer and an unknown
    model still raise."""
    rt = WhisperRuntime("test:tiny", "decoder.blocks.0", max_new_tokens=5, device="cpu")
    assert (rt.activation_frames, rt.activation_width) == (3 + 5, 384)
    with pytest.raises(ValueError):
        WhisperRuntime("test:tiny", "blocks.0")
    with pytest.raises(ValueError):
        load_model("no-such-model")


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        WhisperRuntime("test:tiny", "encoder.blocks.0", device="cuda")
    for name in ("cuda", "cuda:1", "tpu", None):
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device(name)
    assert resolve_device("cpu") == torch.device("cpu")
