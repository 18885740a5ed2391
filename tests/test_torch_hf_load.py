"""freud_tpu_torch's HuggingFace checkpoint-directory loader against
freud_tpu's ``load_hf_dir``, on a random-init transformers ``WhisperModel``
with a shrunk config written by ``save_pretrained`` (no download), and its
numpy safetensors reader against the ``safetensors`` package. Skips where
transformers (or safetensors) does not import, as
tests/test_hf_differential.py does.

Tolerance: the two encoders' outputs within 1e-4 of the reference's max
|value| (f32 on both sides, as in tests/test_torch_encoder.py)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from freud_tpu.models.whisper.load import load_hf_dir as jax_load_hf_dir
from freud_tpu.models.whisper.model import encoder_forward as jax_encoder_forward
from freud_tpu_torch.models.whisper import encoder_forward, load_model
from freud_tpu_torch.models.whisper.load import read_safetensors

CTX = 50  # encoder positions: mels of 2·CTX frames


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    cfg = transformers.WhisperConfig(
        vocab_size=120, num_mel_bins=80, d_model=64, encoder_layers=2,
        encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=CTX,
        max_target_positions=16, activation_function="gelu", pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=3,
    )
    torch.manual_seed(0)
    model = transformers.WhisperModel(cfg).eval()
    root = tmp_path_factory.mktemp("hf")
    model.save_pretrained(root / "safetensors", safe_serialization=True)
    model.save_pretrained(root / "bin", safe_serialization=False)
    assert (root / "safetensors" / "model.safetensors").exists()
    assert (root / "bin" / "pytorch_model.bin").exists()
    return root


@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_hf_dir_matches_jax_loader(hf_dirs, form):
    path = hf_dirs / form
    enc, dims = load_model(str(path))
    jparams, jdims = jax_load_hf_dir(Path(path))
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    assert (dims.n_audio_state, dims.n_audio_head, dims.n_audio_ctx) == (64, 2, CTX)
    assert enc.blocks[0].attn.key.bias is None
    mels = (np.random.default_rng(0).standard_normal((2, 80, 2 * CTX)) * 0.5
            ).astype(np.float32)
    capture = ("encoder.blocks.0", "encoder.ln_post")
    jenc, jcaps = jax_encoder_forward(jparams, jdims, mels, capture=capture)
    with torch.inference_mode():
        tenc, tcaps = encoder_forward(enc, dims, torch.from_numpy(mels), capture=capture)
    for got, want in [(tenc, jenc)] + [(tcaps[n], jcaps[n]) for n in capture]:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_safetensors_reader_matches_package(hf_dirs):
    from safetensors.numpy import load_file

    path = hf_dirs / "safetensors" / "model.safetensors"
    got = read_safetensors(path)
    want = load_file(str(path))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_safetensors_reader_dtypes(tmp_path):
    """bf16 (which numpy lacks) widens to f32 exactly; f16 and integer
    tensors keep their dtype."""
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(1)
    tensors = {
        "bf16": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(torch.bfloat16),
        "f16": torch.from_numpy(rng.standard_normal((4,)).astype(np.float16)),
        "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "scalar": torch.tensor(2.5),
    }
    path = tmp_path / "t.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    got = read_safetensors(path)
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"], tensors["bf16"].float().numpy())
    for name in ("f16", "i64", "scalar"):
        assert got[name].dtype == tensors[name].numpy().dtype, name
        np.testing.assert_array_equal(got[name], tensors[name].numpy())


@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_hf_decoder_mapping_matches_jax(hf_dirs, form):
    """``state_dict_from_hf`` maps the decoder's names as
    ``params_from_hf_state_dict`` does (the JAX pytree carried across by
    ``state_dict_from_jax`` gives the same tensors), and the loaded decoder's
    teacher-forced logits agree with JAX's within 1e-4 of max."""
    import jax

    from freud_tpu.models.whisper.model import decoder_forward as jax_decoder_forward
    from freud_tpu_torch.models.whisper import decoder_forward, load_decoder, state_dict_from_jax
    from freud_tpu_torch.models.whisper.load import hf_state_dict

    path = hf_dirs / form
    jparams, jdims = jax_load_hf_dir(Path(path))
    sd, dims = hf_state_dict(path)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), dims)
    assert sorted(sd) == sorted(want)
    assert any(k.startswith("decoder.blocks.0.cross_attn.") for k in sd)
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    dec, ddims = load_decoder(str(path))
    assert ddims == dims and dec.blocks[0].cross_attn.key.bias is None
    rng = np.random.default_rng(3)
    encoded = rng.standard_normal((2, CTX, 64)).astype(np.float32)
    tokens = rng.integers(0, 120, (2, 9))
    jl, _ = jax_decoder_forward(jparams, jdims, tokens, encoded)
    with torch.inference_mode():
        tl, _ = decoder_forward(dec, dims, torch.from_numpy(tokens), torch.from_numpy(encoded))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (2, 9, 120)
    assert np.abs(tl.numpy() - jl).max() / np.abs(jl).max() < 1e-4
