"""freud_tpu_torch's blocked Whisper attention (``whisper_attention``) and
the encoder's attention dispatch, against freud_tpu on the CPU: the JAX
Pallas kernel in interpret mode, as tests/test_attention_kernel.py runs it,
and the JAX encoder at large geometry. The CUDA kernel is held against the
plain version on a card in tests/test_torch_cuda.py.

Tolerances: f32 — atol 2e-5, rtol 1e-4 (the bound of
tests/test_attention_kernel.py: f32 rounding in another summation order);
bf16 products on both sides (q·dh^-½, k, v and the probabilities rounded to
bf16, f32 sums) — max |Δ| / max |ref| < 5e-3 (an f32 exp or sum that
differs in its last bit can move a probability to the neighbouring bf16
value, 2⁻⁸ relative, in either implementation); the encoder's captures —
1e-4 of the reference's max |value| (f32 on both sides, as in
tests/test_torch_encoder.py)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.models.whisper.config import WhisperDims as JaxDims
from freud_tpu.models.whisper.model import encoder_forward as jax_encoder_forward
from freud_tpu.models.whisper.model import init_params
from freud_tpu.ops.attention import whisper_attention as jax_whisper_attention
from freud_tpu_torch.models.whisper import WhisperDims, encoder_forward, state_dict_from_jax
from freud_tpu_torch.models.whisper import model as tmodel
from freud_tpu_torch.models.whisper.load import encoder_from_state_dict
from freud_tpu_torch.ops.attention import whisper_attention, whisper_attention_plain

REPO = Path(__file__).resolve().parent.parent


def _qkv(shape, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * scale for _ in range(3)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("s", [512, 700, 1500])
def test_plain_matches_jax_kernel_f32(s):
    q, k, v = _qkv((2, 3, s, 64))
    want = np.asarray(jax_whisper_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = whisper_attention_plain(tq, tk, tv)
    before = whisper_attention.launches
    routed = whisper_attention(tq, tk, tv)  # a CPU tensor takes the plain version
    assert whisper_attention.launches == before
    assert plain.dtype == routed.dtype == torch.float32 and plain.shape == q.shape
    torch.testing.assert_close(routed, plain, rtol=0, atol=0)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5, rtol=1e-4)


def test_bf16_products_match_jax_kernel():
    q, k, v = _qkv((2, 3, 700, 64), seed=1)
    want = np.asarray(jax_whisper_attention(*map(jnp.asarray, (q, k, v)), interpret=True,
                                            matmul_dtype=jnp.bfloat16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = whisper_attention(tq, tk, tv, matmul_dtype=torch.bfloat16)
    torch.testing.assert_close(
        got, whisper_attention_plain(tq, tk, tv, matmul_dtype=torch.bfloat16),
        rtol=0, atol=0)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 5e-3
    # bf16 inputs on the CPU: products in the input dtype, output in it too
    bq, bk, bv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    half = whisper_attention(bq, bk, bv)
    assert half.dtype == torch.bfloat16
    jwant = np.asarray(jax_whisper_attention(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)), interpret=True
    ).astype(jnp.float32))
    assert _rel(half.float(), jwant) < 1e-2  # plus the output's bf16 rounding


def test_unstable_softmax_on_bounded_scores():
    q, k, v = _qkv((1, 2, 333, 64), seed=2, scale=0.3)
    want = np.asarray(jax_whisper_attention(*map(jnp.asarray, (q, k, v)), interpret=True,
                                            stable=False))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = whisper_attention(tq, tk, tv, stable=False)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), whisper_attention_plain(tq, tk, tv).numpy(),
                               atol=2e-5, rtol=1e-4)


def test_strided_head_views_match_contiguous():
    """The model hands the kernel (b, h, s, dh) views of (b, s, h·dh)
    projections: the same numbers as contiguous copies."""
    b, s, h, dh = 2, 150, 3, 64
    x = [torch.from_numpy(a) for a in _qkv((b, s, h * dh), seed=3)]
    views = [t.view(b, s, h, dh).transpose(1, 2) for t in x]
    assert not views[0].is_contiguous()
    got = whisper_attention(*views)
    want = whisper_attention(*(t.contiguous() for t in views))
    assert got.shape == (b, h, s, dh)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jwant = np.asarray(jax_whisper_attention(
        *(jnp.asarray(t.contiguous().numpy()) for t in views), interpret=True))
    np.testing.assert_allclose(got.numpy(), jwant, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("impl,d,device,route", [
    ("auto", 1280, "cuda", "kernel"),   # large
    ("auto", 1024, "cuda", "kernel"),   # medium
    ("auto", 768, "cuda", "fused"),     # small: the fused kernel's last width
    ("auto", 384, "cuda", "fused"),     # tiny
    ("auto", 1280, "cpu", "plain"),
    ("auto", 384, "cpu", "plain"),
    ("einsum", 384, "cuda", "plain"),
    ("einsum", 1280, "cpu", "plain"),
    ("kernel", 384, "cuda", "kernel"),
    ("kernel", 1280, "cpu", "kernel"),
    ("fused", 1280, "cuda", "fused"),
    ("flash", 1280, "cuda", "kernel"),  # JAX's stock flash kernel → #5's kernel
    ("flash", 384, "cuda", "kernel"),
])
def test_attention_route(impl, d, device, route):
    assert tmodel.attention_route(d, device, impl) == route


def test_attention_route_follows_module_switch(monkeypatch):
    assert tmodel.ATTENTION_IMPL == "auto"
    monkeypatch.setattr(tmodel, "ATTENTION_IMPL", "flash")
    assert tmodel.attention_route(384, "cuda") == "kernel"
    monkeypatch.setattr(tmodel, "ATTENTION_IMPL", "nonsense")
    with pytest.raises(ValueError, match="nonsense"):
        tmodel.attention_route(384, "cuda")


def test_kernel_refuses_f32_products_on_cuda_before_launch():
    """On a CUDA tensor the kernel is bf16-only: an explicit float32 raises
    rather than running the plain version. (Checked on a CPU tensor
    subclass that claims to be CUDA: the checks raise before any launch.)"""

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    q = torch.zeros((1, 1, 4, 64)).as_subclass(FakeCuda)
    before = whisper_attention.launches
    with pytest.raises(ValueError, match="bfloat16"):
        whisper_attention(q, q, q, matmul_dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        whisper_attention(*(torch.zeros((1, 1, 4, 32)).as_subclass(FakeCuda),) * 3)
    assert whisper_attention.launches == before


LARGE = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
             n_audio_layer=1, n_vocab=100, n_text_ctx=16, n_text_state=1280,
             n_text_head=20, n_text_layer=1)


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_large_geometry_encoder_matches_jax(monkeypatch, impl):
    """One large-v3-width block (d 1280, 20 heads, 128 bands) on shared
    weights: the CPU plain path ("auto") and the kernel route's CPU version
    ("kernel") against the JAX encoder."""
    jdims = JaxDims(**LARGE)
    np_params = jax.tree_util.tree_map(np.asarray, init_params(jdims, seed=4))
    tdims = WhisperDims(**LARGE)
    enc = encoder_from_state_dict(state_dict_from_jax(np_params, tdims), tdims)
    mels = (np.random.default_rng(5).standard_normal((1, 128, 3000)) * 0.5).astype(np.float32)
    capture = ("encoder.blocks.0.attn.out", "encoder.blocks.0")
    _, jcaps = jax_encoder_forward(np_params, jdims, mels, capture=capture)
    monkeypatch.setattr(tmodel, "ATTENTION_IMPL", impl)
    with torch.inference_mode():
        _, caps = encoder_forward(enc, tdims, torch.from_numpy(mels), capture=capture,
                                  stop_after_capture=True)
    for name in capture:
        assert caps[name].shape == (1, 1500, 1280)
        assert _rel(caps[name], jcaps[name]) < 1e-4, name


LARGE_CONFIGS = [
    "configs/features/large_v1_block_16_audioset_train.json",
    "configs/features/large_v1_block_16_audioset_eval.json",
    "configs/features/large_v3_block_16_dev.json",
    "configs/features/large_v3_block_16_train_10k.json",
    "configs/train/large_v1_audioset.json",
    "configs/train/large_v3_l1.json",
]


@pytest.mark.parametrize("path", LARGE_CONFIGS)
def test_large_configs_refuse_to_run_without_a_card(monkeypatch, tmp_path, path):
    """The large configs say ``"device": "tpu"`` (cuda here): without a card
    the CLIs raise before loading anything, never carrying on on the CPU."""
    from freud_tpu_torch.scripts import collect_activations, train_sae

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = json.loads((REPO / path).read_text())
    assert cfg["device"] == "tpu"
    if "features" in path:
        cfg.update(data_path=str(tmp_path), out_folder=str(tmp_path / "out"))
        cli = collect_activations
    else:
        cfg.update(train_folder=str(tmp_path), val_folder=str(tmp_path),
                   run_dir=str(tmp_path / "run"))
        cli = train_sae
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--config", str(cfg_path)])
    assert not (tmp_path / "out").exists() and not (tmp_path / "run").exists()
