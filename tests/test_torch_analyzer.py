"""``FeatureAnalyzer``: freud_tpu_torch's against freud_tpu's on one set
of weights (JAX's ``init_params`` at ``test:tiny`` geometry, written as an
OpenAI-layout ``tiny.pt`` in ``$FREUD_WHISPER_DIR``, the pattern of
tests/test_torch_transcribe.py) and one SAE checkpoint each both packages
load, f32 on the CPU, where both take their plain log-mel paths.

Cases: no SAE, L1 and TopK at an encoder layer; raw, L1 and TopK at
``decoder.blocks.1`` (steered online inside the decode). Held:
``top_features_for_audio``'s indices equal JAX's wherever a feature's
maximum is more than TOL (relative to the largest) from its neighbours'
in JAX's ranking (exact ties, the zeros of a ReLU or a TopK dense latent,
rank to the lower index in both), its traces within TOL of the largest
|value|; ``manipulate``'s three transcripts equal JAX's (without
tokenizer assets text renders as ``<tok:N>``, so equal text is equal
tokens) and both traces within TOL. Out-of-range indices raise before any
device work."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from freud_tpu.analysis.features import FeatureAnalyzer as JaxAnalyzer
from freud_tpu.data.loaders import load_sae as jax_load_sae
from freud_tpu.models.sae import init_l1, init_topk, state_dict_from_params
from freud_tpu.models.sae.config import config_for_variant
from freud_tpu.models.whisper import runtime as jruntime
from freud_tpu.models.whisper.config import dims_for as jax_dims_for
from freud_tpu.models.whisper.model import init_params
from freud_tpu_torch.analysis.features import FeatureAnalyzer
from freud_tpu_torch.data.loaders import load_sae
from freud_tpu_torch.models.whisper import WhisperRuntime, dims_for, state_dict_from_jax

TOL = 1e-4  # relative to the largest |value| of JAX's output
MAX_NEW = 4
TOP_N = 12
SAES = {"l1": {"n_dict_components": 96}, "topk": {"expansion_factor": 2, "k": 8}}
LAYERS = ["encoder.blocks.1", "decoder.blocks.1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run puts several workers on one machine
    (see tests/test_torch_transcribe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("analyzer")
    wdir = root / "whisper"
    wdir.mkdir()
    dims = dims_for("test:tiny")
    np_params = jax.tree_util.tree_map(
        np.asarray, init_params(jax_dims_for("test:tiny"), seed=3))
    torch.save({"dims": dataclasses.asdict(dims),
                "model_state_dict": state_dict_from_jax(np_params, dims)}, wdir / "tiny.pt")
    ckpts = {}
    for variant, raw in SAES.items():
        init = init_l1 if variant == "l1" else init_topk
        sd = state_dict_from_params(variant, init(384, config_for_variant(variant, raw),
                                                  seed=5))
        ckpts[variant] = str(root / f"{variant}.pth")
        torch.save({"model": sd, "hparams": {"autoencoder_variant": variant,
                                             "autoencoder_config": raw,
                                             "activation_size": 384}}, ckpts[variant])
    audio = (np.random.default_rng(7).standard_normal(24000) * 0.1).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setenv("FREUD_WHISPER_DIR", str(wdir))
    runtimes = {layer: (jruntime.WhisperRuntime("tiny", layer, max_new_tokens=MAX_NEW),
                        WhisperRuntime("tiny", layer, max_new_tokens=MAX_NEW, device="cpu"))
                for layer in LAYERS}
    yield ckpts, audio, runtimes
    mp.undo()


def analyzers(env, layer, variant):
    ckpts, _, runtimes = env
    jrt, trt = runtimes[layer]
    if variant is None:
        return JaxAnalyzer(jrt, None), FeatureAnalyzer(trt, None)
    jv, jcfg, _, jparams = jax_load_sae(ckpts[variant])
    tv, tcfg, _, tparams = load_sae(ckpts[variant])
    return JaxAnalyzer(jrt, (jv, jcfg, jparams)), FeatureAnalyzer(trt, (tv, tcfg, tparams))


def _close(got, want, scale):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max(initial=0.0) <= TOL * scale


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("variant", [None, "l1", "topk"], ids=["raw", "l1", "topk"])
def test_analyzer_matches_jax(env, layer, variant):
    _, audio, _ = env
    jan, tan = analyzers(env, layer, variant)
    assert tan.n_features == jan.n_features

    jidx, jtraces = jan.top_features_for_audio(audio, TOP_N)
    tidx, ttraces = tan.top_features_for_audio(audio, TOP_N)
    assert len(tidx) == len(ttraces) == TOP_N and all(isinstance(i, int) for i in tidx)
    jmax = [float(np.max(t)) for t in jtraces]
    tmax = [float(np.max(t)) for t in ttraces]
    scale = max(float(np.abs(np.asarray(jtraces)).max()), 1e-30)
    for i in range(TOP_N):
        # the last place's right neighbour lies beyond the top n: unknown
        left = i == 0 or abs(jmax[i - 1] - jmax[i]) > TOL * scale
        right = i < TOP_N - 1 and abs(jmax[i] - jmax[i + 1]) > TOL * scale
        if (left and right) or jmax[i] == tmax[i] == 0.0:
            assert tidx[i] == jidx[i], (i, tidx, jidx, jmax)
    for ti, tt in zip(tidx, ttraces):
        if ti in jidx:
            _close(tt, jtraces[jidx.index(ti)], scale)

    feat = int(jidx[0])
    jout = jan.manipulate(audio, feat, 8.0)
    tout = tan.manipulate(audio, feat, 8.0)
    assert tout[:3] == tuple(jout[:3])
    scale = max(np.abs(np.asarray(jout[4])).max(), 1e-30)
    _close(tout[3], jout[3], scale)
    _close(tout[4], jout[4], scale)
    if variant is None:
        # factor 1 without an SAE changes nothing: three equal transcripts
        texts = tan.manipulate(audio, feat, 1.0)[:3]
        assert len(set(texts)) == 1, texts


@pytest.mark.parametrize("layer", LAYERS)
def test_out_of_range_raises_before_device_work(env, layer, monkeypatch):
    _, audio, _ = env
    _, tan = analyzers(env, layer, "topk")
    rt = tan.runtime

    def boom(*a, **k):
        raise AssertionError("device work before the range check")

    for name in ("activations", "activations_with_lengths", "activations_with_decode"):
        monkeypatch.setattr(rt, name, boom)
    for feat in (-1, tan.n_features):
        with pytest.raises(ValueError, match="out of range"):
            tan.manipulate(audio, feat, 2.0)
    with pytest.raises(ValueError, match="top_n"):
        tan.top_features_for_audio(audio, tan.n_features + 1)


def test_decoder_tap_needs_a_block_output(env):
    _, _, runtimes = env
    rt = WhisperRuntime("tiny", "decoder.blocks.1.mlp.1", max_new_tokens=MAX_NEW, device="cpu")
    an = FeatureAnalyzer(rt, None)
    with pytest.raises(ValueError, match=r"decoder\.blocks\.N"):
        an._decoder_tap(0, 2.0)
    idx, fn, (fi, fac) = FeatureAnalyzer(runtimes["decoder.blocks.1"][1], None)._decoder_tap(5, 2.0)
    assert idx == 1 and int(fi) == 5 and float(fac) == 2.0
