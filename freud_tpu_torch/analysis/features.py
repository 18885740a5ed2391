"""Per-clip feature analysis: top features, feature manipulation, and the
steering taps of decoder-layer SAEs — the port of
``freud_tpu/analysis/features.py``.

``FeatureAnalyzer`` serves the upload paths of the GUI server:

* top features — per-feature max over the clip's trimmed trace, ranked
  with a stable descending sort (ties to the lower index, as
  ``lax.top_k``), and the winners' traces;
* manipulation — scale one feature in the latent (L1: dense slice; TopK:
  edit where the index appears; raw: edit the activation channel), decode
  the standard and the manipulated reconstructions, splice each back into
  the encoder, and return the three transcripts and both trimmed traces.
  At a ``decoder.blocks.N`` layer the substitution runs online inside the
  decode (``decoder_tap``).

Every log-mel runs on the runtime's device (kernel #1 on the card).

The steering taps are online per-position transforms for decoder-layer
feature manipulation, the port of ``freud_tpu/analysis/features.py``'s:
applied to a block's residual-stream output at each decode position as it
is generated (``decoding._decode_step``'s ``tap_fn``). Each takes
``(tap_params, x)`` with x (N, 1, d) in the decode's dtype and returns the
steered x (the step casts it back). ``feat_idx`` and ``factor`` ride in
``tap_params`` as device tensors, so the standard (factor 1) and the
manipulated decode run the same code, and a tap reads nothing on the host.
The SAE parameters stay f32: a bf16 x is promoted as JAX promotes it.
"""

from __future__ import annotations

import re
from functools import lru_cache, partial
from typing import Optional

import numpy as np
import torch

from ..audio.mel import mels_from_array
from ..constants import SAMPLE_RATE, TIMESTEP_S
from ..models.sae import config as sae_config
from ..models.sae import l1 as l1_mod
from ..models.sae import topk as topk_mod


def activation_length_from_samples(n_samples: int) -> int:
    """Encoder frames covering an audio clip."""
    return min(int(n_samples / SAMPLE_RATE / TIMESTEP_S), 1500)


def _one_hot_scale(feat_idx: torch.Tensor, factor: torch.Tensor, n: int) -> torch.Tensor:
    """``1 + (factor − 1)·one_hot(feat_idx, n)`` in f32 (JAX's f32 factor
    promotes its one-hot), from device scalars (``F.one_hot`` would read
    the index on the host to check it)."""
    hot = (torch.arange(n, device=feat_idx.device) == feat_idx).to(torch.float32)
    return 1.0 + (factor - 1.0) * hot


def _l1_steer_tap(tap, x):
    """SAE roundtrip with one latent feature scaled (L1 variant).

    ``tap = (normalized_params, feat_idx, factor)`` — pass
    ``l1.normalize_columns(params)`` so the per-step work is the two
    matmuls. As in JAX, x is promoted to f32 against W and the encoder bias
    is rounded to x's dtype."""
    nparams, feat_idx, factor = tap
    W, b = nparams.W, nparams.encoder_bias
    latent = torch.relu(x.to(W.dtype) @ W + b.to(x.dtype))
    latent = latent * _one_hot_scale(feat_idx, factor, latent.shape[-1])
    return l1_mod.decode(nparams, latent)


def _topk_steer_tap(tap, x, *, k):
    """SAE roundtrip with one feature scaled where it appears in the top-k
    (TopK variant; ``k`` is bound with functools.partial). ``torch.topk``
    selects, as ``jax.lax.top_k`` does in JAX: ties among the ReLU zeros
    pick any of them, and a zero adds nothing to the decode."""
    params, feat_idx, factor = tap
    top_acts, top_indices = torch.topk(topk_mod.pre_acts(params, x), k, dim=-1)
    acts = torch.where(top_indices == feat_idx, top_acts * factor, top_acts)
    return topk_mod.decode(params, acts, top_indices)


def _raw_steer_tap(tap, x):
    """No-SAE channel scaling: multiply one residual-stream channel."""
    feat_idx, factor = tap
    return x * _one_hot_scale(feat_idx, factor, x.shape[-1])


@lru_cache(maxsize=None)
def _topk_steer_fn(k: int):
    return partial(_topk_steer_tap, k=k)


def sae_steer_fn(variant: str, cfg):
    """The tap fn of an SAE (variant, cfg): the SAME object for equal
    (variant, k) across callers, so a cache keyed on the fn (a captured
    decode) serves them all."""
    if variant == "l1":
        return _l1_steer_tap
    return _topk_steer_fn(int(cfg.k))


def sae_roundtrip_tap_params(variant: str, params):
    """Tap params for the plain SAE roundtrip (no feature edited, factor 1):
    the trainer's "substitute the reconstruction" validation transcript,
    online. Pass the live SAE parameters at each call: TopK taps read the
    module's tensors as they are at every step, an L1 tap a fresh
    ``normalize_columns`` of them."""
    device = next(params.parameters()).device
    if variant == "l1":
        with torch.no_grad():
            params = l1_mod.normalize_columns(params)
    return (params, torch.zeros((), dtype=torch.int64, device=device),
            torch.ones((), dtype=torch.float32, device=device))


class FeatureAnalyzer:
    """Owns a WhisperRuntime + optional SAE for the upload/manipulate paths.
    The SAE's module lies on the runtime's device. Both entry points run
    under ``torch.inference_mode()``: grad mode is per thread, and the
    server calls them from a new thread a request."""

    def __init__(self, runtime, sae: Optional[tuple] = None):
        """``sae`` is (variant, cfg, params) as produced by loaders.load_sae."""
        self.runtime = runtime
        self.sae = sae

    @property
    def n_features(self) -> int:
        if self.sae is None:
            return self.runtime.activation_width
        variant, cfg, _ = self.sae
        return sae_config.get_n_dict_components(
            self.runtime.activation_width, cfg.expansion_factor, cfg.n_dict_components
        )

    def _mel(self, audio: np.ndarray) -> torch.Tensor:
        rt = self.runtime
        return mels_from_array(audio, rt.dims.n_mels, device=rt.device)

    # ---------------------------------------------------------- top features

    @torch.inference_mode()
    def top_features_for_audio(self, audio: np.ndarray, top_n: int):
        """(feature_indices, traces): top-n features of an uploaded clip."""
        if not (0 <= int(top_n) <= self.n_features):
            raise ValueError(f"top_n must be in [0, {self.n_features}], got {top_n}")
        rt = self.runtime
        acts, n_valid = rt.activations_with_lengths(self._mel(audio))
        if rt.layer_name.startswith("decoder."):
            # decode positions, not audio frames — the decode itself reports
            # how many positions it processed (rows beyond are EOT-padding)
            true_len = int(n_valid.cpu()[0])
        else:
            true_len = activation_length_from_samples(len(audio))
        latent = self._latent(acts[0])[:true_len]  # (T', n_features)
        # a stable descending sort of the per-feature maxima: ties (the
        # many zeros after a ReLU or of a TopK dense latent) to the lower
        # index, as lax.top_k orders them; torch.topk does not order ties
        order = torch.sort(torch.amax(latent, dim=0), descending=True, stable=True)[1]
        idx = order[:int(top_n)]
        traces = latent[:, idx].T.cpu().numpy()
        return [int(i) for i in idx.tolist()], list(traces)

    def _latent(self, acts: torch.Tensor) -> torch.Tensor:
        """The SAE's dense latent of (…, width) activations (the activations
        themselves without an SAE), f32 as JAX promotes a bf16 capture."""
        acts = acts.to(torch.float32)
        if self.sae is None:
            return acts
        variant, cfg, params = self.sae
        if variant == "l1":
            return l1_mod.encode(params, acts).latent
        enc = topk_mod.encode(params, acts, cfg)
        return topk_mod.dense_latent(enc.top_acts, enc.top_indices, self.n_features)

    # ---------------------------------------------------------- manipulation

    @torch.inference_mode()
    def manipulate(
        self, audio: np.ndarray, feat_idx: int, manipulation_factor: float
    ):
        """(baseline_text, manipulated_text, standard_text,
        standard_trace, manipulated_trace)."""
        if not (0 <= int(feat_idx) < self.n_features):
            # checked on the host before any device work: an out-of-range
            # index on the card is a device-side assert, which poisons the
            # process's CUDA context (JAX clamped it silently instead)
            raise ValueError(
                f"feat_idx {feat_idx} out of range [0, {self.n_features})"
            )
        feat_idx = int(feat_idx)
        rt = self.runtime
        if rt.layer_name.startswith("decoder."):
            return self._manipulate_decoder(audio, feat_idx, manipulation_factor)
        mel = self._mel(audio)
        acts = rt.activations(mel)  # (1, T, width)
        true_len = activation_length_from_samples(len(audio))

        if self.sae is not None:
            variant, cfg, params = self.sae
            x = acts.to(torch.float32)
            if variant == "l1":
                latent = l1_mod.encode(params, x).latent
                standard_trace = latent[0, :, feat_idx]
                manipulated = latent.clone()
                manipulated[:, :, feat_idx] *= manipulation_factor
                nparams = l1_mod.normalize_columns(params)
                standard_decoded = l1_mod.decode(nparams, latent)
                manipulated_decoded = l1_mod.decode(nparams, manipulated)
            else:
                enc = topk_mod.encode(params, x, cfg)
                hit = enc.top_indices == feat_idx
                manipulated_acts = torch.where(
                    hit, enc.top_acts * manipulation_factor, enc.top_acts)
                standard_decoded = topk_mod.decode(params, enc.top_acts, enc.top_indices)
                manipulated_decoded = topk_mod.decode(
                    params, manipulated_acts, enc.top_indices)
                standard_trace = torch.sum(
                    torch.where(hit, enc.top_acts, 0.0), dim=-1)[0]
        else:
            standard_trace = acts[0, :, feat_idx]
            manipulated_decoded = acts.clone()
            manipulated_decoded[:, :, feat_idx] *= manipulation_factor
            standard_decoded = acts
        # the reference returns the unmodified-forward transcript in every
        # path, SAE or not; the stock GUI renders the field
        baseline_text = rt.transcribe_one(mel)
        standard_trace = standard_trace.to(torch.float32).cpu().numpy()
        manipulated_trace = standard_trace * manipulation_factor

        layer = rt.layer_name
        manipulated_text = rt.transcribe_one(
            mel, substitute_layer=layer, substitute_value=manipulated_decoded
        )
        standard_text = rt.transcribe_one(
            mel, substitute_layer=layer, substitute_value=standard_decoded
        )
        return (
            baseline_text,
            manipulated_text,
            standard_text,
            standard_trace[:true_len],
            manipulated_trace[:true_len],
        )

    # ------------------------------------------------- decoder-layer steering

    def _decoder_tap(self, feat_idx, factor):
        """(layer_idx, fn, tap_params) steering the runtime's decoder layer.

        ``fn`` is the same object for every request of one SAE (the taps
        above); feat_idx and factor ride in tap_params as device scalars."""
        layer = self.runtime.layer_name
        m = re.fullmatch(r"decoder\.blocks\.(\d+)", layer)
        if m is None:
            raise ValueError(
                "online decoder steering operates on block outputs "
                f"(decoder.blocks.N), got {layer!r}"
            )
        idx = int(m.group(1))
        device = self.runtime.device
        fi = torch.tensor(int(feat_idx), dtype=torch.int64, device=device)
        fac = torch.tensor(float(factor), dtype=torch.float32, device=device)
        if self.sae is None:
            return idx, _raw_steer_tap, (fi, fac)
        variant, cfg, params = self.sae
        if variant == "l1":
            return idx, _l1_steer_tap, (l1_mod.normalize_columns(params), fi, fac)
        return idx, sae_steer_fn(variant, cfg), (params, fi, fac)

    def _manipulate_decoder(self, audio, feat_idx, manipulation_factor):
        """Decoder-layer ``manipulate``: same contract as the encoder path,
        but the substitution happens ONLINE inside the autoregressive decode
        (each steered position influences every later token). Traces come
        from the captured teacher-forced pass over the UNsteered greedy
        decode, trimmed to the positions that decode processed; that decode's
        tokens render the baseline transcript."""
        rt = self.runtime
        mel = self._mel(audio)
        acts, n_valid, base_tokens = rt.activations_with_decode(mel)
        true_len = int(n_valid.cpu()[0])

        if self.sae is not None:
            variant, cfg, params = self.sae
            x = acts.to(torch.float32)
            if variant == "l1":
                standard_trace = l1_mod.encode(params, x).latent[0, :, feat_idx]
            else:
                enc = topk_mod.encode(params, x, cfg)
                hit = enc.top_indices == feat_idx
                standard_trace = torch.sum(
                    torch.where(hit, enc.top_acts, 0.0), dim=-1)[0]
        else:
            standard_trace = acts[0, :, feat_idx]
        standard_trace = standard_trace.to(torch.float32).cpu().numpy()
        manipulated_trace = standard_trace * manipulation_factor

        baseline_text = rt.decode_tokens_text(base_tokens.cpu())[0]
        layer_idx, fn, tap_m = self._decoder_tap(feat_idx, manipulation_factor)
        _, _, tap_s = self._decoder_tap(feat_idx, 1.0)
        manipulated_text = rt.transcribe_one(
            mel, decoder_tap=(layer_idx, fn, tap_m)
        )
        standard_text = rt.transcribe_one(mel, decoder_tap=(layer_idx, fn, tap_s))
        return (
            baseline_text,
            manipulated_text,
            standard_text,
            standard_trace[:true_len],
            manipulated_trace[:true_len],
        )
