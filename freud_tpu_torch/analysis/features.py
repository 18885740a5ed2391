"""Per-clip feature analysis. The port so far holds the helper that
collection needs and the steering taps of decoder-layer SAEs; top features
and ``FeatureAnalyzer`` (feature manipulation for the server) come with
the analytics slice.

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

from functools import lru_cache, partial

import torch

from ..constants import SAMPLE_RATE, TIMESTEP_S
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
