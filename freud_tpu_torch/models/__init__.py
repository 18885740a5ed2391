"""The models the port runs: Whisper (``whisper``), the audio language
models a collection taps at ``lm.layers.N`` (``omni``: Uni-MoE-2.0-Omni,
``longcat``: LongCat-Flash-Omni) and the SAEs (``sae``)."""

from __future__ import annotations

from typing import Optional


def audio_lm_runtime(name: str, weights: Optional[tuple] = None):
    """The capture runtime class of the audio language model that ``name``
    (a model name or checkpoint directory) or ``weights=(hf_config,
    state_dict)`` names, by its ``model_type``; None for a Whisper model."""
    from . import longcat, omni

    if weights is not None:
        if weights[0].get("model_type") == longcat.MODEL_TYPE:
            return longcat.LongCatRuntime
        return omni.OmniRuntime
    if longcat.is_longcat(name):
        return longcat.LongCatRuntime
    if omni.is_omni(name):
        return omni.OmniRuntime
    return None
