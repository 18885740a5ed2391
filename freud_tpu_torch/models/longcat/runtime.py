"""LongCat-Flash-Omni's capture runtime: ``OmniRuntime``'s capture interface
(``activations_with_lengths``, ``activation_width``, ``activation_frames``,
``dims``, ``capture``, ``counters``) over ``LongCatModel``, so the fly loader
and the collection CLI run it as they run Whisper and Uni-MoE-2.0-Omni.

A tap is ``lm.layers.N`` (the residual stream after double layer N; a
collection stores the clip's audio tokens, ``query_tokens`` rows a file) or
``encoder.blocks.N`` (the audio tower, 1500 frames). The model holds the
double layers up to the tap only. ``counters()`` is the device table of
slots each router entry of each layer took in the last forward, held
experts, absent ones and identity entries alike, which the fly loader
fetches with the batch and records as ``longcat.routes``.
"""

from __future__ import annotations

import torch

from ..omni.runtime import OmniRuntime
from .load import load_model


class LongCatRuntime(OmniRuntime):
    """Capture at one tap of LongCat-Flash-Omni's audio path on one device."""

    MODEL = "LongCat-Flash-Omni"
    COUNTER = "longcat.routes"
    load = staticmethod(load_model)

    def counters(self) -> torch.Tensor:
        """(layers, n_router) int32 on the device: slots each routed expert,
        then each identity entry, took in each layer of the last forward."""
        return self.model.routes
