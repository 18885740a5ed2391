"""Uni-MoE-2.0-Omni's capture runtime: ``WhisperRuntime``'s capture
interface (``activations_with_lengths``, ``activation_width``,
``activation_frames``, ``dims``) over ``OmniModel``, so the fly loader and
the collection CLI run it as they run Whisper.

A tap is ``lm.layers.N`` (the LM's residual stream after layer N; a
collection stores the clip's audio tokens, ``query_tokens`` rows a file) or
``encoder.blocks.N`` (the audio tower, 1500 frames).
The model holds the LM layers up to the tap only. ``capture(mels, names)``
returns any taps of the model's docstring at every position (the
benchmark's check reads each layer's inputs, routes and router outputs).
``counters()`` is the device table of tokens each entry of each layer's
router took in the last forward, which the fly loader fetches with the
batch.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ...device import resolve_device
from .load import load_model


def _tap_kind(layer_name: str, model: str) -> tuple[str, int]:
    parts = layer_name.split(".")
    if parts[:2] == ["lm", "layers"] and len(parts) == 3 and parts[2].isdigit():
        return "lm", int(parts[2])
    if parts[:2] == ["encoder", "blocks"] and len(parts) == 3 and parts[2].isdigit():
        return "tower", int(parts[2])
    raise ValueError(f"unknown capture layer {layer_name!r} for {model} (lm.layers.N "
                     "or encoder.blocks.N)")


class OmniRuntime:
    """Capture at one tap of Uni-MoE-2.0-Omni's audio path on one device.
    Another audio language model with the same capture interface subclasses
    it with its own ``MODEL`` (its name in messages), ``COUNTER`` (the
    profiling counter its ``counters()`` table is recorded under) and
    ``load`` (its ``load_model``)."""

    MODEL = "Uni-MoE-2.0-Omni"
    COUNTER = "moe.tokens"
    load = staticmethod(load_model)

    def __init__(self, model_name: str, layer_name: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None, weights: Optional[tuple] = None):
        """``weights=(hf_config, state_dict)``: weights handed over in
        memory instead of the checkpoint found by ``model_name`` (the
        runtime takes the state dict's tensors)."""
        self.model_name = model_name
        self.layer_name = layer_name
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device, "OmniRuntime",
                                     hint='pass device="cpu" to run on the CPU')
        if self.device.type == "cuda" and compute_dtype != torch.bfloat16:
            # the MoE kernels take bf16 only, the model's own precision
            raise ValueError(f"{self.MODEL} runs on the card in bfloat16, not "
                             f"{compute_dtype} (precision=\"bfloat16\")")
        kind, idx = _tap_kind(layer_name, self.MODEL) if layer_name else ("lm", -1)
        n_layers = idx + 1 if kind == "lm" and idx >= 0 else (0 if layer_name else None)
        self.model = self.load(model_name, self.device, compute_dtype, weights=weights,
                               n_layers=n_layers)
        self.cfg = self.model.cfg
        if kind == "lm" and idx >= self.cfg.num_hidden_layers:
            raise ValueError(f"{layer_name}: the model has {self.cfg.num_hidden_layers} layers")
        self.dims = self.cfg.tower
        self._kind = kind

    def capture(self, mels: torch.Tensor, names: Sequence[str]) -> dict:
        """The named taps of one forward (at every position), stopping
        after the last LM layer they name."""
        with torch.inference_mode():
            _, caps = self.model(self._batch(mels), capture=tuple(names),
                                 stop_after_capture=True)
        return caps

    def activations_with_lengths(self, mels: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (activations (b, activation_frames, width), n_valid (b,) int32,
        the full row count; the fly loader refines it from the audio
        lengths, ``activation_length``)."""
        if self.layer_name is None:
            raise ValueError("runtime was built without a capture layer")
        acts = self.capture(mels, (self.layer_name,))[self.layer_name]
        if self._kind == "lm":
            start = self.cfg.audio_start
            acts = acts[:, start:start + self.cfg.query_tokens]
        return acts, torch.full((acts.shape[0],), acts.shape[1], dtype=torch.int32)

    def activation_length(self, n_samples: int) -> int:
        """Rows of a clip of ``n_samples`` that cover real audio: audio
        tokens (pool tower frames each, rounded up) at an LM tap."""
        frames = min(int(n_samples * 50 // 16000), self.dims.n_audio_ctx)
        if self._kind == "tower":
            return frames
        return min(math.ceil(frames / self.cfg.pool), self.cfg.query_tokens)

    def counters(self) -> torch.Tensor:
        """(layers, n_router) int32 on the device: tokens each dynamic
        expert, then each null one, took in each layer of the last forward."""
        return self.model.moe_tokens

    @property
    def activation_width(self) -> int:
        return self.dims.n_audio_state if self._kind == "tower" else self.cfg.hidden_size

    @property
    def activation_frames(self) -> int:
        return self.dims.n_audio_ctx if self._kind == "tower" else self.cfg.query_tokens

    def _batch(self, mels) -> torch.Tensor:
        mels = torch.as_tensor(mels)
        if mels.ndim == 2:
            mels = mels[None]
        return mels.to(self.device, torch.float32)
