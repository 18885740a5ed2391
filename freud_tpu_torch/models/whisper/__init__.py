"""Whisper in PyTorch: the encoder and decoder modules, their loaders, the
runtime (capture, steering, transcription, word timestamps, long-form
audio) and the tokenizer.

The exports follow ``freud_tpu.models.whisper``'s, with one difference:
JAX's ``init_params`` builds a JAX parameter tree of the whole model; the
port's counterparts are ``init_encoder`` and ``init_decoder``, which build
the two ``nn.Module`` halves from a seed.
"""

from .config import MODEL_DIMS, WhisperDims, dims_for
from .load import (
    load_decoder,
    load_hf_dir,
    load_model,
    state_dict_from_hf,
    state_dict_from_jax,
)
from .model import (
    AudioEncoder,
    TextDecoder,
    decoder_forward,
    encoder_forward,
    init_decoder,
    init_encoder,
)
from .runtime import WhisperRuntime, init_runtime
from .tokenizer import decode_text, special_tokens, tokenizer_available

__all__ = [
    "MODEL_DIMS",
    "WhisperDims",
    "dims_for",
    "load_decoder",
    "load_hf_dir",
    "load_model",
    "state_dict_from_hf",
    "state_dict_from_jax",
    "AudioEncoder",
    "TextDecoder",
    "decoder_forward",
    "encoder_forward",
    "init_decoder",
    "init_encoder",
    "WhisperRuntime",
    "init_runtime",
    "decode_text",
    "special_tokens",
    "tokenizer_available",
]
