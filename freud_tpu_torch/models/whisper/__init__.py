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
from .runtime import WhisperRuntime
from .tokenizer import special_tokens

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
    "special_tokens",
]
