from .config import MODEL_DIMS, WhisperDims, dims_for
from .load import load_hf_dir, load_model, state_dict_from_hf, state_dict_from_jax
from .model import AudioEncoder, encoder_forward, init_encoder
from .runtime import WhisperRuntime

__all__ = [
    "MODEL_DIMS",
    "WhisperDims",
    "dims_for",
    "load_hf_dir",
    "load_model",
    "state_dict_from_hf",
    "state_dict_from_jax",
    "AudioEncoder",
    "encoder_forward",
    "init_encoder",
    "WhisperRuntime",
]
