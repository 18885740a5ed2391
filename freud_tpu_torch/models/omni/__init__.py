"""Uni-MoE-2.0-Omni (HIT-TMG) on the collection path: its Whisper-large
audio tower feeding a decoder-only language model with GQA, M-RoPE and a
top-p mixture of experts with a null expert. The JAX package has no
counterpart; the benchmark's plain reference (``portbench/reference/
omni.py``) is this model's oracle."""

from .config import OMNI_MODELS, OmniConfig
from .load import is_omni, load_model, model_from_state_dict, read_checkpoint, save_checkpoint
from .model import OmniModel
from .runtime import OmniRuntime

__all__ = ["OMNI_MODELS", "OmniConfig", "OmniModel", "OmniRuntime", "is_omni", "load_model",
           "model_from_state_dict", "read_checkpoint", "save_checkpoint"]
