"""LongCat-Flash-Omni (Meituan) on the collection path: a Whisper audio tower
feeding the LongCat-Flash language model's shortcut-connected double layers
(multi-head latent attention, dense SwiGLU FFNs, a mixture of experts with
identity zero experts whose output lands at the end of the double layer),
holding one card's share of the routed experts. The JAX package has no
counterpart; the plain reference (``portbench/reference/longcat.py``) is
this model's oracle."""

from .config import LONGCAT_MODELS, MODEL_TYPE, LongCatConfig
from .load import is_longcat, load_model, model_from_state_dict
from .model import LongCatModel
from .runtime import LongCatRuntime

__all__ = ["LONGCAT_MODELS", "MODEL_TYPE", "LongCatConfig", "LongCatModel", "LongCatRuntime",
           "is_longcat", "load_model", "model_from_state_dict"]
