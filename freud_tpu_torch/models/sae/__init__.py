from . import l1, topk
from .config import (
    AutoEncoderConfig,
    L1AutoEncoderConfig,
    TopKAutoEncoderConfig,
    config_for_variant,
    get_n_dict_components,
)
from .l1 import L1EncoderOutput, L1ForwardOutput, L1Params, L1SAE, init_l1
from .serialize import (
    params_from_jax,
    params_from_state_dict,
    sae_from_checkpoint,
    shard_params_from_jax,
    state_dict_from_params,
    sweep_params_from_jax,
)
from .topk import TopKEncoderOutput, TopKForwardOutput, TopKParams, TopKSAE, init_topk

__all__ = [
    "l1",
    "topk",
    "AutoEncoderConfig",
    "L1AutoEncoderConfig",
    "TopKAutoEncoderConfig",
    "config_for_variant",
    "get_n_dict_components",
    "L1Params",
    "L1SAE",
    "L1EncoderOutput",
    "L1ForwardOutput",
    "init_l1",
    "TopKParams",
    "TopKSAE",
    "TopKEncoderOutput",
    "TopKForwardOutput",
    "init_topk",
    "state_dict_from_params",
    "params_from_state_dict",
    "params_from_jax",
    "shard_params_from_jax",
    "sweep_params_from_jax",
    "sae_from_checkpoint",
]
