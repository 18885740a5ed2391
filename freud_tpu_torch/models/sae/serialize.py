"""SAE checkpoint I/O in the reference's ``.pth`` layout.

The port of ``freud_tpu/models/sae/serialize.py``: the same state-dict keys,
so a checkpoint written by either package loads in the other.

  l1:   decoder.weight (activation_size, n_dict), encoder_bias (n_dict,)
  topk: encoder.weight (n_dict, d_in), encoder.bias, W_dec (n_dict, d_in), b_dec

``params_from_jax`` carries JAX parameters, given as numpy arrays, into the
port's modules, as ``models/whisper/load.py::state_dict_from_jax`` does for
Whisper; ``sweep_params_from_jax`` does so for a JAX sweep's stacked (K, …)
parameters, one module a member; ``shard_params_from_jax`` keeps this
rank's rows of JAX's full parameters for a dictionary split over a mesh's
model axis (the trainer's ``shard_dict``).
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from .config import config_for_variant
from .l1 import L1SAE
from .topk import TopKSAE


def _check_variant(variant: str) -> None:
    if variant not in ("l1", "topk"):
        raise ValueError(f"invalid autoencoder variant {variant!r} "
                         "(expected 'l1' or 'topk')")


def state_dict_from_params(variant: str, params) -> dict:
    """Reference-named f32 CPU tensors from an SAE module."""
    _check_variant(variant)

    def t(v):
        return v.detach().to(device="cpu", dtype=torch.float32).clone()

    if variant == "l1":
        return {"decoder.weight": t(params.W), "encoder_bias": t(params.encoder_bias)}
    return {
        "encoder.weight": t(params.encoder_weight),
        "encoder.bias": t(params.encoder_bias),
        "W_dec": t(params.W_dec),
        "b_dec": t(params.b_dec),
    }


def params_from_state_dict(variant: str, sd: Mapping, device="cpu"):
    _check_variant(variant)

    def a(key):
        v = sd[key]
        v = v.detach() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        return v.to(torch.float32)

    if variant == "l1":
        return L1SAE(a("decoder.weight"), a("encoder_bias")).to(device)
    return TopKSAE(a("encoder.weight"), a("encoder.bias"), a("W_dec"),
                   a("b_dec")).to(device)


def params_from_jax(variant: str, np_params, device="cpu"):
    """An SAE module from JAX parameters as numpy (``L1Params`` /
    ``TopKParams`` fields, a NamedTuple or a mapping)."""
    _check_variant(variant)
    get = (np_params.__getitem__ if isinstance(np_params, Mapping)
           else lambda k: getattr(np_params, k))

    def t(name):
        return torch.from_numpy(np.array(get(name), dtype=np.float32))

    if variant == "l1":
        return L1SAE(t("W"), t("encoder_bias")).to(device)
    return TopKSAE(t("encoder_weight"), t("encoder_bias"), t("W_dec"),
                   t("b_dec")).to(device)


def shard_params_from_jax(variant: str, np_params, mesh, device="cpu"):
    """``params_from_jax`` keeping this rank's dictionary rows of JAX's full
    parameters (L1's W columns; TopK's encoder and decoder rows, ``b_dec``
    whole), as ``SAETrainer(shard_dict=True, mesh=mesh)`` holds them. The
    whole module without a model axis."""
    from ...parallel.mesh import shard_dict_slice

    full = params_from_jax(variant, np_params)
    if variant == "l1":
        return L1SAE(shard_dict_slice(full.W.detach(), 1, mesh),
                     shard_dict_slice(full.encoder_bias.detach(), 0, mesh)).to(device)
    return TopKSAE(*(shard_dict_slice(getattr(full, n).detach(), 0, mesh)
                     for n in ("encoder_weight", "encoder_bias", "W_dec")),
                   full.b_dec.detach()).to(device)


def sweep_params_from_jax(variant: str, stacked_np, device="cpu") -> list:
    """The K members' SAE modules from a JAX sweep's stacked parameters
    (``SAESweepTrainer.params``: each field carries a leading model axis),
    given as numpy: member i's module holds row i of every field."""
    _check_variant(variant)
    get = (stacked_np.__getitem__ if isinstance(stacked_np, Mapping)
           else lambda k: getattr(stacked_np, k))
    names = (("W", "encoder_bias") if variant == "l1"
             else ("encoder_weight", "encoder_bias", "W_dec", "b_dec"))
    fields = {n: np.asarray(get(n)) for n in names}
    n_models = {v.shape[0] for v in fields.values()}
    if len(n_models) != 1:
        raise ValueError(f"stacked fields disagree on the model axis: "
                         f"{ {n: v.shape for n, v in fields.items()} }")
    return [params_from_jax(variant, {n: v[i] for n, v in fields.items()}, device)
            for i in range(n_models.pop())]


def save_checkpoint(path: str, state: dict) -> None:
    """Save a trainer-state dict atomically: a crash mid-write must not
    destroy the checkpoint being overwritten."""
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _numpy_safe_globals() -> list:
    """numpy's data-only reconstructors, so checkpoints that carry ndarray
    leaves (older JAX-package checkpoints) load under weights_only=True."""
    try:
        from numpy._core import multiarray as ma  # numpy >= 2
    except ImportError:  # pragma: no cover — numpy 1.x
        from numpy.core import multiarray as ma
    allow = [np.ndarray, np.dtype, ma._reconstruct, ma.scalar]
    try:
        import numpy.dtypes as ndt

        allow += [getattr(ndt, n) for n in dir(ndt) if n.endswith("DType")]
    except ImportError:  # pragma: no cover — numpy < 1.25
        pass
    return allow


def load_checkpoint_file(path: str) -> dict:
    """torch.load with the safe loader (``weights_only=True``) first; a
    checkpoint that needs more falls back to the legacy loader with a
    warning."""
    try:
        with torch.serialization.safe_globals(_numpy_safe_globals()):
            return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 — pickle.UnpicklingError and friends
        print(f"warning: {path} needs the legacy (unsafe) pickle loader — "
              "only load checkpoints you trust")
        return torch.load(path, map_location="cpu", weights_only=False)


def sae_from_checkpoint(path: str, device="cpu") -> tuple[str, Any, int, Any]:
    """(variant, cfg, activation_size, module) from a trainer checkpoint."""
    ckpt = load_checkpoint_file(path)
    hp = ckpt["hparams"]
    variant = hp["autoencoder_variant"]
    cfg = config_for_variant(variant, hp["autoencoder_config"])
    params = params_from_state_dict(variant, ckpt["model"], device)
    return variant, cfg, hp["activation_size"], params
