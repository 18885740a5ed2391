"""LongCat-Flash-Omni's weights: the one entry every source of weights goes
through, and the checkpoint directory it reads.

``model_from_state_dict(hf_config, state_dict)`` builds ``LongCatModel`` from
a HuggingFace-layout state dict (the names below), taking each tensor out of
the dict as it goes, so a state dict already on the card is never held
twice. ``load_model(name)`` finds a checkpoint directory by name
(``$FREUD_LONGCAT_DIR/<name>`` or ``~/.cache/freud_tpu/longcat/<name>``;
``config.json`` and ``*.safetensors``, read lazily through a memory map by
``omni.load.read_checkpoint``), or takes ``weights=(hf_config, state_dict)``
handed over in memory.

State-dict names (``N`` a double layer, ``I`` 0 or 1 its first or second
half, ``E`` a held routed expert, numbered as the router numbers it):
``model.embed_tokens.weight``; ``model.layers.N.{input_layernorm,
post_attention_layernorm}.I.weight``; ``model.layers.N.self_attn.I.
{q_a_proj, q_b_proj, kv_a_proj_with_mqa, kv_b_proj, o_proj}.weight`` and
``model.layers.N.self_attn.I.{q_a_layernorm, kv_a_layernorm}.weight``;
``model.layers.N.mlps.I.{gate_proj, up_proj, down_proj}.weight`` (the dense
FFNs); ``model.layers.N.mlp.router.classifier.weight`` (n_routed +
zero_expert_num rows) and ``model.layers.N.mlp.router.e_score_correction_bias``
(the selection bias), both kept in f32; ``model.layers.N.mlp.experts.E.
{gate_proj, up_proj, down_proj}.weight`` for E in the held range;
``model.audio_projector.{weight,bias}``; and the tower as a HuggingFace
Whisper encoder under ``model.audio_tower.`` (``conv1``, ``conv2``,
``embed_positions``, ``layers.N.…``, ``layer_norm``), which loads into the
port's ``AudioEncoder`` (``whisper.load.state_dict_from_hf``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import MutableMapping, Optional

import torch

from ..omni.load import read_checkpoint
from ..whisper.load import state_dict_from_hf
from .config import LONGCAT_MODELS, MODEL_TYPE, LongCatConfig
from .model import LongCatModel

_SEARCH_ENV = "FREUD_LONGCAT_DIR"
_DEFAULT_DIR = "~/.cache/freud_tpu/longcat"
TOWER = "model.audio_tower."


def find_checkpoint(name: str) -> Optional[Path]:
    """The checkpoint directory of a model name or path, or None."""
    p = Path(name).expanduser()
    if (p / "config.json").exists():
        return p
    for d in (os.environ.get(_SEARCH_ENV), _DEFAULT_DIR):
        if d and (Path(d).expanduser() / name / "config.json").exists():
            return Path(d).expanduser() / name
    return None


def is_longcat(name: str) -> bool:
    """Whether a model name or checkpoint directory is this model's."""
    if name in LONGCAT_MODELS:
        return True
    p = Path(name).expanduser() / "config.json"
    if p.exists():
        return json.loads(p.read_text()).get("model_type") == MODEL_TYPE
    return False


def model_from_state_dict(hf_config: dict, sd: MutableMapping, device="cpu",
                          dtype: torch.dtype = torch.bfloat16,
                          n_layers: Optional[int] = None) -> LongCatModel:
    """``LongCatModel`` with the first ``n_layers`` double layers (default
    all) in ``dtype`` on ``device`` (the router and its bias in f32). The
    tensors it uses are taken out of ``sd``; the rest are left there."""
    cfg = LongCatConfig.from_hf(hf_config)
    n_layers = cfg.num_hidden_layers if n_layers is None else n_layers
    with torch.device("meta"):
        model = LongCatModel(cfg, n_layers)

    def take(name, dt=dtype):
        return sd.pop(name).to(device=device, dtype=dt)

    own = {}
    tower = {"encoder." + k[len(TOWER):]: sd.pop(k) for k in list(sd) if k.startswith(TOWER)}
    for k, v in state_dict_from_hf(tower, cfg.tower).items():
        own["tower." + k[len("encoder."):]] = v.to(device=device, dtype=dtype)
    del tower
    own["projector.weight"] = take("model.audio_projector.weight")
    own["projector.bias"] = take("model.audio_projector.bias")
    own["embed_tokens.weight"] = take("model.embed_tokens.weight")
    lo, hi = cfg.held
    for i in range(n_layers):
        src, dst = f"model.layers.{i}.", f"layers.{i}."
        for half in range(2):
            for norm in ("input_layernorm", "post_attention_layernorm"):
                own[f"{dst}{norm}.{half}.weight"] = take(f"{src}{norm}.{half}.weight")
            a, b = f"{src}self_attn.{half}.", f"{dst}self_attn.{half}."
            own[b + "qkv_a.weight"] = torch.cat([take(a + "q_a_proj.weight"),
                                                 take(a + "kv_a_proj_with_mqa.weight")])
            for name in ("q_b_proj.weight", "kv_b_proj.weight", "o_proj.weight",
                         "q_a_layernorm.weight", "kv_a_layernorm.weight"):
                own[b + name] = take(a + name)
            a, b = f"{src}mlps.{half}.", f"{dst}mlps.{half}."
            own[b + "gate_up.weight"] = torch.cat([take(a + "gate_proj.weight"),
                                                   take(a + "up_proj.weight")])
            own[b + "down.weight"] = take(a + "down_proj.weight")
        own[dst + "mlp.router"] = take(src + "mlp.router.classifier.weight", torch.float32)
        own[dst + "mlp.bias"] = take(src + "mlp.router.e_score_correction_bias", torch.float32)
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
            own[dst + "mlp." + ours] = torch.stack(
                [take(f"{src}mlp.experts.{e}.{theirs}.weight") for e in range(lo, hi)])
    model.load_state_dict(own, assign=True)
    model.prompt_ids = torch.tensor([*cfg.prefix_ids, *cfg.suffix_ids], dtype=torch.int64,
                                    device=device)
    model.routes = torch.zeros((n_layers, cfg.n_router), dtype=torch.int32, device=device)
    return model.eval()


def load_model(name: str, device="cpu", dtype: torch.dtype = torch.bfloat16,
               weights: Optional[tuple] = None, n_layers: Optional[int] = None
               ) -> LongCatModel:
    """``LongCatModel`` of a model name or checkpoint directory, or of
    ``weights=(hf_config, state_dict)`` (whose tensors it takes)."""
    if weights is None:
        path = find_checkpoint(name)
        if path is None:
            raise FileNotFoundError(
                f"No checkpoint for {name!r}: place its HuggingFace directory "
                f"(config.json, *.safetensors) at ${_SEARCH_ENV}/{name} or "
                f"{_DEFAULT_DIR}/{name}")
        weights = read_checkpoint(path)
    hf_config, sd = weights
    return model_from_state_dict(hf_config, sd, device, dtype, n_layers)
