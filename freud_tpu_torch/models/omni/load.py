"""Uni-MoE-2.0-Omni's weights: the checkpoint reader and the one entry
every source of weights goes through.

``model_from_state_dict(hf_config, state_dict)`` builds ``OmniModel`` from a
HuggingFace-layout state dict (the names below), taking each tensor out of
the dict as it goes, so a state dict already on the card is never held
twice. ``read_checkpoint(dir)`` feeds it from a checkpoint directory
(``config.json`` and ``*.safetensors``, read lazily through a memory map);
``load_model(name)`` finds the directory by name (``$FREUD_OMNI_DIR/<name>``
or ``~/.cache/freud_tpu/omni/<name>``), or takes ``weights=(hf_config,
state_dict)`` handed over in memory. ``save_checkpoint`` writes the layout.

State-dict names (``N`` an LM layer, ``E`` a dynamic expert, ``F`` a fixed
one): ``model.embed_tokens.weight``; ``model.layers.N.{input_layernorm,
post_attention_layernorm}.weight``; ``model.layers.N.self_attn.{q,k,v}_proj.
{weight,bias}`` and ``o_proj.weight``; ``model.layers.N.mlp.gate.weight``
(the router, kept in f32); ``model.layers.N.mlp.experts.E.{gate,up,down}_proj.
weight``; ``model.layers.N.mlp.fixed_experts.F.{gate,up,down}_proj.weight``;
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

import numpy as np
import torch

from ..whisper.load import state_dict_from_hf
from .config import MODEL_TYPE, OMNI_MODELS, OmniConfig
from .model import OmniModel

_SEARCH_ENV = "FREUD_OMNI_DIR"
_DEFAULT_DIR = "~/.cache/freud_tpu/omni"
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


def is_omni(name: str) -> bool:
    """Whether a model name or checkpoint directory is this model's."""
    if name in OMNI_MODELS:
        return True
    p = Path(name).expanduser() / "config.json"
    if p.exists():
        return json.loads(p.read_text()).get("model_type") == MODEL_TYPE
    return False


def model_from_state_dict(hf_config: dict, sd: MutableMapping, device="cpu",
                          dtype: torch.dtype = torch.bfloat16,
                          n_layers: Optional[int] = None) -> OmniModel:
    """``OmniModel`` with the first ``n_layers`` LM layers (default all) in
    ``dtype`` on ``device`` (the router in f32). The tensors it uses are
    taken out of ``sd``; the rest (later layers) are left there."""
    cfg = OmniConfig.from_hf(hf_config)
    n_layers = cfg.num_hidden_layers if n_layers is None else n_layers
    with torch.device("meta"):
        model = OmniModel(cfg, n_layers)

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
    for i in range(n_layers):
        src, dst = f"model.layers.{i}.", f"layers.{i}."
        for name in ("input_layernorm.weight", "post_attention_layernorm.weight",
                     "self_attn.q_proj.weight", "self_attn.q_proj.bias",
                     "self_attn.k_proj.weight", "self_attn.k_proj.bias",
                     "self_attn.v_proj.weight", "self_attn.v_proj.bias",
                     "self_attn.o_proj.weight"):
            own[dst + name] = take(src + name)
        own[dst + "mlp.router"] = take(src + "mlp.gate.weight", torch.float32)
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
            own[dst + "mlp." + ours] = torch.stack(
                [take(f"{src}mlp.experts.{e}.{theirs}.weight") for e in range(cfg.n_dynamic)])
        fixed = {p: [take(f"{src}mlp.fixed_experts.{f}.{p}.weight")
                     for f in range(cfg.n_fixed)] for p in ("gate_proj", "up_proj", "down_proj")}
        own[dst + "mlp.fixed_gate"] = torch.cat(fixed["gate_proj"], dim=0)
        own[dst + "mlp.fixed_up"] = torch.cat(fixed["up_proj"], dim=0)
        own[dst + "mlp.fixed_down"] = torch.cat(fixed["down_proj"], dim=1)
        del fixed
    model.load_state_dict(own, assign=True)
    model.prompt_ids = torch.tensor([*cfg.prefix_ids, *cfg.suffix_ids], dtype=torch.int64,
                                    device=device)
    model.moe_tokens = torch.zeros((n_layers, cfg.n_router), dtype=torch.int32, device=device)
    return model.eval()


# ------------------------------------------------------------- safetensors

_DTYPES = {"BF16": (np.int16, torch.bfloat16), "F16": (np.float16, None),
           "F32": (np.float32, None)}


def _read_safetensors(path: Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors viewing a memory map (nothing
    is read until used); BF16 stays bf16."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(n)))
    # copy-on-write: the tensors may be written without touching the file
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + int(n))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name!r} has unsupported dtype {info['dtype']}")
        np_dtype, view = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        t = torch.from_numpy(np.asarray(data[begin:end]).view(np_dtype))
        out[name] = (t.view(view) if view is not None else t).reshape(info["shape"])
    return out


def read_checkpoint(path) -> tuple[dict, dict[str, torch.Tensor]]:
    """(HuggingFace config, state dict) of a checkpoint directory: its
    ``config.json`` and every ``*.safetensors`` file (shards included)."""
    path = Path(path)
    cfg = json.loads((path / "config.json").read_text())
    sd: dict[str, torch.Tensor] = {}
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"{path} holds config.json but no *.safetensors")
    for f in files:
        sd.update(_read_safetensors(f))
    return cfg, sd


def save_checkpoint(path, hf_config: dict, sd: dict) -> Path:
    """Write ``config.json`` and ``model.safetensors`` (bf16, f16 or f32
    tensors, in name order) into directory ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    names = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
    header, blobs, off = {}, [], 0
    for name in sorted(sd):
        t = sd[name].detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(np.uint64(len(head)).tobytes())
        f.write(head)
        for b in blobs:
            f.write(b)
    (path / "config.json").write_text(json.dumps(hf_config, indent=1))
    return path


def load_model(name: str, device="cpu", dtype: torch.dtype = torch.bfloat16,
               weights: Optional[tuple] = None, n_layers: Optional[int] = None
               ) -> OmniModel:
    """``OmniModel`` of a model name or checkpoint directory, or of
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
