"""Whisper weight resolution and loading.

``load_model(name)`` resolves a model name to ``(AudioEncoder, dims)``, and
``load_decoder(name)`` to ``(TextDecoder, dims)`` from the same source (the
decoder is built only when a caller asks for it — collection never does):

* ``random:NAME`` / ``test:NAME`` → seeded random init (``torch.Generator``)
  with NAME's geometry (``test:`` shrinks to 2 + 2 layers). The numbers differ
  from the JAX package's ``init_params``; move JAX weights across with
  ``state_dict_from_jax`` when both must hold the same model.
* a bare name → the OpenAI ``.pt`` checkpoint from ``$FREUD_WHISPER_DIR`` or
  ``~/.cache/whisper`` (the search of ``freud_tpu/models/whisper/load.py``),
  read with ``torch.load(weights_only=True)``;
* a HuggingFace checkpoint directory (``config.json`` + ``model.safetensors``
  or ``pytorch_model.bin``) → ``load_hf_dir``. ``model.safetensors`` is read
  by ``read_safetensors``, a numpy reader of the format, so the
  ``safetensors`` package is not needed.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from .config import MODEL_DIMS, WhisperDims, dims_for
from .model import AudioEncoder, TextDecoder, init_decoder, init_encoder

_SEARCH_ENV = "FREUD_WHISPER_DIR"
_DEFAULT_DIRS = ("~/.cache/whisper", "~/.cache/freud_tpu/whisper")


def find_checkpoint(name: str) -> Path | None:
    dirs = []
    if os.environ.get(_SEARCH_ENV):
        dirs.append(os.environ[_SEARCH_ENV])
    dirs.extend(_DEFAULT_DIRS)
    for d in dirs:
        p = Path(d).expanduser() / f"{name}.pt"
        if p.exists():
            return p
    return None


# ------------------------------------------------------- JAX → OpenAI layout


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear_to(sd: dict, key: str, p: Mapping) -> None:
    # JAX linear w is (d_in, d_out); torch's is (out, in)
    sd[f"{key}.weight"] = _t(p["w"]).T.contiguous()
    if "b" in p:
        sd[f"{key}.bias"] = _t(p["b"])


def _ln_to(sd: dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["g"])
    sd[f"{key}.bias"] = _t(p["b"])


def _block_to(sd: dict, prefix: str, p: Mapping) -> None:
    _ln_to(sd, f"{prefix}.attn_ln", p["attn_ln"])
    for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value"),
                         ("out", "out")):
        _linear_to(sd, f"{prefix}.attn.{theirs}", p["attn"][ours])
    _ln_to(sd, f"{prefix}.mlp_ln", p["mlp_ln"])
    _linear_to(sd, f"{prefix}.mlp.0", p["mlp"]["fc1"])
    _linear_to(sd, f"{prefix}.mlp.2", p["mlp"]["fc2"])
    if "cross_attn" in p:
        _ln_to(sd, f"{prefix}.cross_attn_ln", p["cross_attn_ln"])
        for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value"),
                             ("out", "out")):
            _linear_to(sd, f"{prefix}.cross_attn.{theirs}",
                       p["cross_attn"][ours])


def state_dict_from_jax(np_params: Mapping, dims: WhisperDims) -> dict[str, torch.Tensor]:
    """OpenAI-layout Whisper state dict (encoder and decoder) from the JAX
    package's parameter pytree given as numpy arrays — the inverse of
    ``freud_tpu.models.whisper.load.params_from_openai_state_dict``.

    Linear ``w`` (d_in, d_out) → weight (out, in); conv ``w`` (k, in, out) →
    weight (out, in, k); ``k`` projections carry no bias."""
    sd: dict[str, torch.Tensor] = {}
    enc = np_params["encoder"]
    for conv in ("conv1", "conv2"):
        sd[f"encoder.{conv}.weight"] = _t(enc[conv]["w"]).permute(2, 1, 0).contiguous()
        sd[f"encoder.{conv}.bias"] = _t(enc[conv]["b"])
    sd["encoder.positional_embedding"] = _t(enc["pos"])
    if len(enc["blocks"]) != dims.n_audio_layer:
        raise ValueError(f"{len(enc['blocks'])} encoder blocks, dims say "
                         f"{dims.n_audio_layer}")
    for i, block in enumerate(enc["blocks"]):
        _block_to(sd, f"encoder.blocks.{i}", block)
    _ln_to(sd, "encoder.ln_post", enc["ln_post"])

    dec = np_params["decoder"]
    sd["decoder.token_embedding.weight"] = _t(dec["tok_emb"])
    sd["decoder.positional_embedding"] = _t(dec["pos"])
    if len(dec["blocks"]) != dims.n_text_layer:
        raise ValueError(f"{len(dec['blocks'])} decoder blocks, dims say "
                         f"{dims.n_text_layer}")
    for i, block in enumerate(dec["blocks"]):
        _block_to(sd, f"decoder.blocks.{i}", block)
    _ln_to(sd, "decoder.ln", dec["ln"])
    return sd


def _own(sd: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def encoder_from_state_dict(sd: Mapping[str, torch.Tensor], dims: WhisperDims,
                            device: torch.device | str = "cpu") -> AudioEncoder:
    """An ``AudioEncoder`` holding the ``encoder.*`` entries of an
    OpenAI-layout state dict (decoder entries are ignored)."""
    enc = AudioEncoder(dims)
    own = _own(sd, "encoder.")
    # older checkpoints may omit the (deterministic) sinusoid table
    own.setdefault("positional_embedding", enc.positional_embedding)
    enc.load_state_dict({k: v.to(torch.float32) for k, v in own.items()})
    return enc.to(device)


def decoder_from_state_dict(sd: Mapping[str, torch.Tensor], dims: WhisperDims,
                            device: torch.device | str = "cpu") -> TextDecoder:
    """A ``TextDecoder`` holding the ``decoder.*`` entries of an
    OpenAI-layout state dict (encoder entries are ignored)."""
    dec = TextDecoder(dims)
    dec.load_state_dict({k: v.to(torch.float32) for k, v in _own(sd, "decoder.").items()})
    return dec.to(device)


# ------------------------------------------------------ HuggingFace layout

# safetensors dtype names → numpy; BF16 (numpy has none) is widened below
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays: an 8-byte little-endian
    header length, a JSON header ``{name: {dtype, shape, data_offsets}}``
    (plus an optional ``__metadata__``), then the raw little-endian buffers.
    Arrays are read-only views of a memory map, so tensors never used are
    never read; BF16 tensors are widened to float32 (exactly)."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(n)))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + int(n))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = raw.view(np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{info['dtype']}")
        out[name] = arr.reshape(info["shape"])
    return out


# HF layer modules → the OpenAI (and this package's) module names; decoder
# layers add the cross-attention's
_HF_BLOCK = (("self_attn_layer_norm", "attn_ln"), ("self_attn.q_proj", "attn.query"),
             ("self_attn.k_proj", "attn.key"), ("self_attn.v_proj", "attn.value"),
             ("self_attn.out_proj", "attn.out"), ("final_layer_norm", "mlp_ln"),
             ("fc1", "mlp.0"), ("fc2", "mlp.2"))
_HF_CROSS = (("encoder_attn_layer_norm", "cross_attn_ln"),
             ("encoder_attn.q_proj", "cross_attn.query"),
             ("encoder_attn.k_proj", "cross_attn.key"),
             ("encoder_attn.v_proj", "cross_attn.value"),
             ("encoder_attn.out_proj", "cross_attn.out"))


def state_dict_from_hf(sd: Mapping, dims: WhisperDims) -> dict[str, torch.Tensor]:
    """OpenAI-layout state dict (``encoder.*`` and ``decoder.*``, f32) from a
    HuggingFace-transformers Whisper state dict (``model.encoder.*`` /
    ``model.decoder.*`` or ``encoder.*`` / ``decoder.*`` keys; numpy arrays
    or tensors), with the names
    ``freud_tpu.models.whisper.load.params_from_hf_state_dict`` maps. HF
    linears, LayerNorms, convs and embeddings share torch's layout, so
    tensors move across unchanged. A state dict without the decoder's
    entries yields the encoder's alone."""
    enc, dec = "model.encoder", "model.decoder"
    if f"{enc}.conv1.weight" not in sd and "encoder.conv1.weight" in sd:
        enc, dec = "encoder", "decoder"
    out: dict[str, torch.Tensor] = {}

    def f32(x) -> torch.Tensor:  # a tensor (maybe bf16) or a numpy array
        if isinstance(x, torch.Tensor):
            return x.detach().to(torch.float32)
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def move(src: str, dst: str) -> None:
        for suffix in ("weight", "bias"):
            if f"{src}.{suffix}" in sd:
                out[f"{dst}.{suffix}"] = f32(sd[f"{src}.{suffix}"])

    move(f"{enc}.conv1", "encoder.conv1")
    move(f"{enc}.conv2", "encoder.conv2")
    out["encoder.positional_embedding"] = f32(sd[f"{enc}.embed_positions.weight"])
    for i in range(dims.n_audio_layer):
        for theirs, ours in _HF_BLOCK:
            move(f"{enc}.layers.{i}.{theirs}", f"encoder.blocks.{i}.{ours}")
    move(f"{enc}.layer_norm", "encoder.ln_post")
    if f"{dec}.embed_tokens.weight" not in sd:
        return out
    out["decoder.token_embedding.weight"] = f32(sd[f"{dec}.embed_tokens.weight"])
    out["decoder.positional_embedding"] = f32(sd[f"{dec}.embed_positions.weight"])
    for i in range(dims.n_text_layer):
        for theirs, ours in _HF_BLOCK + _HF_CROSS:
            move(f"{dec}.layers.{i}.{theirs}", f"decoder.blocks.{i}.{ours}")
    move(f"{dec}.layer_norm", "decoder.ln")
    return out


def _hf_dims(hf_cfg: dict) -> WhisperDims:
    return WhisperDims(
        n_mels=hf_cfg["num_mel_bins"],
        n_audio_ctx=hf_cfg.get("max_source_positions", 1500),
        n_audio_state=hf_cfg["d_model"],
        n_audio_head=hf_cfg["encoder_attention_heads"],
        n_audio_layer=hf_cfg["encoder_layers"],
        n_vocab=hf_cfg["vocab_size"],
        n_text_ctx=hf_cfg.get("max_target_positions", 448),
        n_text_state=hf_cfg["d_model"],
        n_text_head=hf_cfg["decoder_attention_heads"],
        n_text_layer=hf_cfg["decoder_layers"],
    )


def hf_state_dict(path: str | Path) -> tuple[dict[str, torch.Tensor], WhisperDims]:
    """(OpenAI-layout state dict, dims) of a local HuggingFace Whisper
    checkpoint directory: ``config.json`` gives the dims,
    ``model.safetensors`` (preferred) or ``pytorch_model.bin`` the
    weights."""
    path = Path(path)
    dims = _hf_dims(json.loads((path / "config.json").read_text()))
    if (path / "model.safetensors").exists():
        sd = read_safetensors(path / "model.safetensors")
    elif (path / "pytorch_model.bin").exists():
        sd = torch.load(path / "pytorch_model.bin", map_location="cpu",
                        weights_only=True)
    else:
        raise FileNotFoundError(
            f"{path} holds config.json but neither model.safetensors nor "
            "pytorch_model.bin")
    return state_dict_from_hf(sd, dims), dims


def load_hf_dir(path: str | Path, device: torch.device | str = "cpu"
                ) -> tuple[AudioEncoder, WhisperDims]:
    """(encoder, dims) from a local HuggingFace Whisper checkpoint
    directory (``hf_state_dict``)."""
    sd, dims = hf_state_dict(path)
    return encoder_from_state_dict(sd, dims, device), dims


def _state_dict(name: str) -> tuple[Mapping | None, WhisperDims]:
    """(OpenAI-layout state dict, dims) a model name resolves to; the state
    dict is None for ``random:``/``test:`` names."""
    if name.startswith(("random:", "test:")):
        return None, dims_for(name)
    as_path = Path(name).expanduser()
    if as_path.is_dir() and (as_path / "config.json").exists():
        return hf_state_dict(as_path)
    if name not in MODEL_DIMS:
        raise ValueError(f"Unknown whisper model: {name!r}")
    path = find_checkpoint(name)
    if path is None:
        raise FileNotFoundError(
            f"No checkpoint for whisper model {name!r}. Place {name}.pt under "
            f"${_SEARCH_ENV} or ~/.cache/whisper, or use 'random:{name}' for "
            "seeded random weights."
        )
    # weights_only: the OpenAI layout is a plain {dims dict, tensor state
    # dict} — full unpickling would execute code from a tampered file
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    dims_dict = ckpt["dims"]
    dims = WhisperDims(**{k: dims_dict[k] for k in WhisperDims.__dataclass_fields__
                          if k in dims_dict})
    return ckpt["model_state_dict"], dims


def load_model(name: str, device: torch.device | str = "cpu") -> tuple[AudioEncoder, WhisperDims]:
    """Resolve a model name to (encoder, dims) on ``device``."""
    sd, dims = _state_dict(name)
    if sd is None:
        return init_encoder(dims, seed=0, device=device), dims
    return encoder_from_state_dict(sd, dims, device), dims


def load_decoder(name: str, device: torch.device | str = "cpu") -> tuple[TextDecoder, WhisperDims]:
    """Resolve a model name to (text decoder, dims) on ``device``."""
    sd, dims = _state_dict(name)
    if sd is None:
        return init_decoder(dims, seed=0, device=device), dims
    return decoder_from_state_dict(sd, dims, device), dims
