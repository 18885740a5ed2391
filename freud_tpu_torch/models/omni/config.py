"""Uni-MoE-2.0-Omni's geometry: its language model, its audio tower and
the audio prompt a clip is read in.

``OmniConfig.from_hf`` reads the model's HuggingFace ``config.json``
(``model_type`` ``grin_qwen2_vl``, HIT-TMG's Uni-MoE-2.0-Omni) with two keys
of this package's own: ``audio_tower`` (the Whisper encoder's dims; default
large-v3's, at ``whisper_hidden_size``) and ``audio_prompt`` (the token ids
around a clip's audio tokens; default none). Qwen2's conventions fill what
the config leaves out: the head size is ``hidden_size`` over the heads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..whisper.config import MODEL_DIMS, WhisperDims

MODEL_TYPE = "grin_qwen2_vl"
OMNI_MODELS = ("uni-moe-2.0-omni",)
TOWER_FRAMES_PER_S = 50  # Whisper encoder frames a second of audio


@dataclass(frozen=True)
class OmniConfig:
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    rms_norm_eps: float
    rope_theta: float
    mrope_section: tuple
    vocab_size: int
    n_dynamic: int          # mlp_dynamic_expert_num
    dynamic_width: int      # dynamic_intermediate_size
    n_null: int             # mlp_dynamic_null_expert_num
    top_p: float            # mlp_dynamic_top_p
    top_k: int              # mlp_dynamic_top_k
    n_fixed: int            # mlp_fixed_expert_num
    fixed_width: int        # shared_intermediate_size
    query_tokens: int       # whisper_query_tokens_size: audio tokens a clip
    audio_time: int         # whisper_audio_time: seconds of audio a clip
    tower: WhisperDims
    prefix_ids: tuple = ()
    suffix_ids: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def n_router(self) -> int:
        """Router outputs: the dynamic experts, then the null ones."""
        return self.n_dynamic + self.n_null

    @property
    def pool(self) -> int:
        """Tower frames pooled into one audio token."""
        return self.audio_time * TOWER_FRAMES_PER_S // self.query_tokens

    @property
    def audio_start(self) -> int:
        """Position of a clip's first audio token in its sequence."""
        return len(self.prefix_ids)

    @property
    def seq_len(self) -> int:
        return len(self.prefix_ids) + self.query_tokens + len(self.suffix_ids)

    @classmethod
    def from_hf(cls, cfg: dict) -> "OmniConfig":
        if cfg.get("model_type", MODEL_TYPE) != MODEL_TYPE:
            raise ValueError(f"model_type {cfg.get('model_type')!r} is not {MODEL_TYPE!r}")
        rope = cfg.get("rope_scaling") or {}
        tower = cfg.get("audio_tower")
        if tower is None:
            tower = dataclasses.replace(MODEL_DIMS["large-v3"],
                                        n_audio_state=cfg["whisper_hidden_size"])
        else:
            tower = WhisperDims(**tower)
        prompt = cfg.get("audio_prompt") or {}
        c = cls(
            hidden_size=cfg["hidden_size"], num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg["num_key_value_heads"],
            rms_norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
            mrope_section=tuple(rope.get("mrope_section", ())),
            vocab_size=cfg["vocab_size"], n_dynamic=cfg["mlp_dynamic_expert_num"],
            dynamic_width=cfg["dynamic_intermediate_size"],
            n_null=cfg["mlp_dynamic_null_expert_num"], top_p=cfg["mlp_dynamic_top_p"],
            top_k=cfg["mlp_dynamic_top_k"], n_fixed=cfg["mlp_fixed_expert_num"],
            fixed_width=cfg["shared_intermediate_size"],
            query_tokens=cfg["whisper_query_tokens_size"],
            audio_time=cfg["whisper_audio_time"], tower=tower,
            prefix_ids=tuple(prompt.get("prefix_ids", ())),
            suffix_ids=tuple(prompt.get("suffix_ids", ())))
        c.check()
        return c

    def check(self) -> None:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must divide by num_key_value_heads")
        if sum(self.mrope_section) != self.head_dim // 2:
            raise ValueError(f"mrope_section {self.mrope_section} must sum to half the head "
                             f"size ({self.head_dim // 2})")
        if self.pool < 1:
            raise ValueError("fewer tower frames than query tokens in a clip")
        if self.pool * self.query_tokens > self.tower.n_audio_ctx:
            raise ValueError(f"{self.query_tokens} tokens of {self.pool} frames exceed the "
                             f"tower's {self.tower.n_audio_ctx} frames")
