"""LongCat-Flash-Omni's geometry: its language model, the share of its
routed experts this card holds, its audio tower and the audio prompt a clip
is read in.

``LongCatConfig.from_hf`` reads the model's HuggingFace ``config.json``
(Meituan's LongCat-Flash family, ``model_type`` ``longcat_flash``) with keys
of this package's own: ``deployment`` (the expert-parallel share: the
published ``n_routed_experts`` the router scores and the ``held_experts``
range [lo, hi) whose weights this card holds; without it the card holds
every routed expert, and the file's ``n_routed_experts`` is the published
count), ``audio_tower`` (the Whisper encoder's dims; default large-v3's),
``audio_tokens`` and ``audio_seconds`` (the tokens a clip of that many
seconds becomes) and ``audio_prompt`` (the token ids around a clip's audio
tokens; default none).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from ..whisper.config import MODEL_DIMS, WhisperDims

MODEL_TYPE = "longcat_flash"
LONGCAT_MODELS = ("longcat-flash-omni",)
TOWER_FRAMES_PER_S = 50  # Whisper encoder frames a second of audio


@dataclass(frozen=True)
class LongCatConfig:
    hidden_size: int
    num_hidden_layers: int      # num_layers: double layers
    num_attention_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    mla_scale_q_lora: bool
    mla_scale_kv_lora: bool
    rms_norm_eps: float
    rope_theta: float
    vocab_size: int
    ffn_width: int              # ffn_hidden_size: each dense FFN
    expert_width: int           # expert_ffn_hidden_size
    n_routed: int               # routed experts the router scores (published)
    n_zero: int                 # zero_expert_num: identity entries after them
    top_k: int                  # moe_topk
    routed_scale: float         # routed_scaling_factor
    held: tuple                 # [lo, hi): routed experts held here
    query_tokens: int           # audio_tokens: audio tokens a clip
    audio_time: int             # audio_seconds: seconds of audio a clip
    tower: WhisperDims
    prefix_ids: tuple = ()
    suffix_ids: tuple = ()

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_router(self) -> int:
        """Router outputs: the routed experts, then the identity entries."""
        return self.n_routed + self.n_zero

    @property
    def n_held(self) -> int:
        return self.held[1] - self.held[0]

    @property
    def identity(self) -> tuple:
        return (self.n_routed, self.n_router)

    @property
    def q_scale(self) -> float:
        """The LoRA scale of q, √(d / q_lora_rank), or 1."""
        return math.sqrt(self.hidden_size / self.q_lora_rank) if self.mla_scale_q_lora else 1.0

    @property
    def kv_scale(self) -> float:
        """The LoRA scale of the normed kv latent, √(d / kv_lora_rank), or 1."""
        return math.sqrt(self.hidden_size / self.kv_lora_rank) if self.mla_scale_kv_lora else 1.0

    @property
    def pool(self) -> int:
        """Tower frames pooled into one audio token."""
        return self.audio_time * TOWER_FRAMES_PER_S // self.query_tokens

    @property
    def audio_start(self) -> int:
        return len(self.prefix_ids)

    @property
    def seq_len(self) -> int:
        return len(self.prefix_ids) + self.query_tokens + len(self.suffix_ids)

    @classmethod
    def from_hf(cls, cfg: dict) -> "LongCatConfig":
        if cfg.get("model_type", MODEL_TYPE) != MODEL_TYPE:
            raise ValueError(f"model_type {cfg.get('model_type')!r} is not {MODEL_TYPE!r}")
        if cfg.get("zero_expert_type", "identity") != "identity":
            raise ValueError(f"zero_expert_type {cfg['zero_expert_type']!r}: only identity "
                             "zero experts are supported")
        dep = cfg.get("deployment") or {}
        n_routed = dep.get("n_routed_experts", cfg["n_routed_experts"])
        held = tuple(dep.get("held_experts", (0, cfg["n_routed_experts"])))
        tower = cfg.get("audio_tower")
        tower = MODEL_DIMS["large-v3"] if tower is None else WhisperDims(**tower)
        prompt = cfg.get("audio_prompt") or {}
        c = cls(
            hidden_size=cfg["hidden_size"], num_hidden_layers=cfg["num_layers"],
            num_attention_heads=cfg["num_attention_heads"], q_lora_rank=cfg["q_lora_rank"],
            kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
            qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
            mla_scale_q_lora=bool(cfg.get("mla_scale_q_lora", False)),
            mla_scale_kv_lora=bool(cfg.get("mla_scale_kv_lora", False)),
            rms_norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
            vocab_size=cfg["vocab_size"], ffn_width=cfg["ffn_hidden_size"],
            expert_width=cfg["expert_ffn_hidden_size"], n_routed=n_routed,
            n_zero=cfg.get("zero_expert_num", 0), top_k=cfg["moe_topk"],
            routed_scale=float(cfg.get("routed_scaling_factor", 1.0)), held=held,
            query_tokens=cfg.get("audio_tokens", 375), audio_time=cfg.get("audio_seconds", 30),
            tower=dataclasses.replace(tower), prefix_ids=tuple(prompt.get("prefix_ids", ())),
            suffix_ids=tuple(prompt.get("suffix_ids", ())))
        c.check(cfg["n_routed_experts"])
        return c

    def check(self, n_file: int) -> None:
        lo, hi = self.held
        if not 0 <= lo < hi <= self.n_routed or hi - lo != n_file:
            raise ValueError(f"held experts [{lo}, {hi}) must lie in the router's "
                             f"{self.n_routed} and number n_routed_experts ({n_file})")
        if self.top_k > self.n_router:
            raise ValueError(f"moe_topk {self.top_k} exceeds the router's {self.n_router}")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even")
        if self.pool < 1 or self.pool * self.query_tokens > self.tower.n_audio_ctx:
            raise ValueError(f"{self.query_tokens} audio tokens of {self.audio_time} s do not "
                             f"fit the tower's {self.tower.n_audio_ctx} frames")
