"""SAE configuration schema.

Field-for-field parity with the reference's dataclasses
(src/models/config.py:5-28) including the ``from_dict`` behavior of silently
dropping unknown keys — the shipped train configs carry
``dead_feature_threshold`` inside ``autoencoder_config`` which the schema does
not own (it is read from the raw dict by the trainer; see
reference train_sae.py:437-438 and configs/train/tiny_topk.json:11).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields


@dataclass
class AutoEncoderConfig:
    expansion_factor: int = 32
    n_dict_components: int = 0  # 0 → activation_size * expansion_factor

    @classmethod
    def from_dict(cls, d: dict):
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class L1AutoEncoderConfig(AutoEncoderConfig):
    recon_alpha: float = 1.0


@dataclass
class TopKAutoEncoderConfig(AutoEncoderConfig):
    normalize_decoder: bool = True
    k: int = 32
    multi_topk: bool = False
    auxk_alpha: float = 0.0


def get_n_dict_components(
    activation_size: int, expansion_factor: int, n_dict_components: int
) -> int:
    """Dictionary size rule (reference src/utils/models.py:1-6)."""
    if n_dict_components == 0:
        return activation_size * expansion_factor
    return n_dict_components


def config_for_variant(variant: str, raw: dict) -> AutoEncoderConfig:
    if variant == "l1":
        return L1AutoEncoderConfig.from_dict(raw)
    if variant == "topk":
        return TopKAutoEncoderConfig.from_dict(raw)
    raise ValueError(f"Invalid autoencoder variant: {variant!r}, must be 'l1' or 'topk'")
