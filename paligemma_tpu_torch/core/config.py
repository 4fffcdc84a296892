"""Frozen model configurations (the port's own copy of
paligemma_tpu/core/config.py).

The reference's config classes (ref: modeling_siglip.py:10-38,
modeling_gemma.py:68-99, modeling_paligemma.py:14-45) as immutable
dataclasses, constructible from an HF checkpoint's ``config.json``. The
port keeps its own copy, field for field, so it imports nothing of the JAX
package; tests/test_torch_train.py holds every factory against the JAX one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP vision-tower hyperparameters (ref: modeling_siglip.py:10-38)."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    attention_dropout: float = 0.0
    layer_norm_eps: float = 1e-6
    num_image_tokens: Optional[int] = None
    projection_dim: int = 2048

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    """Gemma decoder hyperparameters (ref: modeling_gemma.py:68-99)."""

    vocab_size: int = 257152
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attention_bias: bool = False
    attention_dropout: float = 0.0
    pad_token_id: Optional[int] = 0
    num_image_tokens: Optional[int] = None

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class PaliGemmaConfig:
    """Composite VLM config (ref: modeling_paligemma.py:14-45).

    Mirrors the HF ``config.json`` of google/paligemma-3b-pt-224: the text
    config's ``num_image_tokens`` is derived from the vision geometry and the
    vision config inherits ``projection_dim``.
    """

    vision_config: SiglipVisionConfig = dataclasses.field(
        default_factory=SiglipVisionConfig
    )
    text_config: GemmaConfig = dataclasses.field(default_factory=GemmaConfig)
    projection_dim: int = 2048
    ignore_index: int = -100
    image_token_index: int = 256000
    pad_token_id: int = 0
    vocab_size: int = 257152
    hidden_size: int = 2048

    def __post_init__(self):
        num_image_tokens = self.vision_config.num_patches
        object.__setattr__(
            self,
            "vision_config",
            dataclasses.replace(
                self.vision_config,
                num_image_tokens=num_image_tokens,
                projection_dim=self.projection_dim,
            ),
        )
        object.__setattr__(
            self,
            "text_config",
            dataclasses.replace(
                self.text_config,
                pad_token_id=self.pad_token_id,
                num_image_tokens=num_image_tokens,
            ),
        )
        object.__setattr__(self, "vocab_size", self.text_config.vocab_size)

    # ------------------------------------------------------------------
    # HF config.json interop
    # ------------------------------------------------------------------
    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "PaliGemmaConfig":
        """Build from a parsed HF ``config.json`` (ref: utils.py:25-27)."""
        vision_d = dict(d.get("vision_config", {}))
        text_d = dict(d.get("text_config", {}))
        vision_fields = {f.name for f in dataclasses.fields(SiglipVisionConfig)}
        text_fields = {f.name for f in dataclasses.fields(GemmaConfig)}
        # HF text_config may use "max_position_embeddings" already; also accept
        # the reference's "max_position_encodings" spelling.
        if "max_position_encodings" in text_d:
            text_d["max_position_embeddings"] = text_d.pop("max_position_encodings")
        vision_cfg = SiglipVisionConfig(
            **{k: v for k, v in vision_d.items() if k in vision_fields}
        )
        text_cfg = GemmaConfig(
            **{k: v for k, v in text_d.items() if k in text_fields}
        )
        return cls(
            vision_config=vision_cfg,
            text_config=text_cfg,
            projection_dim=d.get("projection_dim", 2048),
            ignore_index=d.get("ignore_index", -100),
            image_token_index=d.get("image_token_index", 256000),
            pad_token_id=d.get("pad_token_id", 0) or 0,
            vocab_size=d.get("vocab_size", 257152),
            hidden_size=d.get("hidden_size", 2048),
        )

    @classmethod
    def from_hf_json(cls, path: str) -> "PaliGemmaConfig":
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))


def paligemma_3b_224() -> PaliGemmaConfig:
    """The google/paligemma-3b-pt-224 architecture (SigLIP-So400m/14 + Gemma-2B)."""
    return PaliGemmaConfig(
        vision_config=SiglipVisionConfig(
            hidden_size=1152,
            intermediate_size=4304,
            num_hidden_layers=27,
            num_attention_heads=16,
            patch_size=14,
            image_size=224,
        ),
        text_config=GemmaConfig(
            hidden_size=2048,
            intermediate_size=16384,
            num_hidden_layers=18,
            num_attention_heads=8,
            num_key_value_heads=1,
            head_dim=256,
        ),
        projection_dim=2048,
        hidden_size=2048,
    )


def paligemma_3b_448() -> PaliGemmaConfig:
    """448px variant: 1024 image tokens."""
    cfg = paligemma_3b_224()
    return dataclasses.replace(
        cfg,
        vision_config=dataclasses.replace(cfg.vision_config, image_size=448),
    )


def paligemma_3b_896() -> PaliGemmaConfig:
    """896px variant: 4096 image tokens (google/paligemma-3b-pt-896 — the
    highest-resolution official checkpoint, used for OCR/detail tasks).
    Same towers; only image_size differs, exactly like the HF config."""
    cfg = paligemma_3b_224()
    return dataclasses.replace(
        cfg,
        vision_config=dataclasses.replace(cfg.vision_config, image_size=896),
    )


def tiny_test_config(vocab_size: int = 512) -> PaliGemmaConfig:
    """Tiny random-weight config for fast unit tests."""
    return PaliGemmaConfig(
        vision_config=SiglipVisionConfig(
            image_size=28,
            patch_size=14,
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
        ),
        text_config=GemmaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
        ),
        projection_dim=64,
        hidden_size=64,
        image_token_index=vocab_size - 2,
        vocab_size=vocab_size,
    )
