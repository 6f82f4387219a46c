"""Model configuration dataclasses: the port's own copy of the JAX package's.

Counterpart of long_vita_tpu/config.py, field for field (names, defaults,
properties, ``from_hf_config``/``from_json``). The geometry matches the
released Long-VITA HF checkpoints (config_14B.json): a Qwen2.5-14B decoder and
an InternViT-300M-448px vision tower. The port imports nothing of the JAX
package, so it keeps this copy; tests/test_torch_config.py holds the two
packages' configurations equal, field by field.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """InternViT geometry (config_14B.json "visual" block)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"
    qkv_bias: bool = True
    qk_normalization: bool = False
    norm_type: str = "layer_norm"
    initializer_factor: float = 1.0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size  # 32

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid  # 1024

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # 1025 (CLS + patches)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Qwen2.5 decoder geometry (config_14B.json top level)."""

    vocab_size: int = 152064
    hidden_size: int = 5120
    intermediate_size: int = 13824
    num_hidden_layers: int = 48
    num_attention_heads: int = 40
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    max_position_embeddings: int = 1310720
    tie_word_embeddings: bool = False
    attention_bias: bool = True  # Qwen2 uses bias on q/k/v projections
    hidden_act: str = "silu"
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    # Mixture-of-experts; num_experts == 0 keeps the dense SwiGLU MLP
    # (ops/moe.py): over a mesh, expert parallelism over dp (dp divides
    # num_experts), the experts' ffn over tp, one routing batch over cp
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    # LoRA: lora_r == 0 means no adapters; else each projection that carries
    # an adapter adds ((x @ a) @ b) * lora_alpha / lora_r (training/lora.py)
    lora_r: int = 0
    lora_alpha: int = 32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class LongVITAConfig:
    """Full VLM: decoder + vision tower + pixel-shuffle projector."""

    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    vision: Optional[VisionConfig] = dataclasses.field(default_factory=VisionConfig)
    vision_downsample_ratio: float = 0.5
    image_token_length: int = 256

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "LongVITAConfig":
        """Build from an HF config.json dict (LongVITAConfig schema)."""
        text_fields = {f.name for f in dataclasses.fields(TextConfig)}
        text = TextConfig(**{k: v for k, v in cfg.items() if k in text_fields})
        vision = None
        if "visual" in cfg:
            vis_fields = {f.name for f in dataclasses.fields(VisionConfig)}
            vision = VisionConfig(
                **{k: v for k, v in cfg["visual"].items() if k in vis_fields}
            )
        return cls(text=text, vision=vision)

    @classmethod
    def from_json(cls, path: str) -> "LongVITAConfig":
        with open(path) as f:
            return cls.from_hf_config(json.load(f))


def long_vita_14b() -> LongVITAConfig:
    """The released 14B geometry."""
    return LongVITAConfig()


def long_vita_72b() -> LongVITAConfig:
    """Qwen2.5-72B decoder + InternViT-300M (JAX config.py:122; reference
    scripts/megatron/qwen25/finetune_qwen25_72b_..._tp8pp8_stage1.sh), the
    geometry of configs/stage{1,2}_72b_tp8fsdp8.yaml."""
    return LongVITAConfig(
        text=TextConfig(
            hidden_size=8192,
            intermediate_size=29568,
            num_hidden_layers=80,
            num_attention_heads=64,
            num_key_value_heads=8,
        )
    )


def tiny_test_config(vocab_size: int = 512, num_experts: int = 0) -> LongVITAConfig:
    """A miniature geometry for fast tests (same structural shape)."""
    return LongVITAConfig(
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            rope_theta=1e4,
            max_position_embeddings=2048,
            num_experts=num_experts,
        ),
        vision=VisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=2,
            image_size=56,
            patch_size=14,
        ),
        image_token_length=4,
    )


__all__ = [
    "LongVITAConfig", "TextConfig", "VisionConfig", "long_vita_14b", "long_vita_72b",
    "tiny_test_config",
]
