"""Model configuration for the PyTorch port.

An own copy of the eval-relevant fields of the JAX package's configuration
tree. Training-only fields (dropout, remat, attention capture) and the
attention-kernel switch are absent: the port evaluates only, and its
attention always goes through the kernels of ``ops/cuda_attention.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class TextEncoderConfig:
    """BERT-family encoder hyperparameters (reference configs/med_config.json)."""

    vocab_size: int = 30524          # 30522 bert-base-uncased + [DEC] + [ENC]
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 768         # width of cross-attended (image) features
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # dual-stream re-ranker only: layers >= merge_mlp_from merge the twin
    # cross-attention outputs with an MLP; earlier layers average them
    merge_mlp_from: int = 6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class ViTConfig:
    """ViT hyperparameters (reference vit.py:113-194, blip.py:194-209)."""

    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def vit_config(size: str = "base", image_size: int = 384, **kw) -> ViTConfig:
    """'base' (ViT-B/16) or 'large' (ViT-L/16), as in reference blip.py."""
    if size == "base":
        return ViTConfig(image_size=image_size, hidden_size=768, num_layers=12,
                         num_heads=12, **kw)
    if size == "large":
        return ViTConfig(image_size=image_size, hidden_size=1024, num_layers=24,
                         num_heads=16, **kw)
    raise ValueError(f"unknown vit size {size!r} (expected 'base' or 'large')")


@dataclass(frozen=True)
class RetrievalModelConfig:
    """Stage-I model (reference blip_stage1.py:15-93)."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    embed_dim: int = 256
    temp_init: float = 0.07
    text_len: int = 40


@dataclass(frozen=True)
class RerankerModelConfig:
    """Stage-II model (reference blip_stage2.py:19-136)."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    text_len: int = 40
