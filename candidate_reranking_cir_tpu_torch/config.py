"""Model configuration for the PyTorch port.

An own copy of the fields of the JAX package's configuration tree that the
port reads. Absent: the attention-kernel switch (the port's attention
always routes through its kernels, ``ops/attention.py``), attention
capture, and the options of paths not ported yet.
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
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    # dual-stream re-ranker only: layers >= merge_mlp_from merge the twin
    # cross-attention outputs with an MLP; earlier layers average them
    merge_mlp_from: int = 6
    # recompute each encoder layer in backward (torch.utils.checkpoint)
    remat: bool = False
    # checkpoint policy under remat (models/layers.py::resolve_remat_policy):
    # '' recomputes everything (least memory); 'dots' keeps the outputs of
    # the products without batch dimensions (the Dense projections and the
    # FFN) and recomputes attention and the elementwise work
    remat_policy: str = ""

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
    dropout: float = 0.0
    attention_dropout: float = 0.0
    drop_path_rate: float = 0.0      # stage-II uses 0.1 (reference blip_stage2.py:37)
    remat: bool = False              # recompute each block in backward
    remat_policy: str = ""           # '' | 'dots' (see TextEncoderConfig)

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

    vit: ViTConfig = field(default_factory=lambda: ViTConfig(drop_path_rate=0.1))
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    text_len: int = 40


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer settings (reference stage2_train.py, utils.py:216-221)."""

    learning_rate: float = 2e-5
    min_lr: float = 0.0
    weight_decay: float = 0.05
    cosine_max_epoch: int = 10       # cosine schedule period
    grad_accumulation: int = 1
