"""Model configuration for the PyTorch port.

An own copy of the JAX package's configuration tree: the model, train,
data and mesh configs, the experiment config that holds them, and its
JSON/YAML (de)serialization (``load_config``, ``save_config``,
``to_dict``; ``configs/cirr.yaml`` and ``configs/fashioniq.yaml`` beside
this module). ``RetrievalModelConfig`` also configures the captioner
(``models/blip_decoder.py``) and ``BlipBase``, as in the JAX package.
Absent: the attention-kernel switches and the ViT's scan unroll (the
port's attention always routes through its kernels, ``ops/attention.py``,
and its blocks are a Python loop) and the text encoder's ``pad_token_id``
(no port module reads it); ``load_config`` ignores them in a file.

Port-only: BLIP-2's stage-I retrieval model (``Blip2RetrievalModelConfig``,
``models/blip2_retrieval.py``), which the JAX package lacks, with the two
ViT keys its EVA ViT-g tower needs (``qkv_bias``, ``final_norm_eps``;
off by default). ``load_config`` reads a ``stage1`` that holds
``num_query_tokens`` as BLIP-2's. Kimi-VL-A3B-Instruct as a point-wise
stage-II re-ranker (``KimiVLRerankerConfig``: ``MoonViTConfig``,
``KimiLMConfig``, ``RerankTemplate``; ``models/kimi_vl.py``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


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
    # record every MED layer's attention probabilities (the reference's
    # save_attention_map hooks, med.py:129-133) into the caller's
    # ``intermediates`` dict (models/med.py::TextEncoder). Forces
    # query-major fusion so the records keep the per-query [B, H, L, M]
    # layout.
    capture_attention: bool = False
    # additionally add the caller's ``perturbations`` (zero tensors with
    # requires_grad) to the probabilities (the reference's
    # save_attn_gradients backward hook): their gradient is
    # dLoss/dAttnProbs. Same query-major forcing as capture.
    perturb_attention: bool = False
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
    # the q/k/v projections that carry a bias: 'qkv', or 'qv' (EVA ViT-g,
    # BLIP-2's tower: learned q and v biases, none on k)
    qkv_bias: str = "qkv"
    # the final LayerNorm's eps where it differs from the blocks' (BLIP-2's
    # ln_vision, 1e-5, after EVA ViT-g's 1e-6 blocks); None: layer_norm_eps
    final_norm_eps: float | None = None

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
    """'base' (ViT-B/16) or 'large' (ViT-L/16), as in reference blip.py; 'g'
    (EVA ViT-g/14, LAVIS ``eva_vit.py::create_eva_vit_g``: 39 blocks of
    1408, 16 heads of 88, MLP int(1408 * 4.3637) = 6144, q and v biases;
    its final norm is BLIP-2's ``ln_vision``, eps 1e-5)."""
    if size == "base":
        return ViTConfig(image_size=image_size, hidden_size=768, num_layers=12,
                         num_heads=12, **kw)
    if size == "large":
        return ViTConfig(image_size=image_size, hidden_size=1024, num_layers=24,
                         num_heads=16, **kw)
    if size == "g":
        return ViTConfig(image_size=image_size, patch_size=14,
                         hidden_size=1408, num_layers=39, num_heads=16,
                         mlp_ratio=4.3637, qkv_bias="qv", final_norm_eps=1e-5,
                         **kw)
    raise ValueError(f"unknown vit size {size!r} (expected 'base', 'large' "
                     "or 'g')")


@dataclass(frozen=True)
class RetrievalModelConfig:
    """Stage-I model (reference blip_stage1.py:15-93)."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    embed_dim: int = 256
    temp_init: float = 0.07
    text_len: int = 40


@dataclass(frozen=True)
class Blip2RetrievalModelConfig:
    """BLIP-2's image-text retrieval model as a stage-I model (Li et al.
    2023, arXiv:2301.12597; LAVIS ``blip2_qformer.py``,
    ``blip2_pretrain.yaml``): EVA ViT-g/14 at 224 with ``ln_vision``, and a
    BERT-base Q-Former (``text``: vocabulary 30,522 + [DEC], cross-attention
    from ``encoder_width`` 1408) with ``num_query_tokens`` learned queries,
    cross-attending in every ``cross_attention_freq``-th layer; captions of
    at most ``text_len`` tokens (LAVIS's ``max_txt_len``)."""

    vit: ViTConfig = field(default_factory=lambda: vit_config("g", 224))
    text: TextEncoderConfig = field(default_factory=lambda: TextEncoderConfig(
        vocab_size=30523, encoder_width=1408))
    num_query_tokens: int = 32
    cross_attention_freq: int = 2
    embed_dim: int = 256
    text_len: int = 32


@dataclass(frozen=True)
class RerankerModelConfig:
    """Stage-II model (reference blip_stage2.py:19-136)."""

    vit: ViTConfig = field(default_factory=lambda: ViTConfig(drop_path_rate=0.1))
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    text_len: int = 40


@dataclass(frozen=True)
class MoonViTConfig:
    """Kimi-VL's vision tower and projector (arXiv:2504.07491; SigLIP-SO400M's
    shape): ``num_layers`` pre-LN blocks of ``hidden_size`` with heads of
    72, a tanh-GELU MLP of ``intermediate_size``, a learned ``pos_grid`` x
    ``pos_grid`` position table resized to the patch grid, a 2-D rotary
    embedding of base ``rope_theta``, and a ``merge`` x ``merge`` patch
    merge into the projector's two layers."""

    image_size: int = 392
    patch_size: int = 14
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    pos_grid: int = 64
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    merge: int = 2

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class KimiLMConfig:
    """Kimi-VL's deepseek_v3 decoder (its ``config.json``'s names): MLA
    without a query latent, a dense first layer, then sigmoid-routed
    experts (``noaux_tc``, one group) with shared experts."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6        # kv_a_layernorm's (the module default)
    rope_theta: float = 800000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class RerankTemplate:
    """The fixed ids around a query's and a candidate's image tokens: a
    query is [template][media start][image][media end][caption], a
    candidate [media start][image][media end][question][assistant start],
    scored by logit(yes) - logit(no) at its last position."""

    template_ids: tuple[int, ...] = (163587, 163588, 163589)
    media_start_ids: tuple[int, ...] = (163590, 163591, 163592)
    media_end_ids: tuple[int, ...] = (163593,)
    question_ids: tuple[int, ...] = tuple(range(40, 52))
    assistant_ids: tuple[int, ...] = (163594, 163595, 163596, 163597)
    yes_id: int = 163598
    no_id: int = 163599


@dataclass(frozen=True)
class KimiVLRerankerConfig:
    """Kimi-VL-A3B-Instruct as a point-wise stage-II re-ranker
    (``models/kimi_vl.py``)."""

    vision: MoonViTConfig = field(default_factory=MoonViTConfig)
    lm: KimiLMConfig = field(default_factory=KimiLMConfig)
    template: RerankTemplate = field(default_factory=RerankTemplate)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: one data axis; ``fsdp`` shards the optimizer
    moments over it (ZeRO-style, ``runtime/optim.AdamW``)."""

    data_axis: str = "data"
    fsdp: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and run settings (reference stage2_train.py,
    utils.py:216-221)."""

    learning_rate: float = 2e-5
    min_lr: float = 0.0
    weight_decay: float = 0.05
    num_epochs: int = 40
    cosine_max_epoch: int = 10       # cosine schedule period
    batch_size: int = 512
    grad_accumulation: int = 1
    seed: int = 0
    finetune_vit: bool = False       # reference --blip-img-tune
    validation_frequency: int = 1
    bf16: bool = True


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "cirr"            # 'cirr' | 'fashioniq'
    data_root: str = ""              # holds cirr_dataset/ fashionIQ_dataset/
    image_size: int = 384
    target_ratio: float = 1.25
    transform: str = "targetpad"     # 'targetpad' | 'squarepad'
    dress_types: tuple[str, ...] = ("dress", "shirt", "toptee")
    num_workers: int = 8
    top_k_path: str = ""
    k_value: int = 50


@dataclass(frozen=True)
class ExperimentConfig:
    stage1: RetrievalModelConfig | Blip2RetrievalModelConfig = field(
        default_factory=RetrievalModelConfig)
    stage2: RerankerModelConfig = field(default_factory=RerankerModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    experiment_name: str = "exp0"
    output_dir: str = "models"


# ---------------------------------------------------------------------------
# (De)serialization

_NESTED = {
    "vit": ViTConfig,
    "text": TextEncoderConfig,
    "stage1": RetrievalModelConfig,
    "stage2": RerankerModelConfig,
    "train": TrainConfig,
    "data": DataConfig,
    "mesh": MeshConfig,
}


def _from_dict(cls, d: dict[str, Any]):
    """``cls`` from a dict: nested configs by field name (a ``stage1``
    with ``num_query_tokens`` as BLIP-2's), lists of dress types as tuples;
    keys ``cls`` has no field for are ignored."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "stage1" and "num_query_tokens" in v:
            v = _from_dict(Blip2RetrievalModelConfig, v)
        elif f.name in _NESTED:
            v = _from_dict(_NESTED[f.name], v)
        elif f.name == "dress_types":
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def to_dict(cfg) -> dict[str, Any]:
    return dataclasses.asdict(cfg)


def load_config(path: str | Path) -> ExperimentConfig:
    """An ``ExperimentConfig`` from a JSON file, or from YAML (``.yaml``,
    ``.yml``; pyyaml is imported only then)."""
    path = Path(path)
    text = path.read_text()
    if path.suffix in (".yaml", ".yml"):
        import yaml

        d = yaml.safe_load(text)
    else:
        d = json.loads(text)
    return _from_dict(ExperimentConfig, d)


def save_config(cfg, path: str | Path) -> None:
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2))
