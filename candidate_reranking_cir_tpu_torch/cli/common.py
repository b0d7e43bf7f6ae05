"""Shared CLI plumbing (own copy of the JAX package's ``cli/common.py``):
the common flags, model, tokenizer and transform construction, checkpoint
loading, and the trainers' text-width buckets.

The flag surface follows the JAX package's CLIs, with one flag of the
port's own: ``--device`` (default 'cuda'; 'cpu' runs the kernels' plain
versions). ``--fused-attention`` and ``--mesh`` are accepted for
compatibility only: the port always routes attention through its kernels
(so ``off`` is refused on the card) and runs on one device (so ``--mesh
auto`` with several cards visible is refused).
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from candidate_reranking_cir_tpu_torch.config import (
    RerankerModelConfig,
    RetrievalModelConfig,
    TextEncoderConfig,
    ViTConfig,
    vit_config,
)
from candidate_reranking_cir_tpu_torch.data.preprocessing import make_transform
from candidate_reranking_cir_tpu_torch.models.tokenizer import load_tokenizer
from candidate_reranking_cir_tpu_torch.runtime.checkpoint import (
    load_model_params,
)
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


def add_common_flags(parser: argparse.ArgumentParser):
    parser.add_argument("--dataset", type=str, required=True,
                        help="'CIRR' or 'fashionIQ'")
    parser.add_argument("--data-root", type=str, default=".",
                        help="directory containing cirr_dataset/ or "
                             "fashionIQ_dataset/")
    parser.add_argument("--target-ratio", default=1.25, type=float,
                        help="TargetPad target ratio")
    parser.add_argument("--transform", default="targetpad", type=str,
                        help="'squarepad' or 'targetpad'")
    parser.add_argument("--vocab", type=str, default="",
                        help="path to bert-base-uncased vocab.txt")
    parser.add_argument("--allow-test-vocab", action="store_true",
                        help="run with the ~90-token unit-test vocabulary "
                             "instead of a real vocab file; outputs are "
                             "meaningless; for smoke tests only (env: "
                             "CIR_ALLOW_TEST_VOCAB=1)")
    parser.add_argument("--vit", type=str, default="base")
    parser.add_argument("--image-size", type=int, default=384)
    parser.add_argument("--text-len", type=int, default=40,
                        help="static text bucket length")
    parser.add_argument("--text-overflow", type=str, default="error",
                        choices=["error", "warn", "truncate"],
                        help="what to do when a caption exceeds --text-len: "
                             "fail (default), truncate with a counted "
                             "warning, or silently clip")
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--dress-types", type=str, nargs="+",
                        default=["dress", "shirt", "toptee"],
                        help="Fashion-IQ categories the trainers train on")
    parser.add_argument("--fused-attention", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="accepted for compatibility with the JAX "
                             "package's CLIs: 'auto' and 'on' are the same "
                             "(the kernels on the card, their plain versions "
                             "on the CPU); 'off' is the same as 'auto' on "
                             "the CPU and refused on the card")
    parser.add_argument("--mesh", type=str, default="auto",
                        choices=["auto", "off"],
                        help="accepted for compatibility with the JAX "
                             "package's CLIs: 'auto' and 'off' are the same "
                             "on one card; 'auto' with several cards visible "
                             "is refused (the mesh paths are not ported)")
    parser.add_argument("--model-config", type=str, default="",
                        help="JSON overriding model dims: "
                             '{"vit": {...}, "text": {...}, "embed_dim": N}')
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the models run (default: the CUDA card; "
                             "'cpu' runs the kernels' plain versions)")
    return parser


def _model_overrides(args) -> dict:
    if not getattr(args, "model_config", ""):
        return {}
    return json.loads(Path(args.model_config).read_text())


def get_device(args) -> torch.device:
    """Resolve --device (raises for 'cuda' without a card), checking
    --fused-attention and --mesh against what the port runs."""
    device = resolve_device(args.device)
    if args.fused_attention == "off" and device.type == "cuda":
        raise NotImplementedError(
            "--fused-attention off: the port has no attention route on the "
            "card that skips its kernels")
    if args.mesh == "auto" and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--mesh auto over several cards is not ported; pass --mesh off "
            "to run on one card")
    return device


def _dtype(args):
    return torch.bfloat16 if args.bf16 else torch.float32


def build_stage1(args, *, remat: bool = False):
    """The port's stage-I ``RetrievalModel`` on --device, and its config.
    ``remat`` (the trainer's) recomputes the ViT's blocks and the MED's
    layers in backward with policy '': at stage I's B = 512, keeping the
    products' outputs ('dots') would hold the cross-attention K/V
    projections of every layer."""
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    ov = _model_overrides(args)
    vit = (ViTConfig(**{"remat": remat, **ov["vit"]}) if "vit" in ov
           else vit_config(args.vit, args.image_size, remat=remat))
    text = TextEncoderConfig(**{"remat": remat, **ov.get("text", {})})
    cfg = RetrievalModelConfig(vit=vit, text=text,
                               embed_dim=ov.get("embed_dim", 256),
                               text_len=args.text_len)
    return RetrievalModel(cfg, dtype=_dtype(args),
                          device=get_device(args)), cfg


def build_stage2(args, *, remat: bool = False):
    """The port's stage-II ``RerankerModel`` on --device, and its config.
    ``remat`` (the trainer's) recomputes the ViT's blocks and the dual
    encoder's layers in backward with policy 'dots', as the JAX package's
    stage-II trainer does."""
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )

    ov = _model_overrides(args)
    policy = "dots" if remat else ""
    vit = (ViTConfig(**{"remat": remat, "remat_policy": policy,
                        **ov["vit"]}) if "vit" in ov
           else vit_config(args.vit, args.image_size, drop_path_rate=0.1,
                           remat=remat, remat_policy=policy))
    text = TextEncoderConfig(**{"remat": remat, "remat_policy": policy,
                                **ov.get("text", {})})
    cfg = RerankerModelConfig(vit=vit, text=text, text_len=args.text_len)
    return RerankerModel(cfg, dtype=_dtype(args),
                         device=get_device(args)), cfg


def load_params(path: str, stage: int, cfg) -> dict[str, torch.Tensor]:
    """``runtime/checkpoint.py::load_model_params``: a checkpoint directory
    of the port's trainers or a reference-format ``.pt`` -> the port's
    state dict for ``cfg``."""
    return load_model_params(path, stage, cfg)


def get_transform(args):
    return make_transform(args.transform, args.image_size, args.target_ratio)


def get_tokenizer(args):
    allow_test = (getattr(args, "allow_test_vocab", False)
                  or os.environ.get("CIR_ALLOW_TEST_VOCAB") == "1")
    tok = load_tokenizer(args.vocab or None, allow_test_vocab=allow_test)
    if allow_test and not args.vocab:
        print("WARNING: running with the unit-test toy vocabulary "
              "(--allow-test-vocab); all text-derived outputs are "
              "meaningless", flush=True)
    tok.overflow = getattr(args, "text_overflow", "error")
    return tok


def prescan_captions(tokenizer, dataset, text_len: int, dataset_name: str):
    """Apply the caption-overflow policy to a whole train split before the
    first step, so that an over-long caption fails at start-up, not hours
    into an epoch. For Fashion-IQ the longest random compositions (both
    two-caption orders) are scanned."""
    if dataset_name == "cirr":
        caps = [t["caption"] for t in dataset.triplets]
    else:
        from candidate_reranking_cir_tpu_torch.data.captions import (
            fiq_longest_compositions,
        )

        caps = fiq_longest_compositions(
            [t["captions"] for t in dataset.triplets])
    if caps:
        tokenizer.encode(caps, text_len)


def parse_l_buckets(spec: str):
    """--l-buckets value -> the schedulers' l_buckets argument: 'auto',
    'off' (None, the single --text-len bucket), or '16,24,40'."""
    if spec == "auto":
        return "auto"
    if spec in ("off", "none"):
        return None
    return tuple(int(b) for b in spec.split(","))


def print_metrics(metrics: dict):
    for k, v in metrics.items():
        print(f"{k} = {v:.2f}")


def parse_text_buckets(spec: str, text_len: int) -> tuple[int, ...]:
    """Static per-batch text-width buckets for the trainers. 'auto' cuts at
    ~60%/80%/100% of ``text_len`` (multiples of 8); 'off' -> () keeps the
    single static bucket; else a comma list such as '24,32'."""
    if spec in ("off", "none"):
        return ()
    if spec == "auto":
        cand = {min(-(-int(text_len * f) // 8) * 8, text_len)
                for f in (0.6, 0.8)}
    else:
        cand = {int(b) for b in spec.split(",") if int(b) <= text_len}
    cand.add(text_len)
    return tuple(sorted(cand))


def text_bucket_slice(ids, mask, buckets: tuple[int, ...]):
    """Slice a pad-to-text_len batch (arrays or tensors) down to the
    smallest bucket holding its longest caption. The reference trains
    pad-to-longest per batch (blip_stage1.py:72); a fixed bucket set keeps
    the set of shapes small while recovering most of that saving. Numerics
    per real token are unchanged (pad keys are additively masked)."""
    if not buckets:
        return ids, mask
    max_len = int(mask.sum(axis=1).max())
    lb = next((b for b in buckets if b >= max_len), ids.shape[1])
    return ids[:, :lb], mask[:, :lb]
