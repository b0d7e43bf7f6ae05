"""Weights carried across into the port's modules.

Two sources, one result (a state dict that ``load_state_dict`` takes with
``strict=True`` on the port's ``RetrievalModel`` / ``RerankerModel``, or
``CaptionDecoder`` / ``BlipBase``, whose configs are
``RetrievalModelConfig`` too):

- ``from_jax_params``: the JAX package's parameter tree as nested dicts of
  numpy arrays, with scan-stacked layer axes (``blocks``, ``layers``,
  ``layers_avg``, ``layers_mlp``), HeadProjection kernels [in, H, D],
  HeadOutProjection kernels [H, D, out], Dense kernels [in, out] and
  LayerNorm ``scale``/``bias``. A ``CaptionDecoder`` tree
  (``visual_encoder``, ``text_decoder``, ``lm_head`` with ``transform``,
  ``ln``, ``decoder``) and a ``BlipBase`` tree map by the same rules.
- ``load_reference_state_dict``: the reference's key format (timm ViT with a
  fused ``qkv``, MED/BERT keys, the NLVR dual-stream keys, ``cls_head.0/2``),
  as a dict or a ``.pt`` file, including the reference's checkpoint wrapper
  ``{'epoch', '<ClassName>': sd, 'optimizer_state_dict'}`` and BLIP's
  pretrain ``{'model': sd}``. As the JAX package's converters
  (``runtime/convert.py``) do, it picks the keys the stage's model has and
  ignores the rest (the pretrain's ``text_decoder.*``, the momentum copies
  ``*_m``, the queues, BERT's ``position_ids``), resizes a position
  embedding of another grid (``interpolate_pos_embed``), and for stage II
  copies a single-stream pretrain into both streams
  (``duplicate_for_dual_stream``) and zero-initializes the merge layers it
  lacks. ``model='caption'`` reads a BLIP_Decoder's keys
  (``text_decoder.bert.*``, the LM head's ``text_decoder.cls.predictions.*``
  with the tied ``decoder.bias`` as fallback for ``bias``) and
  ``model='base'`` a BLIP_Base's (``visual_encoder.*``,
  ``text_encoder.*``), as JAX's ``convert_caption_decoder`` and
  ``convert_base`` do.

A third source, for ``models/kimi_vl.KimiVLReranker``:
``kimi_vl_state_dict`` maps the published Kimi-VL-A3B-Instruct
checkpoint's keys (``language_model.*``, ``vision_tower.*``,
``multi_modal_projector.*``) to the port's, stacking each layer's experts
and reordering the patch embedding's convolution; the tensors keep their
dtype (bf16 in the checkpoint), and ``load_state_dict`` casts the few the
port holds in float32 (norm gains, the router's correction bias).
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.config import (
    RerankerModelConfig,
    RetrievalModelConfig,
)
from candidate_reranking_cir_tpu_torch.ops.resize import resize_matrix

# HeadOutProjection module names: kernel [H, D, out] (all other 3-D kernels
# are HeadProjection [in, H, D])
_HEAD_OUT = re.compile(r"^(out|cross_dense[01])$")
_STACKED = ("blocks", "layers", "layers_avg", "layers_mlp")


def _to_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _leaf(module: str, name: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    """One JAX leaf of ``module`` -> (port parameter name, port layout)."""
    if name == "kernel":
        if a.ndim == 3 and _HEAD_OUT.match(module):
            a = a.reshape(-1, a.shape[-1])           # [H*D, out]
        else:
            a = a.reshape(a.shape[0], -1)            # [in, out] / [in, H*D]
        return "weight", a.T
    if name == "scale":
        return "weight", a
    if name == "bias":
        return "bias", a.reshape(-1)                 # HeadProjection [H, D]
    return name, a


def jax_tree_to_state(tree: Mapping, *,
                      mlp_offset: int = 0) -> dict[str, torch.Tensor]:
    """Flatten a (sub)tree of JAX params into port parameter names.

    Stacked layer axes unstack into ``blocks.{i}`` / ``layers.{i}``;
    ``layers_mlp`` continues the index at ``mlp_offset``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path: list[str], names: list[str]):
        for key, val in node.items():
            if isinstance(val, Mapping):
                if key in _STACKED:
                    base = "blocks" if key == "blocks" else "layers"
                    offset = mlp_offset if key == "layers_mlp" else 0
                    n = _stack_len(val)
                    for i in range(n):
                        walk(_index(val, i), path + [key],
                             names + [f"{base}.{offset + i}"])
                else:
                    walk(val, path + [key], names + [key])
                continue
            pname, a = _leaf(path[-1] if path else "", key,
                             np.asarray(val, np.float32))
            out[".".join(names + [pname])] = _to_tensor(a)

    walk(tree, [], [])
    return out


def _stack_len(node: Mapping) -> int:
    for val in node.values():
        return _stack_len(val) if isinstance(val, Mapping) \
            else np.asarray(val).shape[0]
    raise ValueError("empty stacked subtree")


def _index(node: Mapping, i: int) -> dict:
    return {k: (_index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in node.items()}


def from_jax_params(tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """JAX ``RetrievalModel`` / ``RerankerModel`` / ``CaptionDecoder`` /
    ``BlipBase`` params (``variables`` or ``variables['params']``) -> the
    port model's state dict."""
    if "params" in tree:
        tree = tree["params"]
    if not isinstance(cfg, (RetrievalModelConfig, RerankerModelConfig)):
        raise TypeError(f"unsupported config {type(cfg).__name__}")
    mlp_offset = min(cfg.text.merge_mlp_from, cfg.text.num_layers)
    sd = jax_tree_to_state(tree, mlp_offset=mlp_offset)
    if "temp" in sd:
        sd["temp"] = sd["temp"].reshape(())
    return sd


# ---------------------------------------------------------------------------
# reference key format

# reference key -> port key, first match wins; a key no rule matches is not
# a parameter of the stage's model and is ignored
_VIT = [
    (r"^visual_encoder\.(cls_token|pos_embed)$", r"visual_encoder.\1"),
    (r"^visual_encoder\.patch_embed\.proj\.", "visual_encoder.patch_embed.proj."),
    (r"^visual_encoder\.blocks\.(\d+)\.(norm1|norm2|mlp\.fc1|mlp\.fc2)\.",
     r"visual_encoder.blocks.\1.\2."),
    (r"^visual_encoder\.norm\.", "visual_encoder.norm."),
    (r"^visual_encoder\.blocks\.(\d+)\.attn\.proj\.",
     r"visual_encoder.blocks.\1.attn.out."),
]


def _med_shared(src: str, dst: str) -> list:
    """Embedding and FFN keys of a MED (BertModel) under ``src`` -> the
    port's encoder ``dst``; both streams of stage II share them."""
    s, layer = re.escape(src), rf"^{re.escape(src)}\.encoder\.layer\.(\d+)\."
    return [
        (rf"^{s}\.embeddings\.word_embeddings\.weight$",
         f"{dst}.embeddings.word_embeddings"),
        (rf"^{s}\.embeddings\.position_embeddings\.weight$",
         f"{dst}.embeddings.position_embeddings"),
        (rf"^{s}\.embeddings\.LayerNorm\.", f"{dst}.embeddings.ln."),
        (layer + r"intermediate\.dense\.",
         rf"{dst}.layers.\1.ffn.intermediate."),
        (layer + r"output\.dense\.", rf"{dst}.layers.\1.ffn.output."),
        (layer + r"output\.LayerNorm\.", rf"{dst}.layers.\1.ffn.ln."),
    ]


def _med_attention(src: str, dst: str) -> list:
    """Self- and cross-attention keys of a single-stream MED under ``src``
    -> the port's ``dst``."""
    layer = rf"^{re.escape(src)}\.encoder\.layer\.(\d+)\."
    return [
        (layer + r"attention\.self\.", rf"{dst}.layers.\1.self_attn.attn."),
        (layer + r"attention\.output\.dense\.",
         rf"{dst}.layers.\1.self_attn.attn.out."),
        (layer + r"attention\.output\.LayerNorm\.",
         rf"{dst}.layers.\1.self_attn.ln."),
        (layer + r"crossattention\.self\.",
         rf"{dst}.layers.\1.cross_attn.attn."),
        (layer + r"crossattention\.output\.dense\.",
         rf"{dst}.layers.\1.cross_attn.attn.out."),
        (layer + r"crossattention\.output\.LayerNorm\.",
         rf"{dst}.layers.\1.cross_attn.ln."),
    ]


_MED = _med_shared("text_encoder", "text_encoder")
_SINGLE_STREAM = _med_attention("text_encoder", "text_encoder")
_STAGE1 = [
    (r"^(vision_proj|text_proj)\.", r"\1."),
    (r"^temp$", "temp"),
]
# BLIP_Decoder: the MED under text_decoder.bert, the LM head's
# BertLMPredictionHead under text_decoder.cls.predictions
_LM_HEAD = "text_decoder.cls.predictions"
_CAPTION = [
    *_med_shared("text_decoder.bert", "text_decoder"),
    *_med_attention("text_decoder.bert", "text_decoder"),
    (r"^text_decoder\.cls\.predictions\.transform\.dense\.",
     "lm_head.transform."),
    (r"^text_decoder\.cls\.predictions\.transform\.LayerNorm\.",
     "lm_head.ln."),
    (r"^text_decoder\.cls\.predictions\.decoder\.", "lm_head.decoder."),
    (r"^text_decoder\.cls\.predictions\.bias$", "lm_head.decoder.bias"),
]
_L = r"^text_encoder\.encoder\.layer\.(\d+)\."
_STAGE2 = [
    (_L + r"attention\.self([01])\.", r"text_encoder.layers.\1.self_attn\2."),
    (_L + r"attention\.output\.dense([01])\.",
     r"text_encoder.layers.\1.self_attn\2.out."),
    (_L + r"attention\.output\.LayerNormA\.", r"text_encoder.layers.\1.self_ln0."),
    (_L + r"attention\.output\.LayerNormB\.", r"text_encoder.layers.\1.self_ln1."),
    (_L + r"crossattention\.self([01])\.query\.",
     r"text_encoder.layers.\1.cross_q\2."),
    (_L + r"crossattention\.self([01])\.key\.",
     r"text_encoder.layers.\1.cross_k\2."),
    (_L + r"crossattention\.self([01])\.value\.",
     r"text_encoder.layers.\1.cross_v\2."),
    (_L + r"crossattention\.output\.dense([01])\.",
     r"text_encoder.layers.\1.cross_dense\2."),
    (_L + r"crossattention\.output\.LayerNormA\.",
     r"text_encoder.layers.\1.cross_ln0."),
    (_L + r"crossattention\.output\.LayerNormB\.",
     r"text_encoder.layers.\1.cross_ln1."),
    (_L + r"crossattention\.output\.merge_layer\.",
     r"text_encoder.layers.\1.merge."),
    (r"^cls_head\.0\.", "cls_dense1."),
    (r"^cls_head\.2\.", "cls_dense2."),
]


def interpolate_pos_embed(pos: np.ndarray, num_patches: int) -> np.ndarray:
    """Resize a checkpoint's position embeddings [1, 1 + old_patches, D] to
    a grid of ``num_patches`` (reference vit.py:281-305; the JAX package's
    ``runtime/convert.py::interpolate_pos_embed``): the CLS row is kept,
    the square grid is resized bicubically as ``jax.image.resize`` does,
    as two separable products in float64."""
    old = pos.shape[1] - 1
    if old == num_patches:
        return pos
    dim = pos.shape[-1]
    old_size, new_size = int(old ** 0.5), int(num_patches ** 0.5)
    if old_size ** 2 != old or new_size ** 2 != num_patches:
        raise ValueError(f"pos_embed grids of {old} and {num_patches} "
                         "patches: only square grids are resized")
    grid = np.asarray(pos[0, 1:], np.float64).reshape(old_size, old_size, dim)
    r = resize_matrix(old_size, new_size)
    grid = np.einsum("ai,bj,ijd->abd", r, r, grid)
    return np.concatenate(
        [pos[:, :1], grid.reshape(1, new_size * new_size, dim)],
        axis=1).astype(np.float32)


def duplicate_for_dual_stream(sd: Mapping) -> dict:
    """The reference's single -> dual stream key duplication
    (blip_stage2.py:160-187) on a flat reference-format state dict: each
    self-/cross-attention projection, output dense and LayerNorm is copied
    into both streams' slots (self0/self1, dense0/dense1,
    LayerNormA/LayerNormB)."""
    out = dict(sd)
    for key in sd:
        if "crossattention.self." in key or "attention.self." in key:
            out[key.replace(".self.", ".self0.")] = sd[key]
            out[key.replace(".self.", ".self1.")] = sd[key]
        elif ("crossattention.output.dense." in key
              or "attention.output.dense." in key):
            out[key.replace(".dense.", ".dense0.")] = sd[key]
            out[key.replace(".dense.", ".dense1.")] = sd[key]
        if "output.LayerNorm" in key and "attention" in key:
            out[key.replace("LayerNorm", "LayerNormA")] = sd[key]
            out[key.replace("LayerNorm", "LayerNormB")] = sd[key]
    return out


def read_reference_file(path) -> dict[str, np.ndarray]:
    """A reference ``.pt`` checkpoint -> {key: array}; unwraps {'model': sd}
    and the ``{'<ClassName>': sd, 'epoch', ...}`` wrapper."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict):
        for key in ("model", "BLIP_Retrieval", "BLIP_NLVR", "BLIP_Decoder",
                    "BLIP_Base"):
            if isinstance(raw.get(key), dict):
                raw = raw[key]
                break
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in raw.items()
            if hasattr(v, "shape")}


MODELS = ("retrieval", "caption", "base")


def _numpy(val):
    return val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
        else val


def load_reference_state_dict(sd, cfg, model: str = "retrieval"
                              ) -> dict[str, torch.Tensor]:
    """Reference-format state dict (or a path to a ``.pt`` holding one) ->
    the port model's state dict, for ``RerankerModelConfig`` (stage II) or
    ``RetrievalModelConfig``, whose ``model`` is 'retrieval' (stage I),
    'caption' (``CaptionDecoder``) or 'base' (``BlipBase``)."""
    if not isinstance(sd, Mapping):
        sd = read_reference_file(sd)
    if isinstance(cfg, RetrievalModelConfig):
        if model not in MODELS:
            raise ValueError(f"unknown model {model!r}; expected one of "
                             f"{MODELS}")
        rules = _VIT + {"retrieval": _MED + _SINGLE_STREAM + _STAGE1,
                        "caption": _CAPTION,
                        "base": _MED + _SINGLE_STREAM}[model]
    elif isinstance(cfg, RerankerModelConfig):
        rules = _VIT + _MED + _STAGE2
        if "text_encoder.encoder.layer.0.attention.self0.query.weight" \
                not in sd:
            sd = duplicate_for_dual_stream(sd)
    else:
        raise TypeError(f"unsupported config {type(cfg).__name__}")
    rules = [(re.compile(p), r) for p, r in rules]
    vit = cfg.vit
    out: dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        a = np.asarray(_numpy(val), np.float32)
        if key == "visual_encoder.patch_embed.proj.weight":
            # conv [D, 3, P, P] -> space-to-depth dense [D, P*P*3]
            a = a.transpose(0, 2, 3, 1).reshape(a.shape[0], -1)
        if key == "visual_encoder.pos_embed":
            a = interpolate_pos_embed(a, vit.num_patches)
        m = re.match(r"^visual_encoder\.blocks\.(\d+)\.attn\.qkv\.(weight|bias)$",
                     key)
        if m:
            for part, chunk in zip(("query", "key", "value"),
                                   np.split(a, 3, axis=0)):
                out[f"visual_encoder.blocks.{m[1]}.attn.{part}.{m[2]}"] = \
                    _to_tensor(chunk)
            continue
        for pat, rep in rules:
            name, n = pat.subn(rep, key)
            if n:
                break
        else:
            continue  # not a parameter of this stage's model
        if name == "temp":
            a = a.reshape(())
        out[name] = _to_tensor(a)
    if model == "caption" and f"{_LM_HEAD}.bias" in sd:
        # the reference ties decoder.bias to this parameter; JAX's
        # convert_lm_head reads it first
        out["lm_head.decoder.bias"] = _to_tensor(np.asarray(
            _numpy(sd[f"{_LM_HEAD}.bias"]), np.float32))
    if isinstance(cfg, RerankerModelConfig):
        # a pretrain has no merge layers: zero, as the JAX package starts
        # them (the reference leaves them at their random init)
        d = cfg.text.hidden_size
        for i in range(cfg.text.merge_mlp_from, cfg.text.num_layers):
            out.setdefault(f"text_encoder.layers.{i}.merge.weight",
                           torch.zeros(d, 2 * d))
            out.setdefault(f"text_encoder.layers.{i}.merge.bias",
                           torch.zeros(d))
    return out


def convert_vit_npz(path_or_dict, num_layers: int, num_patches: int, *,
                    prefix: str = "") -> dict[str, torch.Tensor]:
    """An original JAX/Flax ViT checkpoint (a ``.npz`` of
    google-research/vision_transformer, or a dict of its arrays) -> the
    port ``VisionTransformer``'s state dict, its keys under ``prefix``
    ('visual_encoder.' inside a ``RetrievalModel``); the JAX package's
    ``runtime/convert.py::convert_vit_npz``, the capability of the
    reference's ``_load_weights`` (vit.py:201-278). The npz keeps the
    multi-head layout ([in, heads, head_dim] kernels), so this is a key
    map and the position embeddings resized to ``num_patches``
    (``interpolate_pos_embed``)."""
    if isinstance(path_or_dict, Mapping):
        w = dict(path_or_dict)
    else:
        with np.load(path_or_dict) as f:
            w = dict(f)
    a = lambda key: np.asarray(w[key], np.float32)
    conv = a("embedding/kernel")                     # [P, P, 3, D]
    out = {"patch_embed.proj.weight": conv.reshape(-1, conv.shape[-1]).T,
           "patch_embed.proj.bias": a("embedding/bias"),
           "cls_token": a("cls"),
           "pos_embed": interpolate_pos_embed(
               a("Transformer/posembed_input/pos_embedding"), num_patches),
           "norm.weight": a("Transformer/encoder_norm/scale"),
           "norm.bias": a("Transformer/encoder_norm/bias")}
    for i in range(num_layers):
        src = f"Transformer/encoderblock_{i}/"
        att = src + "MultiHeadDotProductAttention_1/"
        dst = f"blocks.{i}."
        for part in ("query", "key", "value"):
            kernel = a(att + f"{part}/kernel")       # [in, H, D]
            out[dst + f"attn.{part}.weight"] = \
                kernel.reshape(kernel.shape[0], -1).T
            out[dst + f"attn.{part}.bias"] = a(att + f"{part}/bias") \
                .reshape(-1)
        kernel = a(att + "out/kernel")               # [H, D, out]
        out[dst + "attn.out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
        out[dst + "attn.out.bias"] = a(att + "out/bias")
        for norm, name in (("norm1", "LayerNorm_0"),
                           ("norm2", "LayerNorm_2")):
            out[dst + f"{norm}.weight"] = a(src + f"{name}/scale")
            out[dst + f"{norm}.bias"] = a(src + f"{name}/bias")
        for fc, name in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            out[dst + f"mlp.{fc}.weight"] = \
                a(src + f"MlpBlock_3/{name}/kernel").T
            out[dst + f"mlp.{fc}.bias"] = a(src + f"MlpBlock_3/{name}/bias")
    return {prefix + k: _to_tensor(v) for k, v in out.items()}


# the published Kimi-VL checkpoint's keys -> the port's (the vision tower's
# and the projector's as HF's modeling_kimi_vl.py names them)
_KIMI_VL_KEYS = [(re.compile(a), b) for a, b in (
    (r"^vision_tower\.patch_embed\.proj\.bias$", "vision.patch_embed.bias"),
    (r"^vision_tower\.patch_embed\.pos_emb\.weight$", "vision.pos_emb"),
    (r"^vision_tower\.encoder\.blocks\.(\d+)\.wqkv\.(weight|bias)$",
     r"vision.blocks.\1.attn.qkv.\2"),
    (r"^vision_tower\.encoder\.blocks\.(\d+)\.wo\.(weight|bias)$",
     r"vision.blocks.\1.attn.proj.\2"),
    (r"^vision_tower\.encoder\.blocks\.(\d+)\.(norm0|norm1|mlp\.fc0|mlp\.fc1)"
     r"\.(weight|bias)$", r"vision.blocks.\1.\2.\3"),
    (r"^vision_tower\.encoder\.final_layernorm\.(weight|bias)$",
     r"vision.final_norm.\1"),
    (r"^multi_modal_projector\.(pre_norm|linear_1|linear_2)\.(weight|bias)$",
     r"projector.\1.\2"),
    (r"^language_model\.model\.(embed_tokens\.weight|norm\.weight)$",
     r"lm.\1"),
    (r"^language_model\.lm_head\.weight$", "lm.lm_head.weight"),
    (r"^language_model\.model\.layers\.(\d+)\.((self_attn|mlp\.gate|"
     r"mlp\.shared_experts|mlp\.(gate|up|down)_proj|input_layernorm|"
     r"post_attention_layernorm)\..*)$", r"lm.layers.\1.\2"),
)]
_KIMI_VL_EXPERT = re.compile(
    r"^language_model\.model\.layers\.(\d+)\.mlp\.experts\.(\d+)\."
    r"(gate|up|down)_proj\.weight$")


def kimi_vl_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """The published Kimi-VL checkpoint's state dict (keys as its
    safetensors name them) -> ``KimiVLReranker``'s: each MoE layer's
    experts stacked, gate and up as [E, 2F, D] (gate first), down as
    [E, D, F]; the patch embedding's convolution [D, 3, P, P] as the port's
    dense layer over (row, column, channel) patches [D, P * P * 3]. The
    rotary caches and keys the port has no place for are dropped."""
    out: dict[str, torch.Tensor] = {}
    experts: dict[int, dict] = {}
    for key, val in sd.items():
        if "rotary_emb" in key:
            continue
        val = torch.as_tensor(val)
        m = _KIMI_VL_EXPERT.match(key)
        if m:
            layer, e, kind = int(m[1]), int(m[2]), m[3]
            experts.setdefault(layer, {}).setdefault(kind, {})[e] = val
            continue
        if key == "vision_tower.patch_embed.proj.weight":
            out["vision.patch_embed.weight"] = \
                val.permute(0, 2, 3, 1).reshape(val.shape[0], -1)
            continue
        for pat, dst in _KIMI_VL_KEYS:
            if pat.match(key):
                out[pat.sub(dst, key)] = val
                break
    for layer, kinds in experts.items():
        n = len(kinds["gate"])
        prefix = f"lm.layers.{layer}.mlp.experts."
        out[prefix + "gate_up"] = torch.stack(
            [torch.cat([kinds["gate"][e], kinds["up"][e]]) for e in range(n)])
        out[prefix + "down"] = torch.stack([kinds["down"][e]
                                            for e in range(n)])
    return out
