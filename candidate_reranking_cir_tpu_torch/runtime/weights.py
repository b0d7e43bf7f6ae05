"""Weights carried across into the port's modules.

Two sources, one result (a state dict that ``load_state_dict`` takes with
``strict=True`` on the port's ``RetrievalModel`` / ``RerankerModel``):

- ``from_jax_params``: the JAX package's parameter tree as nested dicts of
  numpy arrays, with scan-stacked layer axes (``blocks``, ``layers``,
  ``layers_avg``, ``layers_mlp``), HeadProjection kernels [in, H, D],
  HeadOutProjection kernels [H, D, out], Dense kernels [in, out] and
  LayerNorm ``scale``/``bias``.
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
  lacks.
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
    """JAX ``RetrievalModel`` / ``RerankerModel`` params (``variables`` or
    ``variables['params']``) -> the port model's state dict."""
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
_COMMON = [
    (r"^visual_encoder\.(cls_token|pos_embed)$", r"visual_encoder.\1"),
    (r"^visual_encoder\.patch_embed\.proj\.", "visual_encoder.patch_embed.proj."),
    (r"^visual_encoder\.blocks\.(\d+)\.(norm1|norm2|mlp\.fc1|mlp\.fc2)\.",
     r"visual_encoder.blocks.\1.\2."),
    (r"^visual_encoder\.norm\.", "visual_encoder.norm."),
    (r"^visual_encoder\.blocks\.(\d+)\.attn\.proj\.",
     r"visual_encoder.blocks.\1.attn.out."),
    (r"^(text_encoder)\.embeddings\.word_embeddings\.weight$",
     r"\1.embeddings.word_embeddings"),
    (r"^(text_encoder)\.embeddings\.position_embeddings\.weight$",
     r"\1.embeddings.position_embeddings"),
    (r"^(text_encoder)\.embeddings\.LayerNorm\.", r"\1.embeddings.ln."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.intermediate\.dense\.",
     r"text_encoder.layers.\1.ffn.intermediate."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.output\.dense\.",
     r"text_encoder.layers.\1.ffn.output."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.output\.LayerNorm\.",
     r"text_encoder.layers.\1.ffn.ln."),
]
_STAGE1 = [
    (r"^(vision_proj|text_proj)\.", r"\1."),
    (r"^temp$", "temp"),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.attention\.self\.",
     r"text_encoder.layers.\1.self_attn.attn."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.attention\.output\.dense\.",
     r"text_encoder.layers.\1.self_attn.attn.out."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.",
     r"text_encoder.layers.\1.self_attn.ln."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.crossattention\.self\.",
     r"text_encoder.layers.\1.cross_attn.attn."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.crossattention\.output\.dense\.",
     r"text_encoder.layers.\1.cross_attn.attn.out."),
    (r"^text_encoder\.encoder\.layer\.(\d+)\.crossattention\.output"
     r"\.LayerNorm\.", r"text_encoder.layers.\1.cross_attn.ln."),
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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s
    'bicubic'; torch's bicubic takes a = -0.75)."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize(..., 'bicubic')`` along
    one axis (``jax._src.image.scale.compute_weight_mat``): half-pixel
    centres, the kernel widened by the scale when shrinking (antialias),
    each output's weights over the input normalized to sum 1 (so the
    border renormalizes rather than clamps)."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in)[:, None]) \
        / max(inv_scale, 1.0)
    w = _keys_cubic(dist)                                  # [n_in, n_out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


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
        for key in ("model", "BLIP_Retrieval", "BLIP_NLVR"):
            if isinstance(raw.get(key), dict):
                raw = raw[key]
                break
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in raw.items()
            if hasattr(v, "shape")}


def load_reference_state_dict(sd, cfg) -> dict[str, torch.Tensor]:
    """Reference-format state dict (or a path to a ``.pt`` holding one) ->
    the port model's state dict, for ``RetrievalModelConfig`` (stage I) or
    ``RerankerModelConfig`` (stage II)."""
    if not isinstance(sd, Mapping):
        sd = read_reference_file(sd)
    if isinstance(cfg, RetrievalModelConfig):
        rules = _COMMON + _STAGE1
    elif isinstance(cfg, RerankerModelConfig):
        rules = _COMMON + _STAGE2
        if "text_encoder.encoder.layer.0.attention.self0.query.weight" \
                not in sd:
            sd = duplicate_for_dual_stream(sd)
    else:
        raise TypeError(f"unsupported config {type(cfg).__name__}")
    rules = [(re.compile(p), r) for p, r in rules]
    vit = cfg.vit
    out: dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        a = np.asarray(val.detach().cpu().numpy() if isinstance(
            val, torch.Tensor) else val, np.float32)
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
