"""Export of the port's weights to the reference's checkpoint format (port
of the JAX package's ``runtime/convert.py::export_stage1``,
``export_stage2`` and ``save_torch_checkpoint``).

The inverse of ``runtime/weights.py::load_reference_state_dict``: a port
state dict (``RetrievalModel`` or ``RerankerModel``) becomes the
reference's keys (timm ViT with a fused ``qkv`` and a convolutional patch
embedding, MED/BERT keys, the NLVR dual-stream keys, ``cls_head.0/2``),
as float32 numpy arrays.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# port name -> reference name, first match wins (longer names first where
# one port prefix extends another: ``self_attn.attn.out.`` before
# ``self_attn.attn.``)
_L = r"^text_encoder\.layers\.(\d+)\."
_R = r"text_encoder.encoder.layer.\1."
_COMMON = [
    (r"^visual_encoder\.blocks\.(\d+)\.attn\.out\.",
     r"visual_encoder.blocks.\1.attn.proj."),
    (r"^text_encoder\.embeddings\.word_embeddings$",
     "text_encoder.embeddings.word_embeddings.weight"),
    (r"^text_encoder\.embeddings\.position_embeddings$",
     "text_encoder.embeddings.position_embeddings.weight"),
    (r"^text_encoder\.embeddings\.ln\.", "text_encoder.embeddings.LayerNorm."),
    (_L + r"ffn\.intermediate\.", _R + "intermediate.dense."),
    (_L + r"ffn\.output\.", _R + "output.dense."),
    (_L + r"ffn\.ln\.", _R + "output.LayerNorm."),
]
_STAGE1 = [
    (_L + r"self_attn\.attn\.out\.", _R + "attention.output.dense."),
    (_L + r"self_attn\.attn\.", _R + "attention.self."),
    (_L + r"self_attn\.ln\.", _R + "attention.output.LayerNorm."),
    (_L + r"cross_attn\.attn\.out\.", _R + "crossattention.output.dense."),
    (_L + r"cross_attn\.attn\.", _R + "crossattention.self."),
    (_L + r"cross_attn\.ln\.", _R + "crossattention.output.LayerNorm."),
]
_STAGE2 = [
    (_L + r"self_attn([01])\.out\.", _R + r"attention.output.dense\2."),
    (_L + r"self_attn([01])\.", _R + r"attention.self\2."),
    (_L + r"self_ln0\.", _R + "attention.output.LayerNormA."),
    (_L + r"self_ln1\.", _R + "attention.output.LayerNormB."),
    (_L + r"cross_q([01])\.", _R + r"crossattention.self\2.query."),
    (_L + r"cross_k([01])\.", _R + r"crossattention.self\2.key."),
    (_L + r"cross_v([01])\.", _R + r"crossattention.self\2.value."),
    (_L + r"cross_dense([01])\.", _R + r"crossattention.output.dense\2."),
    (_L + r"cross_ln0\.", _R + "crossattention.output.LayerNormA."),
    (_L + r"cross_ln1\.", _R + "crossattention.output.LayerNormB."),
    (_L + r"merge\.", _R + "crossattention.output.merge_layer."),
    (r"^cls_dense1\.", "cls_head.0."),
    (r"^cls_dense2\.", "cls_head.2."),
]
_QKV = re.compile(r"^visual_encoder\.blocks\.(\d+)\.attn\.(query|key|value)"
                  r"\.(weight|bias)$")


def _export(state_dict: Mapping, rules) -> dict[str, np.ndarray]:
    rules = [(re.compile(p), r) for p, r in rules]
    out: dict[str, np.ndarray] = {}
    qkv: dict[tuple[str, str], dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        a = np.array(val.detach().cpu().numpy() if isinstance(
            val, torch.Tensor) else val, np.float32)   # a C-ordered copy
        m = _QKV.match(key)
        if m:
            qkv.setdefault((m[1], m[3]), {})[m[2]] = a
            continue
        if key == "visual_encoder.patch_embed.proj.weight":
            # space-to-depth dense [D, P*P*3] -> conv [D, 3, P, P]
            p = int(round((a.shape[1] // 3) ** 0.5))
            a = np.ascontiguousarray(
                a.reshape(a.shape[0], p, p, 3).transpose(0, 3, 1, 2))
        name = key
        for pat, rep in rules:
            name, n = pat.subn(rep, name)
            if n:
                break
        out[name] = a
    for (block, kind), parts in qkv.items():
        out[f"visual_encoder.blocks.{block}.attn.qkv.{kind}"] = \
            np.ascontiguousarray(np.concatenate(
                [parts["query"], parts["key"], parts["value"]]))
    return out


def export_stage1(state_dict: Mapping) -> dict[str, np.ndarray]:
    """Port ``RetrievalModel`` state dict -> reference BLIP_Retrieval state
    dict (the JAX function takes a config too; the shapes carry all the
    export needs)."""
    return _export(state_dict, _COMMON + _STAGE1)


def export_stage2(state_dict: Mapping) -> dict[str, np.ndarray]:
    """Port ``RerankerModel`` state dict -> reference BLIP_NLVR state dict."""
    return _export(state_dict, _COMMON + _STAGE2)


def save_torch_checkpoint(path, state_dict: Mapping, class_name: str,
                          epoch: int = 0) -> None:
    """Write the reference's checkpoint wrapper
    {'epoch', <ClassName>: sd, 'optimizer_state_dict': {}} (utils.py:146-150),
    which ``runtime/weights.py::read_reference_file`` and the reference's
    load paths read."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in state_dict.items()}
    torch.save({"epoch": epoch, class_name: sd,
                "optimizer_state_dict": {}}, path)
