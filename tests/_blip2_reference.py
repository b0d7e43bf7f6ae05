"""Plain float32 forward of BLIP-2 as a stage-I retrieval model, the
yardstick of ``tests/test_torch_port_blip2.py``.

Written from the published description (Li et al. 2023, arXiv:2301.12597;
LAVIS ``blip2_qformer.py``, ``Qformer.py``, ``eva_vit.py``), one image or
one caption at a time, with plain ``torch`` operations: no kernel of the
port, no batching, no JAX.

- EVA ViT-g: patch embedding (each patch flattened in (row, column,
  channel) order of channel-last pixels, one product), CLS token, learned
  positions, pre-LN blocks (q and v biases, none on k; scale d ** -0.5;
  exact GELU), then BLIP-2's ``ln_vision`` (the tower's own final norm
  left out, as LAVIS's ``forward_features`` leaves it).
- Q-Former: LN(cat(queries, word + position(text))), post-LN layers of
  self-attention over every row under the additive -10000 padding mask,
  cross-attention of the query rows alone in every
  ``cross_attention_freq``-th layer, the query FFN on the query rows and
  the text FFN on the text rows.
- Target: the queries alone against the image, ``vision_proj``, each row
  normalised. Composed query: the text's first row, after the queries,
  through ``text_proj``, normalised. Score: the max over the target rows
  of the dot product.

``cfg`` is a dict: ``vit`` (patch_size, num_layers, num_heads,
layer_norm_eps, final_norm_eps) and ``text`` (num_layers, num_heads,
layer_norm_eps), ``num_query_tokens``, ``cross_attention_freq``. ``p`` is
a float32 state dict under the port's names.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _linear(x, p, name):
    y = x @ p[name + ".weight"].t()
    bias = p.get(name + ".bias")
    return y if bias is None else y + bias


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _attention(q, k, v, heads, bias=None):
    """q [Lq, D], k and v [M, D] -> [Lq, D]; bias [M] added to the
    scores."""
    d = q.shape[-1] // heads
    qh = q.view(-1, heads, d).transpose(0, 1)
    kh = k.view(-1, heads, d).transpose(0, 1)
    vh = v.view(-1, heads, d).transpose(0, 1)
    scores = qh @ kh.transpose(-1, -2) / math.sqrt(d)
    if bias is not None:
        scores = scores + bias
    return (torch.softmax(scores, -1) @ vh).transpose(0, 1).reshape(
        q.shape[0], -1)


def vision(p, cfg, image):
    """One image [H, W, 3] -> its tokens after ``ln_vision`` [M, W]."""
    v = cfg["vit"]
    pre = "visual_encoder"
    ps = v["patch_size"]
    h, w, c = image.shape
    x = image.reshape(h // ps, ps, w // ps, ps, c).permute(0, 2, 1, 3, 4)
    x = _linear(x.reshape(-1, ps * ps * c), p, f"{pre}.patch_embed.proj")
    x = torch.cat([p[f"{pre}.cls_token"][0], x]) + p[f"{pre}.pos_embed"][0]
    eps = v["layer_norm_eps"]
    for i in range(v["num_layers"]):
        blk = f"{pre}.blocks.{i}"
        y = _ln(x, p, f"{blk}.norm1", eps)
        q, k, val = (_linear(y, p, f"{blk}.attn.{n}")
                     for n in ("query", "key", "value"))
        x = x + _linear(_attention(q, k, val, v["num_heads"]), p,
                        f"{blk}.attn.out")
        y = _ln(x, p, f"{blk}.norm2", eps)
        x = x + _linear(_gelu(_linear(y, p, f"{blk}.mlp.fc1")), p,
                        f"{blk}.mlp.fc2")
    return _ln(x, p, f"{pre}.norm", v["final_norm_eps"])


def _block(x, src, p, name, heads, eps, bias=None):
    a = f"{name}.attn"
    ctx = _attention(_linear(x, p, f"{a}.query"), _linear(src, p, f"{a}.key"),
                     _linear(src, p, f"{a}.value"), heads, bias)
    return _ln(_linear(ctx, p, f"{a}.out") + x, p, f"{name}.ln", eps)


def _ffn(x, p, name, eps):
    h = _linear(_gelu(_linear(x, p, f"{name}.intermediate")), p,
                f"{name}.output")
    return _ln(h + x, p, f"{name}.ln", eps)


def qformer(p, cfg, tokens, ids=None):
    """The Q-Former over its queries (and one caption's ``ids`` [L], every
    one valid) against one image's ``tokens`` [M, W]: [T (+ L), D]."""
    t = cfg["text"]
    eps, heads, n_q = t["layer_norm_eps"], t["num_heads"], \
        cfg["num_query_tokens"]
    pre = "qformer"
    x = p[f"{pre}.query_tokens"][0]
    if ids is not None:
        emb = p[f"{pre}.embeddings.word_embeddings"][ids] \
            + p[f"{pre}.embeddings.position_embeddings"][:len(ids)]
        x = torch.cat([x, emb])
    x = _ln(x, p, f"{pre}.embeddings.ln", eps)
    for i in range(t["num_layers"]):
        lay = f"{pre}.layers.{i}"
        x = _block(x, x, p, f"{lay}.self_attn", heads, eps)
        q = x[:n_q]
        if i % cfg["cross_attention_freq"] == 0:
            q = _block(q, tokens, p, f"{lay}.cross_attn", heads, eps)
        parts = [_ffn(q, p, f"{lay}.ffn_query", eps)]
        if len(x) > n_q:
            parts.append(_ffn(x[n_q:], p, f"{lay}.ffn", eps))
        x = torch.cat(parts)
    return x


def _normalize(x):
    return x / x.norm(dim=-1, keepdim=True)


def target(p, cfg, image):
    """One corpus image [H, W, 3] -> its normalised targets [T, E]."""
    hidden = qformer(p, cfg, vision(p, cfg, image))
    return _normalize(_linear(hidden, p, "vision_proj"))


def composed(p, cfg, ids, image):
    """One caption's ids [L] with its reference image -> f_q [E]."""
    hidden = qformer(p, cfg, vision(p, cfg, image), ids)
    return _normalize(_linear(hidden[cfg["num_query_tokens"]], p,
                              "text_proj"))


def score(f_q, targets):
    """max over the target rows of <f_q, z_t,i>: f_q [E], targets [T, E]."""
    return (targets @ f_q).max()
