"""Plain float32 reference of BLIP-2 as a stage-I retrieval model, the
model of the configuration ``blip2_evag14_qformer_224``.

Written from the published description, not from the program (Li et al.
2023, arXiv:2301.12597; Salesforce LAVIS ``blip2_qformer.py``,
``Qformer.py``, ``eva_vit.py::create_eva_vit_g``, ``blip2_pretrain.yaml``),
composed for CIR as SPRC (arXiv:2310.05473) composes it:

- EVA ViT-g/14 at 224: patch embedding, CLS token, learned positions over
  257 tokens, 39 pre-LN blocks (eps 1e-6) of 16 heads of 88 with q and v
  biases and none on k, an exact-GELU MLP of 6,144; no layer scale, no
  relative position bias; the tower's own final norm left out, as LAVIS's
  ``forward_features`` leaves it, and BLIP-2's ``ln_vision`` (eps 1e-5) in
  its place.
- The Q-Former, BERT-base (post-LN, eps 1e-12, padding masked additively
  with -10000) with 32 learned queries: LN(cat(queries, word +
  position(text))), text positions from 0 and none for the queries;
  self-attention over every row; in layers 0, 2, ..., 10 the query rows
  alone cross-attend to the image tokens (keys and values from width
  1,408); the query rows through their own FFN, the text rows through the
  text FFN.
- A corpus image's target: the queries alone against its tokens,
  ``vision_proj``, each of the 32 rows normalised. A composed query: the
  queries and the caption ([CLS] words [SEP], at most ``text_len`` tokens,
  truncated as LAVIS's tokenizer truncates) against the reference image;
  the caption's first row, after the queries, through ``text_proj``,
  normalised. The score: the max over the 32 target rows of the dot
  product (LAVIS's ``sim_t2q.max(-1)``).

Departures from LAVIS: random weights from the seed and no checkpoint
(none is in the repository); the program runs the tower in bfloat16 where
LAVIS runs it in float16 (``vit_precision: fp16``), this reference in
float32 (``Numerics``: TF32 off; ``Numerics('fp8')`` is the control one
precision below the configuration's bfloat16); the benchmark's toy
vocabulary, one token a word, with the table kept at 30,523 rows.

Tensors are named as the program's state dict names them
(``blip2_shapes``); a Linear weight is [out, in]; patches are flattened in
(row, column, channel) order of channel-last images. Imports nothing of
the program.
"""
from __future__ import annotations

import numpy as np
import torch

from cirbench.reference.blip import (
    FP32,
    Numerics,
    _dense,
    _ln,
    additive_mask,
    attention,
    gelu,
    l2_normalize,
    layer_norm,
    patchify,
)

CLS, SEP = "[CLS]", "[SEP]"


def vit_shapes(prefix: str, vit: dict) -> dict:
    d, p = vit["hidden_size"], vit["patch_size"]
    tokens = (vit["image_size"] // p) ** 2 + 1
    mlp = int(d * vit["mlp_ratio"])
    out = {}
    _dense(out, f"{prefix}.patch_embed.proj", p * p * 3, d)
    out[f"{prefix}.cls_token"] = ((1, 1, d), "emb")
    out[f"{prefix}.pos_embed"] = ((1, tokens, d), "emb")
    for i in range(vit["num_layers"]):
        blk = f"{prefix}.blocks.{i}"
        _ln(out, f"{blk}.norm1", d)
        _dense(out, f"{blk}.attn.query", d, d)
        _dense(out, f"{blk}.attn.key", d, d, bias=False)
        _dense(out, f"{blk}.attn.value", d, d)
        _dense(out, f"{blk}.attn.out", d, d)
        _ln(out, f"{blk}.norm2", d)
        _dense(out, f"{blk}.mlp.fc1", d, mlp)
        _dense(out, f"{blk}.mlp.fc2", mlp, d)
    _ln(out, f"{prefix}.norm", d)             # ln_vision
    return out


def _block_shapes(out: dict, name: str, d: int, kv: int):
    for proj, n_in in (("query", d), ("key", kv), ("value", kv),
                       ("out", d)):
        _dense(out, f"{name}.attn.{proj}", n_in, d)
    _ln(out, f"{name}.ln", d)


def _ffn_shapes(out: dict, name: str, d: int, f: int):
    _dense(out, f"{name}.intermediate", d, f)
    _dense(out, f"{name}.output", f, d)
    _ln(out, f"{name}.ln", d)


def qformer_shapes(prefix: str, cfg: dict) -> dict:
    t = cfg["text"]
    d, f, w = t["hidden_size"], t["intermediate_size"], t["encoder_width"]
    out = {f"{prefix}.query_tokens": ((1, cfg["num_query_tokens"], d),
                                      "emb")}
    emb = f"{prefix}.embeddings"
    out[f"{emb}.word_embeddings"] = ((t["vocab_size"], d), "emb")
    out[f"{emb}.position_embeddings"] = ((t["max_position_embeddings"], d),
                                         "emb")
    _ln(out, f"{emb}.ln", d)
    for i in range(t["num_layers"]):
        lay = f"{prefix}.layers.{i}"
        _block_shapes(out, f"{lay}.self_attn", d, d)
        if i % cfg["cross_attention_freq"] == 0:
            _block_shapes(out, f"{lay}.cross_attn", d, w)
        _ffn_shapes(out, f"{lay}.ffn", d, f)
        _ffn_shapes(out, f"{lay}.ffn_query", d, f)
    return out


def blip2_shapes(cfg: dict) -> dict:
    """The model's tensors: {name: (shape, kind)} (``blip.make_weights``
    draws them)."""
    d, e = cfg["text"]["hidden_size"], cfg["embed_dim"]
    out = vit_shapes("visual_encoder", cfg["vit"])
    out.update(qformer_shapes("qformer", cfg))
    _dense(out, "vision_proj", d, e)
    _dense(out, "text_proj", d, e)
    return out


def vision(p: dict, vit: dict, images, num: Numerics = FP32,
           prefix: str = "visual_encoder"):
    """Images [B, H, W, 3] -> ``ln_vision`` of the tower's tokens
    [B, 1 + N, D]."""
    eps, heads = vit["layer_norm_eps"], vit["num_heads"]
    x = num.linear(patchify(images.float(), vit["patch_size"]), p,
                   f"{prefix}.patch_embed.proj")
    cls = p[f"{prefix}.cls_token"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + p[f"{prefix}.pos_embed"]
    for i in range(vit["num_layers"]):
        blk = f"{prefix}.blocks.{i}"
        h = layer_norm(x, p, f"{blk}.norm1", eps)
        q, k, v = (num.linear(h, p, f"{blk}.attn.{n}")
                   for n in ("query", "key", "value"))
        x = x + num.linear(attention(num, q, k, v, heads), p,
                           f"{blk}.attn.out")
        h = layer_norm(x, p, f"{blk}.norm2", eps)
        x = x + num.linear(gelu(num.linear(h, p, f"{blk}.mlp.fc1")), p,
                           f"{blk}.mlp.fc2")
    return layer_norm(x, p, f"{prefix}.norm", vit["final_norm_eps"])


def _block(num, p, name, x, src, heads, eps, bias=None):
    a = f"{name}.attn"
    ctx = attention(num, num.linear(x, p, f"{a}.query"),
                    num.linear(src, p, f"{a}.key"),
                    num.linear(src, p, f"{a}.value"), heads, bias)
    return layer_norm(num.linear(ctx, p, f"{a}.out") + x, p, f"{name}.ln",
                      eps)


def _ffn(num, p, name, x, eps):
    h = num.linear(gelu(num.linear(x, p, f"{name}.intermediate")), p,
                   f"{name}.output")
    return layer_norm(h + x, p, f"{name}.ln", eps)


def qformer(p: dict, cfg: dict, image_feats, ids=None, mask=None,
            num: Numerics = FP32, prefix: str = "qformer"):
    """The queries (and captions ``ids``, ``mask`` [B, L]) against
    ``image_feats`` [B, M, W] -> the last hidden state [B, T (+ L), D]."""
    t = cfg["text"]
    eps, heads, n_q = t["layer_norm_eps"], t["num_heads"], \
        cfg["num_query_tokens"]
    b = image_feats.shape[0]
    x = p[f"{prefix}.query_tokens"].expand(b, -1, -1)
    bias = None
    if ids is not None:
        emb = f"{prefix}.embeddings"
        words = p[f"{emb}.word_embeddings"][ids.long()] \
            + p[f"{emb}.position_embeddings"][:ids.shape[1]]
        x = torch.cat([x, words], dim=1)
        bias = additive_mask(torch.cat([mask.new_ones(b, n_q), mask], 1))
    x = layer_norm(x, p, f"{prefix}.embeddings.ln", eps)
    img = image_feats.float()
    for i in range(t["num_layers"]):
        lay = f"{prefix}.layers.{i}"
        x = _block(num, p, f"{lay}.self_attn", x, x, heads, eps, bias)
        q = x[:, :n_q]
        if i % cfg["cross_attention_freq"] == 0:
            q = _block(num, p, f"{lay}.cross_attn", q, img, heads, eps)
        parts = [_ffn(num, p, f"{lay}.ffn_query", q, eps)]
        if x.shape[1] > n_q:
            parts.append(_ffn(num, p, f"{lay}.ffn", x[:, n_q:], eps))
        x = torch.cat(parts, dim=1)
    return x


def targets(p: dict, cfg: dict, image_feats, num: Numerics = FP32):
    """Image tokens [B, M, W] -> the normalised targets [B, T, E]."""
    return l2_normalize(num.linear(qformer(p, cfg, image_feats, num=num),
                                   p, "vision_proj"))


def fused_query(p: dict, cfg: dict, ids, mask, ref_feats,
                num: Numerics = FP32):
    """Captions [B, L] with their reference images' tokens [B, M, W] ->
    f_q [B, E]."""
    hidden = qformer(p, cfg, ref_feats, ids, mask, num)
    return l2_normalize(num.linear(hidden[:, cfg["num_query_tokens"]], p,
                                   "text_proj"))


def scores(num: Numerics, f_q, target_rows):
    """f_q [B, E] against targets [N, T, E] -> [B, N], the max over T."""
    n, t, e = target_rows.shape
    s = num.mm(f_q, target_rows.reshape(n * t, e).t())
    return s.view(-1, n, t).amax(-1)


def encode(words: list[str], vocab: list[str], text_len: int
           ) -> tuple[np.ndarray, np.ndarray]:
    """One caption's ids and mask [1, <= text_len]: [CLS] words [SEP],
    the words cut so that [SEP] stays (LAVIS's ``truncation=True``)."""
    ids = {tok: i for i, tok in enumerate(vocab)}
    row = [ids[CLS], *(ids[w.lower()] for w in words[:text_len - 2]),
           ids[SEP]]
    out = np.asarray([row], np.int64)
    return out, np.ones_like(out)
