"""Plain float32 reference of the BLIP models the benchmark drives.

Written from the published descriptions, not from the program:
- ViT-B/16 (Dosovitskiy et al. 2021; BLIP ``models/vit.py``): patch
  embedding, CLS token, learned positions, pre-LN blocks (LayerNorm eps
  1e-6), GELU MLP, final LayerNorm.
- MED, BLIP's BERT-base text encoder with cross-attention in every layer
  (BLIP ``models/med.py``, ``configs/med_config.json``): word + position
  embeddings, post-LN layers (eps 1e-12) of self-attention, cross-attention
  to the image tokens and FFN; padding masked additively with -10000.
- The stage-I retrieval model (Candidate-Reranking-CIR
  ``src/blip_stage1.py``): the fused query is the normalised text
  projection of the MED's first token, the image feature the normalised
  vision projection of the ViT's CLS token.
- The dual-stream re-ranker (``src/blip_stage2.py``, ``src/nlvr_encoder.py``):
  stream 0 starts from z_t, stream 1 from fresh text embeddings; twin
  self- and cross-attention, the cross outputs averaged below layer
  ``merge_mlp_from`` and merged by a Linear(2D -> D) from it on, a shared
  FFN, and a head Linear(2D -> D) -> ReLU -> Linear(D -> 2) whose channel 0
  is the score.

Conventions the benchmark fixes for both sides (the weights are the
benchmark's, made from the seed and handed to the program too): tensors
are named as ``stage1_shapes`` and ``reranker_shapes`` list them; a Linear weight is [out, in]; the
patch embedding flattens each 16 x 16 patch in (row, column, channel)
order of channel-last images. GELU is the exact erf form.

``Numerics(lowp="fp8")`` rounds both operands of every product (the
projections, the attention scores and the attention-weighted sum) to
float8 e4m3 with a per-tensor scale, accumulating in float32: the control,
one precision below the bfloat16 that the configurations state.

Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_MASK = -10000.0
FP8_MAX = 448.0


class Numerics:
    """How the reference multiplies: float32 (``lowp=None``, TF32 off) or
    with each operand rounded to float8 e4m3 first (``lowp='fp8'``)."""

    def __init__(self, lowp: str | None = None):
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown precision {lowp!r}")
        self.lowp = lowp

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.lowp is None:
            return x
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b, both float32 (b may be a transposed view)."""
        return torch.matmul(self.round(a), self.round(b))

    def linear(self, x, p: dict, name: str):
        y = self.mm(x, p[name + ".weight"].t())
        bias = p.get(name + ".bias")
        return y if bias is None else y + bias


FP32 = Numerics()


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, p: dict, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def l2_normalize(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def attention(num: Numerics, q, k, v, heads: int, bias=None):
    """Multi-head attention over [B, Lq, D] queries and [B, M, D] keys and
    values; ``bias`` [B, 1, 1, M] is added to the scores."""
    b, lq, d = q.shape
    hd = d // heads
    qh = q.view(b, lq, heads, hd).transpose(1, 2)
    kh = k.view(b, k.shape[1], heads, hd).transpose(1, 2)
    vh = v.view(b, v.shape[1], heads, hd).transpose(1, 2)
    scores = num.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return num.mm(probs, vh).transpose(1, 2).reshape(b, lq, d)


def additive_mask(mask):
    """[B, L] 1/0 validity -> [B, 1, 1, L] additive bias."""
    return ((1.0 - mask.float()) * NEG_MASK)[:, None, None, :]


# ---------------------------------------------------------------------------
# parameter layout

def _dense(out: dict, name: str, n_in: int, n_out: int, bias: bool = True):
    out[name + ".weight"] = ((n_out, n_in), "w")
    if bias:
        out[name + ".bias"] = ((n_out,), "b")


def _ln(out: dict, name: str, dim: int):
    out[name + ".weight"] = ((dim,), "ln_w")
    out[name + ".bias"] = ((dim,), "b")


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
        for proj in ("query", "key", "value", "out"):
            _dense(out, f"{blk}.attn.{proj}", d, d)
        _ln(out, f"{blk}.norm2", d)
        _dense(out, f"{blk}.mlp.fc1", d, mlp)
        _dense(out, f"{blk}.mlp.fc2", mlp, d)
    _ln(out, f"{prefix}.norm", d)
    return out


def _embedding_shapes(out: dict, prefix: str, text: dict):
    d = text["hidden_size"]
    out[f"{prefix}.word_embeddings"] = ((text["vocab_size"], d), "emb")
    out[f"{prefix}.position_embeddings"] = (
        (text["max_position_embeddings"], d), "emb")
    _ln(out, f"{prefix}.ln", d)


def _ffn_shapes(out: dict, prefix: str, text: dict):
    d, f = text["hidden_size"], text["intermediate_size"]
    _dense(out, f"{prefix}.intermediate", d, f)
    _dense(out, f"{prefix}.output", f, d)
    _ln(out, f"{prefix}.ln", d)


def med_shapes(prefix: str, text: dict) -> dict:
    d, w = text["hidden_size"], text["encoder_width"]
    out = {}
    _embedding_shapes(out, f"{prefix}.embeddings", text)
    for i in range(text["num_layers"]):
        lay = f"{prefix}.layers.{i}"
        for block, kv in (("self_attn", d), ("cross_attn", w)):
            _dense(out, f"{lay}.{block}.attn.query", d, d)
            _dense(out, f"{lay}.{block}.attn.key", kv, d)
            _dense(out, f"{lay}.{block}.attn.value", kv, d)
            _dense(out, f"{lay}.{block}.attn.out", d, d)
            _ln(out, f"{lay}.{block}.ln", d)
        _ffn_shapes(out, f"{lay}.ffn", text)
    return out


def dual_shapes(prefix: str, text: dict) -> dict:
    d, w = text["hidden_size"], text["encoder_width"]
    out = {}
    _embedding_shapes(out, f"{prefix}.embeddings", text)
    for i in range(text["num_layers"]):
        lay = f"{prefix}.layers.{i}"
        for s in "01":
            for proj in ("query", "key", "value", "out"):
                _dense(out, f"{lay}.self_attn{s}.{proj}", d, d)
            _ln(out, f"{lay}.self_ln{s}", d)
            _dense(out, f"{lay}.cross_q{s}", d, d)
            _dense(out, f"{lay}.cross_k{s}", w, d)
            _dense(out, f"{lay}.cross_v{s}", w, d)
            _dense(out, f"{lay}.cross_dense{s}", d, d)
            _ln(out, f"{lay}.cross_ln{s}", d)
        if i >= text["merge_mlp_from"]:
            _dense(out, f"{lay}.merge", 2 * d, d)
        _ffn_shapes(out, f"{lay}.ffn", text)
    return out


def stage1_shapes(cfg: dict) -> dict:
    """The stage-I retrieval model's tensors: {name: (shape, kind)}."""
    d_v, d_t = cfg["vit"]["hidden_size"], cfg["text"]["hidden_size"]
    out = {"temp": ((), "temp")}
    out.update(vit_shapes("visual_encoder", cfg["vit"]))
    out.update(med_shapes("text_encoder", cfg["text"]))
    _dense(out, "vision_proj", d_v, cfg["embed_dim"])
    _dense(out, "text_proj", d_t, cfg["embed_dim"])
    return out


def reranker_shapes(cfg: dict) -> dict:
    """The stage-II re-ranker's tensors: {name: (shape, kind)}."""
    d = cfg["text"]["hidden_size"]
    out = {}
    out.update(vit_shapes("visual_encoder", cfg["vit"]))
    out.update(dual_shapes("text_encoder", cfg["text"]))
    _dense(out, "cls_dense1", 2 * d, d)
    _dense(out, "cls_dense2", d, 2)
    return out


@torch.no_grad()
def make_weights(shapes: dict, seed: int, device, std: float = 0.02
                 ) -> dict:
    """Float32 weights from ``seed``, drawn in one call on ``device``: a
    Linear weight N(0, 1 / fan_in), so that each product keeps its input's
    scale and the attention is not near uniform; embeddings and biases
    N(0, std^2); LayerNorm gains 1 + N(0, std^2); the contrastive
    temperature 0.07."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(math.prod(shape) for shape, _ in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        t.mul_(shape[1] ** -0.5 if kind == "w" else std)
        if kind == "ln_w":
            t.add_(1.0)
        elif kind == "temp":
            t.fill_(0.07)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# forward passes

def patchify(images, patch: int):
    """[B, H, W, 3] -> [B, (H/P)(W/P), P*P*3], each patch in (row, column,
    channel) order."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (h // patch) * (w // patch), patch * patch * c)


def vit_forward(p: dict, vit: dict, images, num: Numerics = FP32,
                prefix: str = "visual_encoder"):
    """Images [B, H, W, 3] float32 -> token features [B, 1 + N, D]."""
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
    return layer_norm(x, p, f"{prefix}.norm", eps)


def embed_text(p: dict, text: dict, ids, prefix: str):
    pos = p[f"{prefix}.position_embeddings"][:ids.shape[1]]
    x = p[f"{prefix}.word_embeddings"][ids.long()] + pos
    return layer_norm(x, p, f"{prefix}.ln", text["layer_norm_eps"])


def ffn(num: Numerics, p: dict, name: str, x, eps: float):
    h = num.linear(gelu(num.linear(x, p, f"{name}.intermediate")), p,
                   f"{name}.output")
    return layer_norm(h + x, p, f"{name}.ln", eps)


def med_forward(p: dict, text: dict, ids, mask, image_feats,
                num: Numerics = FP32, prefix: str = "text_encoder"):
    """MED in multimodal mode: ids, mask [B, L] against image_feats
    [B, M, W] -> last hidden state [B, L, D]."""
    eps, heads = text["layer_norm_eps"], text["num_heads"]
    bias = additive_mask(mask)
    x = embed_text(p, text, ids, f"{prefix}.embeddings")
    img = image_feats.float()
    for i in range(text["num_layers"]):
        lay = f"{prefix}.layers.{i}"
        for block, kv, b in (("self_attn", None, bias),
                             ("cross_attn", img, None)):
            src = x if kv is None else kv
            a = f"{lay}.{block}.attn"
            ctx = attention(num, num.linear(x, p, f"{a}.query"),
                            num.linear(src, p, f"{a}.key"),
                            num.linear(src, p, f"{a}.value"), heads, b)
            x = layer_norm(num.linear(ctx, p, f"{a}.out") + x, p,
                           f"{lay}.{block}.ln", eps)
        x = ffn(num, p, f"{lay}.ffn", x, eps)
    return x


def pooled_image(p: dict, feats, num: Numerics = FP32):
    """ViT features [B, M, D] -> the normalised projected CLS [B, E]."""
    return l2_normalize(num.linear(feats[:, 0], p, "vision_proj"))


def fused_query(p: dict, cfg: dict, ids, mask, ref_feats,
                num: Numerics = FP32):
    """Stage-I fusion: (normalised prediction [B, E], z_t [B, L, D])."""
    z_t = med_forward(p, cfg["text"], ids, mask, ref_feats, num)
    return l2_normalize(num.linear(z_t[:, 0], p, "text_proj")), z_t


def rerank_scores(p: dict, text: dict, ids, mask, z_t, cand_feats,
                  num: Numerics = FP32, prefix: str = "text_encoder"):
    """The re-ranker's scores of one query against C candidates: ids, mask
    [1, L], z_t [1, L, D] and cand_feats [C, M, W] -> [C]."""
    eps, heads = text["layer_norm_eps"], text["num_heads"]
    c = cand_feats.shape[0]
    bias = additive_mask(mask).expand(c, -1, -1, -1)
    cand = cand_feats.float()
    hs = [z_t.expand(c, -1, -1),
          embed_text(p, text, ids, f"{prefix}.embeddings").expand(c, -1, -1)]
    for i in range(text["num_layers"]):
        lay = f"{prefix}.layers.{i}"
        for s in (0, 1):
            a = f"{lay}.self_attn{s}"
            h = hs[s]
            ctx = attention(num, num.linear(h, p, f"{a}.query"),
                            num.linear(h, p, f"{a}.key"),
                            num.linear(h, p, f"{a}.value"), heads, bias)
            hs[s] = layer_norm(num.linear(ctx, p, f"{a}.out") + h, p,
                               f"{lay}.self_ln{s}", eps)
        d = []
        for s in (0, 1):
            ctx = attention(num, num.linear(hs[s], p, f"{lay}.cross_q{s}"),
                            num.linear(cand, p, f"{lay}.cross_k{s}"),
                            num.linear(cand, p, f"{lay}.cross_v{s}"), heads)
            d.append(num.linear(ctx, p, f"{lay}.cross_dense{s}"))
        if i >= text["merge_mlp_from"]:
            merged = num.linear(torch.cat(d, dim=-1), p, f"{lay}.merge")
        else:
            merged = (d[0] + d[1]) * 0.5
        hs = [ffn(num, p, f"{lay}.ffn",
                  layer_norm(merged + hs[s], p, f"{lay}.cross_ln{s}", eps),
                  eps) for s in (0, 1)]
    pair = torch.cat([hs[0][:, 0], hs[1][:, 0]], dim=-1)
    h = torch.relu(num.linear(pair, p, "cls_dense1"))
    return num.linear(h, p, "cls_dense2")[:, 0]
