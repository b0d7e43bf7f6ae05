"""Plain float32 reference of Kimi-VL-A3B-Instruct as a point-wise stage-II
re-ranker, the model of the configuration ``kimi_vl_a3b_rerank_392``.

Written from the published description, not from the program (Kimi-VL
technical report, arXiv:2504.07491; the model's ``config.json``; DeepSeek-V3's
``modeling_deepseek.py`` for the decoder, whose ``model_type`` the language
model keeps):

- MoonViT at 392 x 392, patch 14: a 28 x 28 grid of 784 patches; the patch
  embedding (a stride-14 convolution with a bias, 3 -> 1,152); the learned
  [64, 64, 1,152] position table, bicubic-resized to 28 x 28 and added;
  27 pre-LN blocks (LayerNorm eps 1e-5) of ``x += Wo attn(rope2d(Wqkv
  LN0(x)))``, a qkv bias, 16 heads of 72, full bidirectional attention over
  the image's patches, and ``x += fc1(gelu_tanh(fc0(LN1(x))))`` (1,152 ->
  4,304 -> 1,152); a final LayerNorm. The 2-D rotary embedding turns each
  head's lane pairs (2m, 2m + 1), m = 0..35: pair p = 2j takes the angle
  col * theta_j, pair p = 2j + 1 takes row * theta_j, theta_j =
  10,000 ** (-4j / 72), j = 0..17.
- The projector: LayerNorm(1,152) on every token; each 2 x 2 group of the
  grid concatenated in row-major order within the group (196 tokens of
  4,608); Linear 4,608 -> 4,608 with a bias, the exact GELU, Linear 4,608
  -> 2,048 with a bias.
- The language model (deepseek_v3): token embeddings, 27 pre-RMSNorm
  (eps 1e-5) decoder layers, a final RMSNorm, an untied head. Attention is
  MLA: q = x Wq as 16 heads of [nope 128 | rope 64]; c = x Wkv_a =
  [c_kv 512 | k_pe 64]; c_kv = RMSNorm(c_kv) (eps 1e-6); [k_nope | v] =
  c_kv Wkv_b as 16 heads of [128 | 128]; the rope lanes of q and of the
  head-shared k_pe read as interleaved pairs and turned as DeepSeek-V3's
  ``apply_rotary_pos_emb`` turns them (theta 800,000); scale 192 ** -0.5;
  causal; out = attn Wo. Layer 0's FFN is a dense SwiGLU MLP of 11,264;
  layers 1-26 route: s = sigmoid(x Wg^T) in float32 over 64 experts, idx =
  top6(s + b) with b the selection-only ``e_score_correction_bias``, w =
  s[idx] / (sum s[idx] + 1e-20) * 2.446, y = sum_i w_i E_i(x) + S(x), with
  E(x) = Wd(silu(Wg x) * Wu x) at width 1,408 and S the shared SwiGLU MLP
  at 2,816 (two shared experts). Positions run over the whole sequence.
- The re-ranker: a query's sequence is [template 3][media start 3][196
  reference tokens][media end 1][caption words]; a candidate's continues it
  with [media start 3][196 candidate tokens][media end 1][question 12]
  [assistant start 4]. Its score is logit(yes) - logit(no) at the last
  position. Every (query, candidate) sequence runs whole here, with no
  cache (the program runs the query's part once and keeps its latent).

Departures from the published model: random weights from the seed and no
checkpoint, and the benchmark's toy vocabulary (a caption word's id is its
row of ``cirbench/traffic/vocab.txt``) with fixed template, question and
answer ids (the configuration's ``template``), as neither the checkpoint
nor Kimi's tokenizer is in the repository; every image at 392 x 392 where
MoonViT takes native resolutions; the program computes in bfloat16, this
reference in float32 (``Numerics``: TF32 off; ``Numerics('fp8')`` is the
control one precision below).

Weights: ``tensor()`` draws each tensor from a stream of its own, keyed by
the seed and the tensor's name, and rounds it to bfloat16, so the program
and the reference read identical values and neither draws all 16.4 B
parameters at once; the forward passes here upcast one layer's tensors at
a time. A Linear weight is [out, in] (N(0, 1 / fan_in)); embeddings and
biases N(0, 0.02^2); norm gains 1 + N(0, 0.02^2); the router bias
N(0, 0.02^2); the routed experts stacked, gate and up as [E, 2 x 1,408,
2,048] (gate first), down as [E, 2,048, 1,408]; the patch embedding
flattens each patch in (row, column, channel) order of channel-last
images. Imports nothing of the program.
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from cirbench.reference.blip import FP32, Numerics, patchify, tf32_off  # noqa: F401

STD = 0.02
WEIGHT_STREAM = 23   # the weights' child of the run seed


# ---------------------------------------------------------------------------
# parameter layout and the weight maker

def _dense(out: dict, name: str, n_in: int, n_out: int, bias: bool):
    out[name + ".weight"] = ((n_out, n_in), "w")
    if bias:
        out[name + ".bias"] = ((n_out,), "b")


def _norm(out: dict, name: str, dim: int, bias: bool):
    out[name + ".weight"] = ((dim,), "ln_w")
    if bias:
        out[name + ".bias"] = ((dim,), "b")


def vision_shapes(cfg: dict) -> dict:
    v = cfg["vision"]
    d, p, f = v["hidden_size"], v["patch_size"], v["intermediate_size"]
    out = {}
    _dense(out, "vision.patch_embed", p * p * 3, d, True)
    out["vision.pos_emb"] = ((v["pos_grid"], v["pos_grid"], d), "emb")
    for i in range(v["num_layers"]):
        blk = f"vision.blocks.{i}"
        _norm(out, f"{blk}.norm0", d, True)
        _dense(out, f"{blk}.attn.qkv", d, 3 * d, True)
        _dense(out, f"{blk}.attn.proj", d, d, True)
        _norm(out, f"{blk}.norm1", d, True)
        _dense(out, f"{blk}.mlp.fc0", d, f, True)
        _dense(out, f"{blk}.mlp.fc1", f, d, True)
    _norm(out, "vision.final_norm", d, True)
    merged = d * v["merge"] ** 2
    _norm(out, "projector.pre_norm", d, True)
    _dense(out, "projector.linear_1", merged, merged, True)
    _dense(out, "projector.linear_2", merged, cfg["hidden_size"], True)
    return out


def _mlp(out: dict, name: str, d: int, f: int):
    _dense(out, f"{name}.gate_proj", d, f, False)
    _dense(out, f"{name}.up_proj", d, f, False)
    _dense(out, f"{name}.down_proj", f, d, False)


def layer_shapes(cfg: dict, i: int) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    e, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out = {}
    lay = f"lm.layers.{i}"
    _norm(out, f"{lay}.input_layernorm", d, False)
    _dense(out, f"{lay}.self_attn.q_proj", d, h * (nope + rope), False)
    _dense(out, f"{lay}.self_attn.kv_a_proj_with_mqa", d, r + rope, False)
    _norm(out, f"{lay}.self_attn.kv_a_layernorm", r, False)
    _dense(out, f"{lay}.self_attn.kv_b_proj", r, h * (nope + vd), False)
    _dense(out, f"{lay}.self_attn.o_proj", h * vd, d, False)
    _norm(out, f"{lay}.post_attention_layernorm", d, False)
    if i < cfg["first_k_dense_replace"]:
        _mlp(out, f"{lay}.mlp", d, cfg["intermediate_size"])
        return out
    out[f"{lay}.mlp.gate.weight"] = ((e, d), "w")
    out[f"{lay}.mlp.gate.e_score_correction_bias"] = ((e,), "router_bias")
    out[f"{lay}.mlp.experts.gate_up"] = ((e, 2 * fe, d), "w")
    out[f"{lay}.mlp.experts.down"] = ((e, d, fe), "w")
    _mlp(out, f"{lay}.mlp.shared_experts", d, fe * cfg["n_shared_experts"])
    return out


def lm_shapes(cfg: dict) -> dict:
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    out = {"lm.embed_tokens.weight": ((vocab, d), "emb")}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_shapes(cfg, i))
    _norm(out, "lm.norm", d, False)
    _dense(out, "lm.lm_head", d, vocab, False)
    return out


def shapes(cfg: dict) -> dict:
    """Every tensor of the model: name -> (shape, kind), in load order."""
    return {**vision_shapes(cfg), **lm_shapes(cfg)}


def count_params(cfg: dict) -> dict:
    """Parameters of the tower, the projector and the language model."""
    out = {"vision": 0, "projector": 0, "lm": 0}
    for name, (shape, _) in shapes(cfg).items():
        out[name.split(".")[0]] += math.prod(shape)
    return out


def tensor_seed(seed: int, name: str) -> int:
    """A 63-bit seed of the tensor ``name`` of run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), WEIGHT_STREAM,
                                 zlib.crc32(name.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def tensor(name: str, shape: tuple, kind: str, seed: int, device
           ) -> torch.Tensor:
    """One tensor of the model, drawn from its own stream, in bfloat16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(tensor_seed(seed, name))
    t = torch.randn(shape, generator=gen, device=device)
    t.mul_(shape[-1] ** -0.5 if kind == "w" else STD)
    if kind == "ln_w":
        t.add_(1.0)
    return t.to(torch.bfloat16)


@torch.no_grad()
def load_into(params, cfg: dict, seed: int) -> None:
    """Each tensor of ``params`` ((name, tensor) pairs named as ``shapes``
    names them, a module's ``named_parameters()``) overwritten in place
    with its drawn values, one tensor at a time, on its own device; a
    name, a shape or a tensor missing raises."""
    table = shapes(cfg)
    seen = set()
    for name, p in params:
        shape, kind = table[name]
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)}, the table "
                             f"says {shape}")
        p.copy_(tensor(name, shape, kind, seed, p.device))
        seen.add(name)
    if seen != set(table):
        raise ValueError(f"not loaded: {sorted(set(table) - seen)[:5]}")


class Weights:
    """The model's tensors by name, drawn on demand and upcast to float32
    (``p[name]``); ``layer(names)`` draws a group once for a layer's work."""

    def __init__(self, cfg: dict, seed: int, device):
        self.table = shapes(cfg)
        self.seed, self.device = seed, device

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, kind = self.table[name]
        return tensor(name, shape, kind, self.seed, self.device).float()

    def group(self, prefix: str) -> dict:
        return {n: self[n] for n in self.table if n.startswith(prefix + ".")
                or n == prefix}


# ---------------------------------------------------------------------------
# MoonViT and the projector

def layer_norm(x, p: dict, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def grid_angles(cfg: dict, device) -> torch.Tensor:
    """[784, 36] angles of the 2-D rotary embedding: pair 2j of a head
    turns by col * theta_j, pair 2j + 1 by row * theta_j."""
    v = cfg["vision"]
    n = v["image_size"] // v["patch_size"]
    hd = v["hidden_size"] // v["num_heads"]
    j = torch.arange(hd // 4, dtype=torch.float64, device=device)
    theta = v["rope_theta"] ** (-4.0 * j / hd)
    rows = torch.arange(n, device=device).repeat_interleave(n).double()
    cols = torch.arange(n, device=device).repeat(n).double()
    ang = torch.empty(n * n, hd // 2, dtype=torch.float64, device=device)
    ang[:, 0::2] = cols[:, None] * theta
    ang[:, 1::2] = rows[:, None] * theta
    return ang.float()


def rope2d(x, ang):
    """x [..., 784, H, 72]: lanes (2m, 2m + 1) turned by ang[:, m]."""
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).flatten(-2)


def positions(p, cfg: dict):
    """The position table bicubic-resized to the patch grid: [784, D]."""
    v = cfg["vision"]
    n = v["image_size"] // v["patch_size"]
    table = p["vision.pos_emb"].permute(2, 0, 1)[None]
    out = F.interpolate(table, size=(n, n), mode="bicubic",
                        align_corners=False)
    return out[0].permute(1, 2, 0).reshape(n * n, -1)


def vision_block(num: Numerics, p: dict, blk: str, x, ang, cfg: dict):
    v = cfg["vision"]
    eps, heads = v["layer_norm_eps"], v["num_heads"]
    b, n, d = x.shape
    qkv = num.linear(layer_norm(x, p, f"{blk}.norm0", eps), p,
                     f"{blk}.attn.qkv").view(b, n, 3, heads, d // heads)
    q, k = rope2d(qkv[:, :, 0], ang), rope2d(qkv[:, :, 1], ang)
    vv = qkv[:, :, 2]
    q, k, vv = (t.transpose(1, 2) for t in (q, k, vv))
    s = num.mm(q, k.transpose(-1, -2)) * (d // heads) ** -0.5
    o = num.mm(torch.softmax(s, dim=-1), vv).transpose(1, 2).reshape(b, n, d)
    x = x + num.linear(o, p, f"{blk}.attn.proj")
    h = gelu_tanh(num.linear(layer_norm(x, p, f"{blk}.norm1", eps), p,
                             f"{blk}.mlp.fc0"))
    return x + num.linear(h, p, f"{blk}.mlp.fc1")


def merge_patches(x, grid: int, m: int):
    """[B, grid^2, D] -> [B, (grid/m)^2, m^2 D]: each m x m group of the
    grid, its tokens concatenated in row-major order within the group."""
    b, _, d = x.shape
    g = grid // m
    x = x.view(b, g, m, g, m, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * g, m * m * d)


@torch.no_grad()
def image_tokens(w: Weights, cfg: dict, images, num: Numerics = FP32,
                 chunk: int = 16):
    """Images [B, H, W, 3] float32 -> the LM's image tokens [B, 196, 2048]:
    MoonViT, then the projector; layer by layer over the batch, ``chunk``
    images at a time."""
    v = cfg["vision"]
    eps = v["layer_norm_eps"]
    n = v["image_size"] // v["patch_size"]
    ang = grid_angles(cfg, images.device)
    p = w.group("vision.patch_embed")
    p["vision.pos_emb"] = w["vision.pos_emb"]
    x = num.linear(patchify(images, v["patch_size"]), p, "vision.patch_embed")
    x = x + positions(p, cfg)
    for i in range(v["num_layers"]):
        blk = f"vision.blocks.{i}"
        p = w.group(blk)
        x = torch.cat([vision_block(num, p, blk, x[s:s + chunk], ang, cfg)
                       for s in range(0, len(x), chunk)])
    p = {**w.group("vision.final_norm"), **w.group("projector")}
    x = layer_norm(x, p, "vision.final_norm", eps)
    x = merge_patches(layer_norm(x, p, "projector.pre_norm", eps), n,
                      v["merge"])
    x = gelu(num.linear(x, p, "projector.linear_1"))
    return num.linear(x, p, "projector.linear_2")


# ---------------------------------------------------------------------------
# the language model

def rms_norm(x, weight, eps: float):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_tables(cfg: dict, n: int, device):
    """cos, sin [n, 64] of positions 0..n-1 (DeepSeek-V3's rotary cache:
    the frequencies repeated, ``cat(freqs, freqs)``)."""
    dim = cfg["qk_rope_head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(
        0, dim, 2, dtype=torch.float64, device=device) / dim))
    freqs = torch.arange(n, dtype=torch.float64, device=device)[:, None] \
        * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float(), emb.sin().float()


def apply_rope(x, cos, sin):
    """DeepSeek-V3's ``apply_rotary_pos_emb`` on x [..., L, H, 64] with
    cos/sin [L, 64]: the interleaved pairs de-interleaved (even lanes,
    then odd), then turned half against half."""
    *lead, d = x.shape
    x = x.view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    cos, sin = cos[:, None], sin[:, None]
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def mla(num: Numerics, p: dict, lay: str, cfg: dict, x, cos, sin, mask):
    """Causal MLA over x [B, L, D] with a boolean keep-mask [B, 1, L, L]."""
    h = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    b, n, _ = x.shape
    a = f"{lay}.self_attn"
    q = num.linear(x, p, f"{a}.q_proj").view(b, n, h, nope + rope)
    c = num.linear(x, p, f"{a}.kv_a_proj_with_mqa")
    c_kv = rms_norm(c[..., :r], p[f"{a}.kv_a_layernorm.weight"], 1e-6)
    k_pe = apply_rope(c[..., None, r:], cos, sin)             # [B, L, 1, 64]
    kv = num.linear(c_kv, p, f"{a}.kv_b_proj").view(b, n, h, nope + vd)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)], -1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, n, h, rope)], -1)
    v = kv[..., nope:]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = num.mm(q, k.transpose(-1, -2)) * (nope + rope) ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    o = num.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, n, -1)
    return num.linear(o, p, f"{a}.o_proj")


def swiglu(num: Numerics, p: dict, name: str, x):
    g = num.linear(x, p, f"{name}.gate_proj")
    return num.linear(F.silu(g) * num.linear(x, p, f"{name}.up_proj"), p,
                      f"{name}.down_proj")


class Routes:
    """Expert choices across a run of ``lm_last_hidden``, by routed layer
    index: ``forced[i]`` [B, T, k] ids that the run takes in place of its
    own choice (-1 where it chooses; a token's row is all -1 or all ids),
    and ``own[i]``, what the run chose itself there, kept.

    A forced row is taken only where it is a near tie on the run's own
    path: each of its ids that the run's own choice does not hold scores
    (``s + b``, the selection score) within ``margin`` under the run's
    own k-th. Elsewhere the token keeps its own choice, and each of its
    forced ids beyond the margin counts in ``flips``. Over the forced rows:
    ``slots``, all forced ids; ``near``, those outside the run's own choice
    but within the margin (taken); ``widest``, the largest gap of any
    forced id; ``beyond``, the forced ids whose gap passes each of
    ``EDGES``."""

    EDGES = tuple(2.0 ** -n for n in range(12, 3, -1))

    def __init__(self, forced: dict | None = None,
                 margin: float = math.inf):
        self.forced = forced or {}
        self.margin = margin
        self.own: dict = {}
        self.flips = self.slots = self.near = 0
        self.widest = 0.0
        self.beyond = [0] * len(self.EDGES)

    def flip_share(self) -> float:
        return self.flips / max(self.slots, 1)

    def take(self, choice, own, forced):
        """The ids a token takes: ``forced`` [T, k] (-1 rows: ``own``)
        where each of its ids lies within the margin of the run's own
        k-th selection score (``choice`` [T, E], ``own`` [T, k]), else
        ``own``; counts the forced ids."""
        use = forced[:, 0] >= 0
        kth = choice.gather(-1, own).min(-1, keepdim=True).values
        gap = (kth - choice.gather(-1, forced.clamp(min=0))).clamp(min=0)
        gap = torch.where(use[:, None], gap, torch.zeros_like(gap))
        far = gap > self.margin
        self.slots += int(use.sum()) * forced.shape[-1]
        self.flips += int(far.sum())
        self.near += int(((gap > 0) & ~far).sum())
        self.widest = max(self.widest, float(gap.max()) if gap.numel()
                          else 0.0)
        for j, edge in enumerate(self.EDGES):
            self.beyond[j] += int((gap > edge).sum())
        keep = use & ~far.any(-1)
        return torch.where(keep[:, None], forced, own)

    def summary(self) -> dict:
        return {"slots": self.slots, "near": self.near, "flips": self.flips,
                "margin": self.margin, "widest": self.widest,
                "beyond": dict(zip(self.EDGES, self.beyond))}


def route(num: Numerics, p: dict, lay: str, cfg: dict, x, forced=None,
          routes: Routes | None = None):
    """The router over x [T, D]: (idx [T, k], weights [T, k], its own
    choice [T, k]); ``forced`` [T, k] (-1 rows: its own choice) replaces
    the choice where ``routes`` takes it (``Routes.take``), and the
    weights are those of the ids taken."""
    s = torch.sigmoid(num.mm(x, p[f"{lay}.mlp.gate.weight"].t()))
    choice = s + p[f"{lay}.mlp.gate.e_score_correction_bias"]
    own = choice.topk(cfg["num_experts_per_tok"], dim=-1).indices
    idx = own if forced is None else routes.take(choice, own, forced)
    w = s.gather(-1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"], own


def moe(num: Numerics, p: dict, lay: str, cfg: dict, x, forced=None,
        routes: Routes | None = None):
    """The routed experts, each over the tokens that chose it (a plain
    per-expert gather), plus the shared experts: x [T, D] -> [T, D];
    ``forced`` and ``routes`` as ``route`` and ``Routes`` take them."""
    idx, w, own = route(num, p, lay, cfg, x, forced, routes)
    fe = cfg["moe_intermediate_size"]
    gate_up = p[f"{lay}.mlp.experts.gate_up"]
    down = p[f"{lay}.mlp.experts.down"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        hgu = num.mm(x[tok], gate_up[e].t())
        hid = F.silu(hgu[:, :fe]) * hgu[:, fe:]
        y.index_add_(0, tok, num.mm(hid, down[e].t()) * w[tok, slot, None])
    return y + swiglu(num, p, f"{lay}.mlp.shared_experts", x), own


@torch.no_grad()
def lm_last_hidden(w: Weights, cfg: dict, embeds, lengths,
                   num: Numerics = FP32, chunk: int = 32,
                   routes: Routes | None = None):
    """The final-normed hidden state at each sequence's last real position:
    embeds [B, L, D] right-padded, lengths [B]; layer by layer, ``chunk``
    sequences at a time; ``routes`` (optional) forces and keeps the expert
    choices (``Routes``)."""
    b, n, _ = embeds.shape
    dev = embeds.device
    cos, sin = rope_tables(cfg, n, dev)
    keep = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev))
    real = torch.arange(n, device=dev)[None] < lengths[:, None].to(dev)
    mask = (keep[None] & real[:, None, :])[:, None]
    eps = cfg["rms_norm_eps"]
    x = embeds
    for i in range(cfg["num_hidden_layers"]):
        lay = f"lm.layers.{i}"
        p = w.group(lay)
        forced = None if routes is None else routes.forced.get(i)
        outs, own = [], []
        for s in range(0, b, chunk):
            xs = x[s:s + chunk]
            h = xs + mla(num, p, lay, cfg, rms_norm(
                xs, p[f"{lay}.input_layernorm.weight"], eps), cos, sin,
                mask[s:s + chunk])
            hn = rms_norm(h, p[f"{lay}.post_attention_layernorm.weight"], eps)
            if i < cfg["first_k_dense_replace"]:
                f = swiglu(num, p, f"{lay}.mlp", hn)
            else:
                f, mine = moe(num, p, lay, cfg, hn.reshape(-1, hn.shape[-1]),
                              None if forced is None else
                              forced[s:s + chunk].flatten(0, 1), routes)
                f = f.view_as(hn)
                own.append(mine.view(*hn.shape[:2], -1))
            outs.append(h + f)
        x = torch.cat(outs)
        if routes is not None and own:
            routes.own[i] = torch.cat(own)
    last = x[torch.arange(b, device=dev), lengths.to(dev) - 1]
    return rms_norm(last, w["lm.norm.weight"], eps)


def prefix_ids(cfg: dict, caption_ids) -> tuple[list[int], list[int]]:
    """A query's ids before and after its reference image's tokens."""
    t = cfg["template"]
    return ([*t["template_ids"], *t["media_start_ids"]],
            [*t["media_end_ids"], *caption_ids])


def suffix_ids(cfg: dict) -> tuple[list[int], list[int]]:
    """A candidate's ids before and after its image's tokens."""
    t = cfg["template"]
    return (list(t["media_start_ids"]),
            [*t["media_end_ids"], *t["question_ids"], *t["assistant_ids"]])


def encode(words: list[str], vocab: list[str]) -> list[int]:
    """A caption's ids: each word's row of the toy vocabulary."""
    ids = {t: i for i, t in enumerate(vocab)}
    return [ids[wd.lower()] for wd in words]


@torch.no_grad()
def scores(w: Weights, cfg: dict, caption_ids: list[list[int]], ref_tokens,
           cand_tokens, num: Numerics = FP32, routes: Routes | None = None):
    """logit(yes) - logit(no) of every (query, candidate): caption_ids one
    list a query, ref_tokens [Q, 196, D], cand_tokens [Q, C, 196, D];
    returns [Q, C]. Each pair's whole sequence, with no cache; its rows in
    ``routes`` (``Routes``: [Q * C, T, k] a routed layer, T the longest
    sequence) are the pairs in (query, candidate) order."""
    emb = w["lm.embed_tokens.weight"]
    dev = emb.device

    def embed(ids):
        return emb[torch.as_tensor(ids, dtype=torch.long, device=dev)]

    sa, sb = suffix_ids(cfg)
    seqs = []
    for qi, cap in enumerate(caption_ids):
        pa, pb = prefix_ids(cfg, cap)
        prefix = torch.cat([embed(pa), ref_tokens[qi], embed(pb)])
        for cand in cand_tokens[qi]:
            seqs.append(torch.cat([prefix, embed(sa), cand, embed(sb)]))
    del emb
    lengths = torch.as_tensor([len(s) for s in seqs])
    embeds = torch.nn.utils.rnn.pad_sequence(seqs, batch_first=True)
    hid = lm_last_hidden(w, cfg, embeds, lengths, num, routes=routes)
    t = cfg["template"]
    head = w["lm.lm_head.weight"][[t["yes_id"], t["no_id"]]]
    logits = num.mm(hid, head.t())
    return (logits[:, 0] - logits[:, 1]).view(len(caption_ids), -1)
