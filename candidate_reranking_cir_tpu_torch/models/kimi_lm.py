"""Kimi-VL's language model, a deepseek_v3 decoder (DeepSeek-V3's
``modeling_deepseek.py``; Kimi-VL-A3B-Instruct's ``config.json``), for
scoring: the layers run over a causal prefix, keeping each layer's latent,
and over suffixes that attend to a prefix's latent.

- Pre-RMSNorm blocks, eps 1e-5 (the statistics and the gain in float32,
  rounded once to the compute dtype): ``h = x + MLA(norm(x))``,
  ``out = h + FFN(norm(h))``; a final RMSNorm; an untied head.
- MLA, without a query latent: ``q = x Wq`` as 16 heads of [nope 128 | rope
  64]; ``c = x Wkv_a = [c_kv 512 | k_pe 64]``, ``c_kv = RMSNorm(c_kv)``
  (eps 1e-6, the module's default); ``[k_nope | v] = c_kv Wkv_b`` as 16
  heads of [128 | 128]; rotary embeddings (theta 800,000) on q's rope lanes
  and on the head-shared k_pe, their lanes read as interleaved pairs and
  turned as DeepSeek-V3's ``apply_rotary_pos_emb`` turns them (so that a
  published checkpoint loads as it is); scale 192 ** -0.5; ``out = attn
  Wo``. A layer's latent, what a prefix keeps, is ``[c_kv | roped k_pe]``:
  576 values a token (1,152 bytes in bf16, against 8,192 for its per-head
  K/V). The attention runs through ``ops/attention.sdpa_attention``: no
  kernel of the port takes these head widths.
- Layer 0's FFN is a dense SwiGLU MLP (11,264). Layers 1-26 route:
  ``s = sigmoid(x Wg^T)`` in float32 over 64 experts, ``idx = top6(s +
  b)`` with b the selection-only ``e_score_correction_bias``, ``w =
  s[idx] / (sum s[idx] + 1e-20) * 2.446``; ``y = sum_i w_i E_i(x) + S(x)``
  with ``E(x) = Wd(silu(Wg x) * Wu x)`` at width 1,408 (the experts'
  weights stacked, ``ops/moe.grouped_experts``) and S the shared SwiGLU MLP
  at 2,816. One group (``n_group`` 1), so the group selection of
  ``noaux_tc`` selects everything.
- Positions run over the whole sequence: a suffix continues its prefix's.

Parameters are held in ``param_dtype`` (bf16 for Kimi-VL: 16 B of them
have no room for float32 copies); the norms' gains, the router's
correction bias and the router's product are float32. Eval only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from candidate_reranking_cir_tpu_torch.config import KimiLMConfig
from candidate_reranking_cir_tpu_torch.models.layers import Dense
from candidate_reranking_cir_tpu_torch.ops.attention import sdpa_attention
from candidate_reranking_cir_tpu_torch.ops.moe import grouped_experts, swiglu


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x = x.float()
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return (self.weight * x).to(self.dtype)


def rope_tables(cfg: KimiLMConfig, positions):
    """cos, sin [..., 64] float32 of integer ``positions`` [...]
    (DeepSeek-V3's rotary cache: the frequencies repeated)."""
    dim = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, dim, 2, dtype=torch.float64, device=positions.device) / dim))
    freqs = positions.double()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float(), emb.sin().float()


def apply_rope(x, cos, sin):
    """``apply_rotary_pos_emb`` on x [B, L, H, 64] with cos, sin [B or 1, L,
    64]: the interleaved pairs de-interleaved (even lanes, then odd), then
    turned half against half, in float32; returned in x's dtype."""
    *lead, d = x.shape
    y = x.float().view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    half = torch.cat([-y[..., d // 2:], y[..., :d // 2]], dim=-1)
    return (y * cos[..., None, :] + half * sin[..., None, :]).to(x.dtype)


class Prefix:
    """What a suffix pass reads of a prefix layer: its K/V, up-projected
    once from the kept latent, repeated for ``per`` suffix rows a prefix
    row, and the keep-mask [rows, 1, Ls, Lp + Ls] over [prefix; suffix]."""

    def __init__(self, k, v, per: int, mask):
        self.k, self.v, self.per, self.mask = k, v, per, mask


class MLAttention(nn.Module):
    def __init__(self, cfg: KimiLMConfig, dtype, device, param_dtype):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        kw = dict(device=device, bias=False, param_dtype=param_dtype)
        self.q_proj = Dense(d, h * cfg.qk_head_dim, dtype, **kw)
        self.kv_a_proj_with_mqa = Dense(
            d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype, **kw)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.kv_norm_eps,
                                      dtype, device)
        self.kv_b_proj = Dense(cfg.kv_lora_rank,
                               h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                               dtype, **kw)
        self.o_proj = Dense(h * cfg.v_head_dim, d, dtype, **kw)

    def latent(self, x, cos, sin):
        """[c_kv normed | roped k_pe] of x [B, L, D]: [B, L, 576]."""
        r = self.cfg.kv_lora_rank
        c = self.kv_a_proj_with_mqa(x)
        k_pe = apply_rope(c[..., None, r:], cos, sin)[..., 0, :]
        return torch.cat([self.kv_a_layernorm(c[..., :r]), k_pe], dim=-1)

    def keys_values(self, latent):
        """K [B, L, H, 192] and V [B, L, H, 128] of a latent [B, L, 576]."""
        cfg = self.cfg
        r, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
        kv = self.kv_b_proj(latent[..., :r]).unflatten(
            -1, (cfg.num_attention_heads, nope + cfg.v_head_dim))
        k_pe = latent[..., None, r:].expand(*kv.shape[:-1], -1)
        return torch.cat([kv[..., :nope], k_pe], dim=-1), kv[..., nope:]

    def queries(self, x, cos, sin):
        cfg = self.cfg
        nope = cfg.qk_nope_head_dim
        q = self.q_proj(x).unflatten(-1, (cfg.num_attention_heads,
                                          cfg.qk_head_dim))
        return torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)],
                         dim=-1)

    def forward(self, x, cos, sin, prefix: Prefix | None = None,
                last: bool = False):
        """(output [B, L, D], latent [B, L, 576]): causal over x alone, or
        with ``prefix`` over [prefix; x] under its mask. ``last``: the
        output of the last row alone ([B, 1, D])."""
        latent = self.latent(x, cos, sin)
        k, v = self.keys_values(latent)
        rows = slice(-1, None) if last else slice(None)
        q = self.queries(x[:, rows], cos[:, rows], sin[:, rows])
        if prefix is None:
            out = sdpa_attention(q, k, v, causal=not last)
        else:
            k = torch.cat([prefix.k.repeat_interleave(prefix.per, 0), k], 1)
            v = torch.cat([prefix.v.repeat_interleave(prefix.per, 0), v], 1)
            out = sdpa_attention(q, k, v, prefix.mask[:, :, rows])
        return self.o_proj(out.flatten(-2)), latent


class SwiGLU(nn.Module):
    def __init__(self, d: int, f: int, dtype, device, param_dtype):
        super().__init__()
        kw = dict(device=device, bias=False, param_dtype=param_dtype)
        self.gate_proj = Dense(d, f, dtype, **kw)
        self.up_proj = Dense(d, f, dtype, **kw)
        self.down_proj = Dense(f, d, dtype, **kw)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class Router(nn.Module):
    """The sigmoid router (``noaux_tc``, one group): (idx [T, k], weights
    [T, k] float32) of x [T, D]; the correction bias picks the experts and
    never weighs them."""

    def __init__(self, cfg: KimiLMConfig, device, param_dtype):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.zeros(
            cfg.n_routed_experts, cfg.hidden_size, device=device,
            dtype=param_dtype))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts, device=device))

    def forward(self, x):
        cfg = self.cfg
        s = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        idx = torch.topk(s + self.e_score_correction_bias,
                         cfg.num_experts_per_tok, dim=-1).indices
        w = s.gather(-1, idx)
        if cfg.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * cfg.routed_scaling_factor


class Experts(nn.Module):
    """The routed experts' weights, stacked: gate and up [E, 2F, D] (gate
    first), down [E, D, F]."""

    def __init__(self, cfg: KimiLMConfig, device, param_dtype):
        super().__init__()
        e, d, f = (cfg.n_routed_experts, cfg.hidden_size,
                   cfg.moe_intermediate_size)
        self.gate_up = nn.Parameter(torch.zeros(e, 2 * f, d, device=device,
                                                dtype=param_dtype))
        self.down = nn.Parameter(torch.zeros(e, d, f, device=device,
                                             dtype=param_dtype))


class MoE(nn.Module):
    def __init__(self, cfg: KimiLMConfig, dtype, device, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.gate = Router(cfg, device, param_dtype)
        self.experts = Experts(cfg, device, param_dtype)
        self.shared_experts = SwiGLU(
            cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts,
            dtype, device, param_dtype)

    def forward(self, x):
        flat = x.reshape(-1, x.shape[-1])
        idx, w = self.gate(flat)
        y = grouped_experts(flat, idx, w, self.experts.gate_up,
                            self.experts.down)
        return y.add_(self.shared_experts(flat)).to(self.dtype).view_as(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiLMConfig, index: int, dtype, device,
                 param_dtype):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, dtype, device)
        self.self_attn = MLAttention(cfg, dtype, device, param_dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps, dtype,
                                                device)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype,
                           device, param_dtype)
                    if index < cfg.first_k_dense_replace
                    else MoE(cfg, dtype, device, param_dtype))

    def forward(self, x, cos, sin, prefix: Prefix | None = None,
                last: bool = False):
        """(output, latent); ``last``: the last row's output alone."""
        a, latent = self.self_attn(self.input_layernorm(x), cos, sin, prefix,
                                   last)
        h = (x[:, -1:] if last else x) + a
        return h + self.mlp(self.post_attention_layernorm(h)), latent


class KimiLM(nn.Module):
    def __init__(self, cfg: KimiLMConfig, dtype=torch.float32, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=param_dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i, dtype, device, param_dtype)
            for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype, device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, dtype, device,
                             bias=False, param_dtype=param_dtype)

    def embed(self, ids):
        return self.embed_tokens(ids).to(self.dtype)

    def prefix_latents(self, x) -> list:
        """Each layer's latent [B, L, 576] of a causal pass over right-padded
        embeddings x [B, L, D] (rows past a sequence's end are computed and
        never read)."""
        pos = torch.arange(x.shape[1], device=x.device)[None]
        cos, sin = rope_tables(self.cfg, pos)
        latents = []
        for layer in self.layers:
            x, latent = layer(x, cos, sin)
            latents.append(latent)
        return latents

    def suffix_last(self, x, positions, latents, lengths, per: int):
        """The final-normed last rows [B, D] of suffixes x [B, Ls, D] at
        ``positions`` [B, Ls], each of the ``per`` rows of prefix row
        ``b // per`` attending to that prefix's first ``lengths[b // per]``
        tokens (``latents``: the prefix pass's) and causally to its own."""
        cos, sin = rope_tables(self.cfg, positions)
        ls, lp = x.shape[1], latents[0].shape[1]
        dev = x.device
        real = torch.arange(lp, device=dev)[None] \
            < lengths.repeat_interleave(per)[:, None]
        causal = torch.ones(ls, ls, dtype=torch.bool, device=dev).tril()
        mask = torch.cat([real[:, None, :].expand(-1, ls, -1),
                          causal.expand(len(x), -1, -1)], dim=-1)[:, None]
        last = len(self.layers) - 1
        for i, (layer, latent) in enumerate(zip(self.layers, latents)):
            k, v = layer.self_attn.keys_values(latent)
            x, _ = layer(x, cos, sin, Prefix(k, v, per, mask), last=i == last)
        return self.norm(x[:, -1])
