"""Train attention with in-kernel dropout: K5-K9 and their plain versions.

Port of the JAX package's ``ops/pallas_attention_train.py``. The dropout
mask is a pure function of (seed, entry, head, row, col), so the forward
and the backward regenerate it and no mask tensor is kept:

- K5 ``_lowbias32`` / ``_keep_mask``: the keep-mask, a lowbias32 hash.
  ``keep_mask`` is its plain version, bit for bit the JAX mask;
  ``write_keep_mask`` launches the kernel that writes it out.
- K6 ``_fwd_kernel``: fp32 softmax, the mask, kept probabilities times
  1/(1 - rate), the cast to v's dtype, P.V (``attention_train_plain``).
- K7 ``_bwd_kernel``: dq, dk, dv with the mask regenerated
  (``attention_train_bwd_plain``, an explicit backward, not autograd of the
  forward, because it is what the kernel is held against).
- K8 ``_fwd_kernel_folded`` and K9 ``_bwd_kernel_folded``: K6 and K7 over
  head-folded [E, L, H*D] tensors (``attention_train_folded_plain``,
  ``attention_train_folded_bwd_plain``: the unfolded plain versions on
  [E, L, H, D] views, since the mask does not depend on the layout).

``fused_attention_train`` (K6/K7) and ``fused_attention_train_folded``
(K8/K9) are differentiable in q, k, v through ``_TrainAttention``, which
carries the int32 seed and the rate from the forward to the backward. The
bias is head-independent and gets no gradient. CPU tensors take the plain
versions; card tensors take the kernels (``csrc/attention_train.cu``) or
the call raises.

What bounds the kernels on the H100: at the stage-II pair-grid shape
[16, 640, 577, 12, 64] operations (K6 4*Lq*M*D and K7 10*Lq*M*D per entry
and head against (2*Lq + 2*M)*D and (3*Lq + 4*M)*D bf16 elements moved,
303 and 437 operations a byte against the card's 295); at the stage-I MED
shape (at most 40 query rows) the bytes of K and V. Which launch runs
which kernel (the C entry points route; ``fwd_uses_tensor_cores`` and
``bwd_uses_tensor_cores`` state it for reports):

- bf16 without a bias, every launch of both training paths: the tensor
  cores (``csrc/attention_train_tc.cuh``: K6 and K8 are the eval kernel's
  two sweeps with the mask and 1/(1 - rate) applied to p before its bf16
  rounding, K8 with a shallower ring, so that more blocks share an SM;
  K7 and K9 run a row pass and a key pass on wgmma, dv's fp32 product as
  a bf16 hi + lo pair). A misaligned view raises ``ValueError``; nothing
  falls back to the FMA kernels.
- fp32 or with a bias: plain fp32 FMAs (see the CUDA sources).

``eligible`` and its thresholds are copies of the JAX package's, with the
same values, so that the port sends the kernel the same calls.
"""
from __future__ import annotations

import ctypes

import torch

from candidate_reranking_cir_tpu_torch.ops import build, draws, registry
from candidate_reranking_cir_tpu_torch.ops.cuda_attention import (
    DTYPE_CODES,
    KERNEL_HEAD_DIM,
    _bias3,
    bias_args,
    check_kernel_inputs,
    pad_heads,
    raise_on_error,
    scaled_scores,
)

LAUNCHES = registry.TRAIN

MAX_LQ = 1024
MIN_KV = 256
MIN_ROWS = 128
MAX_ENTRIES_FWD = 8
MAX_ENTRIES_BWD = 4

_U32 = 0xFFFFFFFF
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _pick_entries(b: int, lq: int, cap: int = MAX_ENTRIES_BWD) -> int:
    """Largest E <= cap with b % E == 0 and E*lq >= MIN_ROWS; 1 when lq
    already meets MIN_ROWS (or nothing qualifies)."""
    if lq >= MIN_ROWS:
        return 1
    for e in (8, 4, 2):
        if e <= cap and b % e == 0 and e * lq >= MIN_ROWS:
            return e
    return 1


def eligible(lq: int, bias, kv_len: int = MIN_KV,
             batch: int | None = None) -> bool:
    """Whether a call takes the in-kernel-dropout kernels: at most MAX_LQ
    query rows, at least MIN_KV keys, enough rows per Pallas program
    (directly or through an entry block when ``batch`` is given) and a
    head-independent bias. The thresholds were tuned on the TPU; they are
    read at call time."""
    if lq > MAX_LQ or kv_len < MIN_KV:
        return False
    if lq < MIN_ROWS and (batch is None or _pick_entries(batch, lq) == 1):
        return False
    if bias is not None and bias.ndim >= 3 and bias.shape[-3] not in (1,):
        return False
    return True


# ---------------------------------------------------------------------------
# K5, plain: the hash on int64 tensors holding 32-bit values. Every step is
# masked to 32 bits and no product leaves int64's range, so the bits are
# those of the JAX package's int32 arithmetic with wraparound. The second
# multiplier is the JAX package's _M2 = -2073376117, i.e. 0x846ACA8B (its
# comment calls it 0x846CA68B, lowbias32's published constant; the bits
# follow the value).
_M1, _M2 = 0x7FEB352D, 0x846ACA8B


def _mul32(x, m: int):
    """(x * m) mod 2^32 for x < 2^32, in two 16-bit halves of m."""
    lo = (x * (m & 0xFFFF)) & _U32
    hi = (((x * (m >> 16)) & 0xFFFF) << 16)
    return (lo + hi) & _U32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def keep_mask(seed: int, b, h, rows: int, cols: int, rate: float,
              device=None):
    """K5's plain version: bool keep-mask [..., rows, cols].

    b (absolute entry index) and h (head) are ints or int64 tensors that
    broadcast against each other (e.g. [E, 1, 1, 1] and [1, H, 1, 1]).
    salt = hash(seed + b*0x101 + h); bits = hash(salt + row*cols + col);
    keep iff float(bits >> 8) * 2^-24 >= float32(rate)."""
    b = torch.as_tensor(b, dtype=torch.int64, device=device)
    h = torch.as_tensor(h, dtype=torch.int64, device=device)
    salt = _lowbias32((seed + b * 0x101 + h) & _U32)
    idx = (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
           * cols + torch.arange(cols, dtype=torch.int64, device=device))
    bits = _lowbias32((salt[..., None, None] + idx) & _U32)
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    return u >= torch.tensor(rate, dtype=torch.float32, device=device)


def write_keep_mask(out, seed: int, b: int, h: int, rate: float):
    """K5 written out into ``out`` (uint8 [rows, cols], 1 = keep): the
    kernel for a tensor on the card, the plain version on the CPU."""
    if out.dtype != torch.uint8 or out.ndim != 2 or not out.is_contiguous():
        raise ValueError("out must be a contiguous uint8 [rows, cols]")
    rows, cols = out.shape
    _check_seed(seed)
    if out.device.type == "cpu":
        out.copy_(keep_mask(seed, b, h, rows, cols, rate))
        return out
    lib = build.load("attention_train")
    err = lib.crc_keep_mask(seed, b, h, rows, cols, rate, out.data_ptr(),
                            torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 mask kernel launch failed: cudaError {err}")
    LAUNCHES["K5"] += 1
    return out


# ---------------------------------------------------------------------------
# K6 / K7, plain

def _acc_dtype(dtype):
    """fp32 accumulation (float64 stays float64, for gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _probs(q, k, bias3, acc):
    """fp32 softmax probabilities [E, H, Lq, M] (``_head_scores`` and
    ``_softmax_fp32``), the scale applied by the JAX package's rule
    (``scaled_scores``: the accumulated scores times the scale)."""
    scores = scaled_scores(q, k, acc)
    if bias3 is not None:
        scores = scores + bias3.to(acc).unsqueeze(1)
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    return probs / probs.sum(dim=-1, keepdim=True)


def _keep(seed: int, q, m: int, rate: float):
    e, lq, h, _ = q.shape
    dev = q.device
    return keep_mask(seed, torch.arange(e, device=dev).view(e, 1),
                     torch.arange(h, device=dev).view(1, h), lq, m, rate,
                     device=dev)


def attention_train_plain(q, k, v, bias3, seed: int, rate: float):
    """K6's plain version: q [E, Lq, H, D]; k, v [E, M, H, D]; bias3 None
    or fp32 [E, Lq, M]. Returns [E, Lq, H, D] in q's dtype."""
    acc = _acc_dtype(q.dtype)
    probs = _probs(q, k, bias3, acc)
    if rate > 0.0:
        keep = _keep(seed, q, k.shape[1], rate)
        probs = torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)
    out = torch.einsum("ehlm,emhd->elhd", probs.to(v.dtype).to(acc),
                       v.to(acc))
    return out.to(q.dtype)


def attention_train_bwd_plain(q, k, v, bias3, seed: int, g, rate: float):
    """K7's plain version: (dq, dk, dv) of ``attention_train_plain`` for
    the output cotangent g [E, Lq, H, D], with the Pallas kernel's
    precisions (fp32 dropped and g in dv; d_scores times the scale in
    fp32, then cast to q's dtype before dq and dk, at every scale, as
    ``_bwd_kernel`` does)."""
    acc = _acc_dtype(q.dtype)
    scale = q.shape[-1] ** -0.5
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    probs = _probs(q, k, bias3, acc)
    keep = _keep(seed, q, k.shape[1], rate) if rate > 0.0 else None
    dropped = probs if keep is None else torch.where(keep, probs * inv, 0.0)
    g = g.to(acc)
    dv = torch.einsum("ehlm,elhd->emhd", dropped, g).to(v.dtype)
    d_dropped = torch.einsum("elhd,emhd->ehlm", g, v.to(acc))
    d_probs = d_dropped if keep is None else \
        torch.where(keep, d_dropped * inv, 0.0)
    d_scores = probs * (d_probs - (d_probs * probs).sum(-1, keepdim=True))
    d_scores = (d_scores * scale).to(q.dtype).to(acc)
    dq = torch.einsum("ehlm,emhd->elhd", d_scores, k.to(acc)).to(q.dtype)
    dk = torch.einsum("ehlm,elhd->emhd", d_scores, q.to(acc)).to(k.dtype)
    return dq, dk, dv


def _heads(t, num_heads: int):
    """[E, L, H*D] -> its [E, L, H, D] view."""
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads))


def attention_train_folded_plain(q, k, v, bias3, seed: int, rate: float, *,
                                 num_heads: int):
    """K8's plain version: q [E, Lq, H*D]; k, v [E, M, H*D]. K6's plain
    version on [E, L, H, D] views: the mask is the same function of the
    absolute entry index. Returns [E, Lq, H*D]."""
    return attention_train_plain(
        *(_heads(t, num_heads) for t in (q, k, v)), bias3, seed,
        rate).flatten(-2)


def attention_train_folded_bwd_plain(q, k, v, bias3, seed: int, g,
                                     rate: float, *, num_heads: int):
    """K9's plain version: (dq, dk, dv) [E, L, H*D] of
    ``attention_train_folded_plain`` for the cotangent g [E, Lq, H*D]."""
    grads = attention_train_bwd_plain(
        *(_heads(t, num_heads) for t in (q, k, v)), bias3, seed,
        _heads(g, num_heads), rate)
    return tuple(x.flatten(-2) for x in grads)


# ---------------------------------------------------------------------------
# K6 - K9, the kernels

def _check_seed(seed: int) -> None:
    if not _INT32_MIN <= seed <= _INT32_MAX:
        raise ValueError(f"seed {seed} is not an int32")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _kernel_fwd(q, k, v, bias3, seed: int, rate: float, *,
                folded: bool = False):
    """K6 on [E, L, H, d] views, or K8 (``folded``) on the [E, L, H, d]
    views of [E, L, H*d] tensors. Heads narrower than the kernels' width
    run zero-padded (``pad_heads``: the padded copy of a folded tensor has
    the head stride ``KERNEL_HEAD_DIM`` that K8 takes) at their own scale,
    and the output is sliced back to d."""
    lib = build.load("attention_train")
    d = q.shape[-1]
    scale = d ** -0.5
    q, k, v = pad_heads(q, k, v)
    e, lq, h, _, m = check_kernel_inputs({"q": q, "k": k, "v": v},
                                         KERNEL_HEAD_DIM,
                                         lib.crc_attention_train_max_keys())
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    bias_ptr, bias_strides = bias_args(bias3, q.device)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3], *bias_strides]
    kid = "K8" if folded else "K6"
    launch = lib.crc_attention_train_folded_forward if folded \
        else lib.crc_attention_train_forward
    err = launch(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_ptr, out.data_ptr(), (ctypes.c_longlong * 14)(*strides), e, h,
        lq, m, scale, seed, rate, 1.0 / (1.0 - rate), _stream(q.device))
    raise_on_error(err, kid, {"q": q, "k": k, "v": v, "out": out})
    LAUNCHES[kid] += 1
    if rate > 0.0:
        LAUNCHES["K5"] += 1
    return out if d == KERNEL_HEAD_DIM else out[..., :d]


def fwd_uses_tensor_cores(dtype, bias3, folded: bool) -> bool:
    """Whether a forward launch runs the tensor-core kernel: K6 and K8
    alike in bf16 without a bias. The C entry point does the routing."""
    return dtype == torch.bfloat16 and bias3 is None


def folded_forward_blocks_per_sm(lq: int, m: int) -> int:
    """How many blocks of the bf16 K8 kernel for ``lq`` rows and ``m`` keys
    an SM of the current card holds at once."""
    lib = build.load("attention_train")
    blocks = lib.crc_attention_train_folded_forward_blocks_per_sm(lq, m)
    if blocks < 0:
        raise RuntimeError(f"K8 occupancy query failed: cudaError {-blocks}")
    return blocks


def bwd_uses_tensor_cores(dtype, bias3, folded: bool) -> bool:
    """Whether a backward launch runs the tensor-core passes: K7 and K9
    alike in bf16 without a bias. The C entry point does the routing."""
    return dtype == torch.bfloat16 and bias3 is None


def _kernel_bwd(q, k, v, bias3, seed: int, g, rate: float, *,
                folded: bool = False):
    """K7, or K9 (``folded``), on [E, L, H, d] views as ``_kernel_fwd``,
    narrow heads zero-padded and dq, dk, dv sliced back to d."""
    lib = build.load("attention_train")
    d = q.shape[-1]
    scale = d ** -0.5
    q, k, v, g = pad_heads(q, k, v, g)
    e, lq, h, _, m = check_kernel_inputs(
        {"q": q, "k": k, "v": v, "g": g}, KERNEL_HEAD_DIM,
        lib.crc_attention_train_max_keys())
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    stats = torch.empty((3, e, h, lq), dtype=torch.float32, device=q.device)
    bias_ptr, bias_strides = bias_args(bias3, q.device)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *g.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
               *dv.stride()[:3], *bias_strides]
    inv = 1.0 / (1.0 - rate)
    kid = "K9" if folded else "K7"
    launch = lib.crc_attention_train_folded_backward if folded \
        else lib.crc_attention_train_backward
    err = launch(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_ptr, g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), (ctypes.c_longlong * 23)(*strides), e, h, lq, m,
        scale, seed, rate, inv, _stream(q.device))
    raise_on_error(err, kid, {"q": q, "k": k, "v": v, "g": g, "dq": dq,
                              "dk": dk, "dv": dv})
    LAUNCHES[kid] += 1
    if rate > 0.0:
        LAUNCHES["K5"] += 1
    if d == KERNEL_HEAD_DIM:
        return dq, dk, dv
    return dq[..., :d], dk[..., :d], dv[..., :d]


class _TrainAttention(torch.autograd.Function):
    """K6 forward and K7 backward on [E, L, H, D] tensors, or K8 and K9
    (``folded``: [E, L, H, D] views of [E, L, H*D] tensors); plain versions
    on the CPU. The seed and the rate ride from the forward to the
    backward, so the mask is regenerated, never stored."""

    @staticmethod
    def forward(ctx, q, k, v, bias3, seed: int, rate: float, folded: bool):
        ctx.seed, ctx.rate, ctx.folded = seed, rate, folded
        ctx.save_for_backward(q, k, v, bias3)
        if q.device.type == "cpu":
            return attention_train_plain(q, k, v, bias3, seed, rate)
        return _kernel_fwd(q, k, v, bias3, seed, rate, folded=folded)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias3 = ctx.saved_tensors
        g = g.contiguous()  # the kernels read g's last axis at stride 1
        if q.device.type == "cpu":
            grads = attention_train_bwd_plain(q, k, v, bias3, ctx.seed, g,
                                              ctx.rate)
        else:
            grads = _kernel_bwd(q, k, v, bias3, ctx.seed, g, ctx.rate,
                                folded=ctx.folded)
        return (*grads, None, None, None, None)


def _train_bias3(bias, e: int, lq: int, m: int):
    """Head-independent [E, 1, Lq|1, M] or [E, Lq|1, M] -> an [E, Lq, M]
    view (``_prep``); broadcast rows keep stride 0."""
    if bias is not None and bias.ndim == 3:
        bias = bias[:, None]
    return _bias3(bias, e, lq, m)


def _check_train_args(q, k, v, nd: int, seed, rate: float) -> None:
    if q.ndim != nd or k.ndim != nd or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_seed(int(seed))
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is outside [0, 1)")


def fused_attention_train(q, k, v, bias, seed: int, rate: float):
    """Attention with in-kernel dropout (K6/K7), differentiable in q, k, v.

    q [E, Lq, H, D]; k, v [E, M, H, D]; bias None or head-independent
    additive [E, 1, Lq|1, M] / [E, Lq|1, M]; seed an int32; rate static.
    The mask is keyed by the absolute entry index of this call."""
    _check_train_args(q, k, v, 4, seed, rate)
    e, lq, _, _ = q.shape
    bias3 = _train_bias3(bias, e, lq, k.shape[1])
    return _TrainAttention.apply(q, k, v, bias3,
                                 draws.entry_seed(int(seed), e), float(rate),
                                 False)


def fused_attention_train_folded(q, k, v, bias, seed: int, rate: float, *,
                                 num_heads: int):
    """Head-folded twin (K8/K9): q [E, Lq, H*D]; k, v [E, M, H*D]. The mask
    is the same function of (seed, entry, head, row, col) as unfolded, so
    the two are interchangeable. Returns [E, Lq, H*D]."""
    _check_train_args(q, k, v, 3, seed, rate)
    e, lq, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"width {hd} not divisible by {num_heads} heads")
    bias3 = _train_bias3(bias, e, lq, k.shape[1])
    return _TrainAttention.apply(
        *(_heads(t, num_heads) for t in (q, k, v)), bias3,
        draws.entry_seed(int(seed), e), float(rate), True).flatten(-2)
