"""Eval attention kernels K1-K4 and their plain PyTorch versions.

Each wrapper replaces one Pallas kernel of the JAX package's
``ops/pallas_attention.py``:

- K1 ``_attn_kernel_folded``: ``fused_attention_folded``, no bias
- K2 ``_attn_bias_kernel``: ``fused_attention`` with a bias
- K3 ``_attn_kernel``: ``fused_attention``, no bias
- K4 ``_attn_bias_kernel_folded``: ``fused_attention_folded`` with a bias

Folded means q/k/v [E, L, H*D]; unfolded [E, L, H, D]. All four call one C
entry point (``csrc/attention.cu``), which routes by dtype: bf16 (K1-K4 on
every path, with or without a bias) runs the tensor-core kernel
``attn_fwd_tc_kernel`` (``csrc/attention_tc.cuh``: wgmma, K/V tiles
streamed through shared memory, the exact softmax in two sweeps over the
keys, or one step when the keys fit one 64-key tile, the bias added to the
scaled score); fp32 runs ``attn_fwd_kernel``, fp32 FMAs over whole score
rows held in shared memory. The C entry point also holds the rules of what
each kernel takes (16-byte aligned base pointers and strides for the
tensor-core kernel's 16-byte copies, a key cap for the other) and refuses
the rest with a code the wrapper raises on.

What bounds them on the H100 at the main path's shapes: bytes for K1 (the
ViT's 577 x 577 by a hair, the MED's 40 x 577 clearly) and for K2/K4
(with latency at K2's one-tile text heads); operations for K3 at 1,280
rows per candidate, bytes at its narrowest call of 32 rows (``PERF.md``
has each bound).

Head widths and the scale: the kernels are built for d = 64 (ViT-B/16's
and the MED's heads). A narrower head (the tiny configs' 6 or 8) runs
zero-padded to 64 (``pad_heads``) with its own scale d ** -0.5, and the
output is sliced back. The tensor-core kernel also takes d = 88
(``WIDE_HEAD_DIM``: EVA ViT-g's heads in BLIP-2's vision tower) and d = 72
(``MOONVIT_HEAD_DIM``: MoonViT's heads in Kimi-VL's vision tower) in bf16
without a bias, K1 and K3: it reads those heads where they lie and pads
them to its products' widths in shared memory, so no padded copy is made;
those launches count in ``LAUNCHES`` under their kernel id and in
``registry.WIDE`` ("K1_d88", "K3_d88", "K1_d72", "K3_d72") too. Any other
width above 64 raises. The scale follows the JAX package's rule (``scaled_scores``): the
fp32 scores times the scale, at every width, in the kernels and the plain
versions alike (bit-equal to JAX's fold of a power-of-two scale into q).

A tensor on the CPU goes to the plain version; a tensor on the card goes to
the kernel or the wrapper raises. ``LAUNCHES`` (``registry.EVAL``) counts
kernel launches per kernel id; only a launch adds to it.

Gradients: on the card, where an input wants one, the kernel runs inside
``registry.PlainBackward``, whose backward recomputes the plain version
under autograd, as the JAX package's ``custom_vjp`` backward recomputes
with XLA (``pallas_attention.py`` ``_bwd`` / ``_folded_bwd``); elsewhere
the kernel is called directly. The bias gets no gradient. On the CPU the
plain version runs under autograd directly.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from candidate_reranking_cir_tpu_torch.ops import build, registry

LAUNCHES = registry.EVAL

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
KERNEL_HEAD_DIM = 64  # the head width the kernels are built for (kHeadDim)
# the tensor-core kernel's other widths (kWideHeadDim, kMoonViTHeadDim)
WIDE_HEAD_DIM = 88
MOONVIT_HEAD_DIM = 72
WIDE_HEAD_DIMS = (MOONVIT_HEAD_DIM, WIDE_HEAD_DIM)


def scaled_scores(q, k, acc=torch.float32):
    """Scores [.., H, Lq, M] = q.k^T * d ** -0.5 in ``acc`` (q [.., Lq, H,
    D], k [.., M, H, D]): the accumulated
    scores times the scale, as the kernels do. This is the JAX package's
    rule (``_head_attention``, ``_head_scores``) in one path: JAX folds an
    exact power of two (d = 4^n, 64 on every path) into q, which only
    shifts exponents and so rounds as the product does, and multiplies
    the scores by any other scale."""
    return torch.einsum("...lhd,...mhd->...hlm", q.to(acc), k.to(acc)) \
        * q.shape[-1] ** -0.5


def attention_plain(q, k, v, bias=None):
    """Plain version of the kernels' function.

    q [E, Lq, H, D]; k, v [E, M, H, D]; bias None or fp32 broadcastable to
    [E, Lq, M] (head-independent). fp32 scores with the scale applied by
    ``scaled_scores``' rule, max-subtracted exp, a divide, probabilities
    cast to v's dtype before P.V, fp32 P.V accumulation, output in q's
    dtype.
    """
    dtype = q.dtype
    scores = scaled_scores(q, k)
    if bias is not None:
        scores = scores + bias.float().unsqueeze(1)
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("ehlm,emhd->elhd", probs.float(), v.float())
    return out.to(dtype)


def _bias3(bias, e: int, lq: int, m: int):
    """[E, 1, Lq|1, M] head-independent bias -> [E, Lq, M] view (row
    stride 0 where it broadcasts; nothing is materialised)."""
    if bias is None:
        return None
    if bias.ndim != 4 or bias.shape[1] != 1:
        raise ValueError("bias must be [E, 1, Lq|1, M] (head-independent); "
                         f"got {tuple(bias.shape)}")
    return bias[:, 0].expand(e, lq, m)


def check_kernel_inputs(tensors: dict, head_dim: int,
                        max_keys: int | None = None):
    """Raise on what the attention kernels (eval and train) do not take.
    ``tensors``: 4-D [E, L, H, D] views, q first and k second; ``max_keys``
    None where the C entry point checks the key count itself. Returns
    (entries, query rows, heads, head_dim, keys)."""
    q, k = tensors["q"], tensors["k"]
    e, lq, h, d = q.shape
    m = k.shape[1]
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head_dim axis must have stride 1")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32 or bfloat16)")
    if d != head_dim:
        raise ValueError(f"head_dim {d} unsupported (kernel takes "
                         f"{head_dim})")
    if max_keys is not None and m > max_keys:
        raise ValueError(f"{m} keys exceed the kernel's {max_keys} "
                         "(score rows are held in shared memory)")
    if e > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"entries {e} / heads {h} exceed the grid limit")
    if lq < 1 or m < 1:
        raise ValueError("empty query or key axis")
    return e, lq, h, d, m


def pad_heads(*tensors):
    """[.., H, d] views -> zero-padded to the kernels' head width
    [.., H, KERNEL_HEAD_DIM] (the same tensors at d = KERNEL_HEAD_DIM).
    Padded lanes add exact zeros to every score and every gradient, and
    the outputs' padded lanes are zeros that the caller slices off; the
    caller launches at the true scale d ** -0.5. Widths above the kernels'
    raise."""
    d = tensors[0].shape[-1]
    if d > KERNEL_HEAD_DIM:
        raise ValueError(f"head width {d} exceeds the attention kernels' "
                         f"{KERNEL_HEAD_DIM}")
    if d == KERNEL_HEAD_DIM:
        return tensors
    return tuple(F.pad(t, (0, KERNEL_HEAD_DIM - d)) for t in tensors)


def bias_args(bias3, device) -> tuple[int | None, list[int]]:
    """(pointer, [entry, row] strides) of an fp32 [E, Lq, M] bias view, or
    (None, [0, 0]) without one."""
    if bias3 is None:
        return None, [0, 0]
    if bias3.dtype != torch.float32 or bias3.device != device:
        raise ValueError("bias must be float32 on the inputs' device")
    if bias3.stride(-1) != 1 and bias3.shape[-1] > 1:
        raise ValueError("bias key axis must have stride 1")
    return bias3.data_ptr(), list(bias3.stride()[:2])


def uses_tensor_cores(dtype) -> bool:
    """Whether an eval launch runs the tensor-core kernel (every bf16 one,
    with or without a bias), for reports; the C entry point does the
    routing."""
    return dtype == torch.bfloat16


# the C entry points' refusals (csrc/attention.cu, and the alignment one of
# K6's, K7's and K9's in csrc/attention_train.cu); a positive code is a
# cudaError
REFUSED_KEYS, REFUSED_ALIGNMENT, REFUSED_HEAD_DIM = -1, -2, -3


def raise_on_error(err: int, kid: str, tensors: dict) -> None:
    """Raise for a nonzero code of an attention entry point: ValueError
    for what the routed kernel does not take, RuntimeError for a cudaError.
    ``tensors``: the launch's input and output views, named."""
    if err == REFUSED_KEYS:
        raise ValueError(
            f"{kid}: {tensors['k'].shape[1]} keys exceed the fp32-FMA "
            "kernel's cap (score rows are held in shared memory)")
    if err == REFUSED_HEAD_DIM:
        raise ValueError(
            f"{kid}: head width {tensors['q'].shape[-1]} is not one the "
            "kernel takes in this dtype and with this bias")
    if err == REFUSED_ALIGNMENT:
        views = "; ".join(f"{n} pointer offset {t.data_ptr() % 16}, strides "
                          f"{tuple(t.stride())}" for n, t in tensors.items())
        raise ValueError(
            f"{kid}: the tensor-core kernel needs 16-byte aligned base "
            f"pointers and entry, row and head strides; got {views}")
    if err != 0:
        raise RuntimeError(f"attention kernel {kid} launch failed: "
                           f"cudaError {err}")


def _launch(kid: str, q4, k4, v4, bias3, out4, scale: float) -> None:
    """Launch the CUDA kernel on 4-D [E, L, H, KERNEL_HEAD_DIM] views
    (strided) at ``scale``, or [E, L, H, d] ones for d in WIDE_HEAD_DIMS
    (bf16, no bias)."""
    lib = build.load("attention")
    wide = q4.shape[-1] in WIDE_HEAD_DIMS
    e, lq, h, d, m = check_kernel_inputs(
        {"q": q4, "k": k4, "v": v4},
        q4.shape[-1] if wide else lib.crc_attention_head_dim())
    bias_ptr, bias_strides = bias_args(bias3, q4.device)
    strides = [*q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
               *out4.stride()[:3], *bias_strides]
    c_strides = (ctypes.c_longlong * 14)(*strides)
    err = lib.crc_attention_forward(
        DTYPE_CODES[q4.dtype], d, q4.data_ptr(), k4.data_ptr(),
        v4.data_ptr(), bias_ptr, out4.data_ptr(), c_strides, e, h, lq, m,
        scale, torch.cuda.current_stream(out4.device).cuda_stream)
    raise_on_error(err, kid, {"q": q4, "k": k4, "v": v4, "out": out4})
    LAUNCHES[kid] += 1
    if wide:
        registry.WIDE[f"{kid}_d{d}"] += 1


def takes_wide_heads(q4, bias3) -> bool:
    """Whether a launch runs at its own width as it is: 72- or 88-wide
    bf16 heads without a bias (K1, K3)."""
    return (q4.shape[-1] in WIDE_HEAD_DIMS and q4.dtype == torch.bfloat16
            and bias3 is None)


def _kernel_forward(kid: str, q4, k4, v4, bias3):
    """The kernel's output [E, Lq, H, d] for 4-D views q4, k4, v4; heads
    narrower than the kernels' width run zero-padded (``pad_heads``) at
    their own scale, and the output is sliced back to d; 72- and 88-wide
    heads (``takes_wide_heads``) run as they are."""
    d = q4.shape[-1]
    if not takes_wide_heads(q4, bias3):
        q4, k4, v4 = pad_heads(q4, k4, v4)
    out = torch.empty(q4.shape, dtype=q4.dtype, device=q4.device)
    _launch(kid, q4, k4, v4, bias3, out, d ** -0.5)
    return out if out.shape[-1] == d else out[..., :d]


def _plain_forward(kid: str, q4, k4, v4, bias3):
    """``_kernel_forward``'s plain version: no gradient for the bias."""
    return attention_plain(q4, k4, v4,
                           None if bias3 is None else bias3.detach())


def _check_shapes(q, k, v, nd: int) -> None:
    if q.ndim != nd or k.ndim != nd or v.ndim != nd:
        raise ValueError(f"q/k/v must be {nd}-D")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def fused_attention(q, k, v, bias=None):
    """Unfolded eval attention: q [E, Lq, H, D]; k, v [E, M, H, D]; bias
    None (K3) or head-independent additive [E, 1, Lq|1, M] (K2).
    Returns [E, Lq, H, D] in q's dtype."""
    _check_shapes(q, k, v, 4)
    e, lq, _, _ = q.shape
    bias3 = _bias3(bias, e, lq, k.shape[1])
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias3)
    return registry.run(_kernel_forward, _plain_forward,
                        "K2" if bias3 is not None else "K3", q, k, v, bias3)


def fused_attention_folded(q, k, v, bias=None, *, num_heads: int):
    """Head-folded eval attention: q [E, Lq, H*D]; k, v [E, M, H*D]; bias
    None (K1) or head-independent additive [E, 1, Lq|1, M] (K4).
    Returns [E, Lq, H*D] in q's dtype."""
    _check_shapes(q, k, v, 3)
    e, lq, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"width {hd} not divisible by {num_heads} heads")
    d = hd // num_heads
    bias3 = _bias3(bias, e, lq, k.shape[1])
    q4, k4, v4 = (t.unflatten(-1, (num_heads, d)) for t in (q, k, v))
    if q.device.type == "cpu":
        return attention_plain(q4, k4, v4, bias3).flatten(-2)
    return registry.run(_kernel_forward, _plain_forward,
                        "K4" if bias3 is not None else "K1", q4, k4, v4,
                        bias3).flatten(-2)
