"""Eval attention kernels K1-K4 and their plain PyTorch versions.

Each wrapper replaces one Pallas kernel of the JAX package's
``ops/pallas_attention.py``; all four launch the same strided CUDA kernel
(``csrc/attention.cu``, one template over fp32/bf16 and bias/no bias):

- K1 ``_attn_kernel_folded``: ``fused_attention_folded``, no bias
- K2 ``_attn_bias_kernel``: ``fused_attention`` with a bias
- K3 ``_attn_kernel``: ``fused_attention``, no bias
- K4 ``_attn_bias_kernel_folded``: ``fused_attention_folded`` with a bias

Folded means q/k/v [E, L, H*D]; unfolded [E, L, H, D].

What bounds them on the H100: arithmetic (4*Lq*M*D operations per entry and
head against (Lq + 2M)*D elements moved); the kernel keeps whole fp32 score
rows in shared memory so that the softmax is exact, and uses fp32 FMAs, so
it runs well below the bf16 tensor-core bound (see ``csrc/attention.cu``).

A tensor on the CPU goes to the plain version; a tensor on the card goes to
the kernel or the wrapper raises. ``LAUNCHES`` counts kernel launches per
kernel id; only a launch adds to it.
"""
from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def attention_plain(q, k, v, bias=None):
    """Plain version of the kernels' function.

    q [E, Lq, H, D]; k, v [E, M, H, D]; bias None or fp32 broadcastable to
    [E, Lq, M] (head-independent). Scale folded into q in q's dtype, fp32
    scores, max-subtracted exp, a divide, probabilities cast to v's dtype
    before P.V, fp32 P.V accumulation, output in q's dtype.
    """
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("elhd,emhd->ehlm", (q * scale).float(), k.float())
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


def _launch(kid: str, q4, k4, v4, bias3, out4) -> None:
    """Launch the CUDA kernel on 4-D [E, L, H, D] views (strided)."""
    from candidate_reranking_cir_tpu_torch.ops.build import (
        load_attention_library,
    )

    lib = load_attention_library()
    e, lq, h, d = q4.shape
    m = k4.shape[1]
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.device != out4.device:
            raise ValueError(f"{name} is on {t.device}, out on {out4.device}")
        if t.dtype != q4.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q4.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head_dim axis must have stride 1")
    if q4.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q4.dtype} (float32 or bfloat16)")
    if d != lib.crc_attention_head_dim():
        raise ValueError(f"head_dim {d} unsupported (kernel takes "
                         f"{lib.crc_attention_head_dim()})")
    max_keys = lib.crc_attention_max_keys()
    if m > max_keys:
        raise ValueError(f"{m} keys exceed the kernel's {max_keys} "
                         "(score rows are held in shared memory)")
    if e > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"entries {e} / heads {h} exceed the grid limit")
    if lq < 1 or m < 1:
        raise ValueError("empty query or key axis")
    strides = [*q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
               *out4.stride()[:3], 0, 0]
    bias_ptr = None
    if bias3 is not None:
        if bias3.dtype != torch.float32 or bias3.device != out4.device:
            raise ValueError("bias must be float32 on the output's device")
        if bias3.stride(-1) != 1 and m > 1:
            raise ValueError("bias key axis must have stride 1")
        strides[12:14] = bias3.stride()[:2]
        bias_ptr = bias3.data_ptr()
    c_strides = (ctypes.c_longlong * 14)(*strides)
    err = lib.crc_attention_forward(
        _DTYPE_CODES[q4.dtype], q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
        bias_ptr, out4.data_ptr(), c_strides, e, h, lq, m, d ** -0.5,
        torch.cuda.current_stream(out4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel {kid} launch failed: "
                           f"cudaError {err}")
    LAUNCHES[kid] += 1


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
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("K2" if bias3 is not None else "K3", q, k, v, bias3, out)
    return out


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
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("K4" if bias3 is not None else "K1", q4, k4, v4, bias3,
            out.unflatten(-1, (num_heads, d)))
    return out
