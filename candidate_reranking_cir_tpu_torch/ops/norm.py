"""The residual add and the LayerNorm after it, and its plain version.

``add_layer_norm(x, residual, weight, bias, eps)`` is the one entry point:
``models/layers.LayerNorm`` calls it for every LayerNorm of the port, with
the residual its block adds first (the post-LN MED, Q-Former and dual
encoder, the pre-LN ViT's ``norm2``) or without one (``norm1``, the final
norms, the embeddings). The route follows from the input alone:

- bf16 tensors on the card run ``csrc/layer_norm.cu``: one read of each
  input, one write of the output (and of the sum ``x + residual`` with
  ``keep_sum``, the pre-LN ViT's residual stream);
- an fp32 tensor (or an fp32 sum), or any tensor on the CPU, runs the plain
  version (``add_layer_norm_plain``: the eager add, then the fp32 LayerNorm
  of ``LayerNorm.forward`` as it always was), which stays the definition;
- any other tensor on the card (fp16, a bf16 input normalised into another
  dtype) raises.

The kernel replaces no TPU kernel: the JAX package leaves LayerNorm to XLA,
which fuses it; run eagerly on the card it was some 13 launches a call,
most of them fp32 passes over [rows, width] (``csrc/layer_norm.cu`` has
the numerics and the bound). The kernel sums the fp32 statistics in
another order than PyTorch's reductions, so it is not bit-equal to the
plain version: the bound is bf16's, 2e-2 absolute and relative.

A non-contiguous operand (the per-pair layouts' stride-0 ``expand`` of h0
and h1 in ``DualStreamEncoder``, the Q-Former's row slices) is made
contiguous once, in the wrapper, before the launch.

Gradients: where an input wants one, the kernel runs inside
``_AddLayerNorm``, whose backward recomputes the plain version under
autograd, as ``ops/activation._BiasGelu`` does.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the calls that took
the plain version.
"""
from __future__ import annotations

import torch

LAUNCHES = {"add_layer_norm": 0}
PLAIN_CALLS = {"add_layer_norm": 0}


def reset_launch_counts() -> None:
    LAUNCHES["add_layer_norm"] = 0
    PLAIN_CALLS["add_layer_norm"] = 0


def add_layer_norm_plain(x, residual, weight, bias, eps: float,
                         keep_sum: bool = False, dtype=None):
    """The eager route: ``s = x + residual`` (``s = x`` without one), then
    an fp32 LayerNorm of ``s`` with ``weight``/``bias`` cast to ``dtype``
    (None: ``s``'s). Returns ``y``, or ``(y, s)`` with ``keep_sum``."""
    s = x if residual is None else x + residual
    x32 = s.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = (y * weight + bias).to(s.dtype if dtype is None else dtype)
    return (y, s) if keep_sum else y


def _check_kernel_inputs(x, residual, weight, bias, dtype) -> None:
    if x.dtype != torch.bfloat16 or (residual is not None
                                     and residual.dtype != torch.bfloat16):
        raise ValueError("add_layer_norm kernel takes bfloat16 on the card; "
                         f"got {x.dtype}" + ("" if residual is None else
                                              f" + {residual.dtype}"))
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"add_layer_norm kernel writes bfloat16; {dtype} "
                         "was asked for")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError("add_layer_norm kernel takes [.., n >= 1]; got "
                         f"shape {tuple(x.shape)}")
    if residual is not None and residual.device != x.device:
        raise ValueError(f"residual must be on {x.device}; got "
                         f"{residual.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device \
                or t.shape != x.shape[-1:] or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[{x.shape[-1]}] on {x.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_forward(x, residual, weight, bias, eps: float,
                    keep_sum: bool = False, dtype=None):
    """One launch of ``csrc/layer_norm.cu`` on the current stream."""
    from candidate_reranking_cir_tpu_torch.ops.build import (
        load_layer_norm_library,
    )

    _check_kernel_inputs(x, residual, weight, bias, dtype)
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    out = torch.empty_like(x)
    s = torch.empty_like(x) if keep_sum else None
    n = x.shape[-1]
    rows = x.numel() // n
    if rows:
        err = load_layer_norm_library().crc_add_layer_norm(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if s is None else s.data_ptr(), rows, n, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"add_layer_norm kernel launch failed: code "
                               f"{err} (a cudaError, or -1 for an empty or "
                               "too large shape)")
        LAUNCHES["add_layer_norm"] += 1
    return (out, s) if keep_sum else out


class _AddLayerNorm(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain version recomputed under
    autograd."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps, keep_sum, dtype):
        ctx.save_for_backward(x, residual, weight, bias)
        ctx.args = (eps, keep_sum, dtype)
        return _kernel_forward(x, residual, weight, bias, eps, keep_sum,
                               dtype)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:4]
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = add_layer_norm_plain(*inputs, *ctx.args)
            outs = outs if ctx.args[1] else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs],
                                           allow_unused=True))
        return tuple(next(got) if n else None for n in needs) + (None,) * 3


def add_layer_norm(x, residual, weight, bias, eps: float,
                   keep_sum: bool = False, dtype=None):
    """``LayerNorm(x + residual)`` as ``models/layers.LayerNorm`` computes
    it: ``x`` and ``residual`` [.., n] in the compute dtype (``residual``
    None: the LayerNorm of ``x``), ``weight``/``bias`` the fp32 [n]
    parameters, ``dtype`` the output's (None: the sum's). Returns ``y``, or
    ``(y, x + residual)`` with ``keep_sum``."""
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if keep_sum and residual is None:
        raise ValueError("keep_sum needs a residual")
    summed = x.dtype if residual is None else torch.promote_types(
        x.dtype, residual.dtype)
    if x.device.type == "cpu" or summed == torch.float32:
        PLAIN_CALLS["add_layer_norm"] += 1
        return add_layer_norm_plain(x, residual, weight, bias, eps, keep_sum,
                                    dtype)
    tensors = (x, residual, weight, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _AddLayerNorm.apply(*tensors, eps, keep_sum, dtype)
    return _kernel_forward(*tensors, eps, keep_sum, dtype)
