"""fc1's bias add and the exact GELU of every FFN, and its plain version.

``bias_gelu(product, bias)`` is the one entry point: the ViT's ``Mlp``,
the MED's and the dual encoder's ``BertFFN`` and the caption head's
``BertLMHead`` hand it fc1's product without the bias (``Dense.product``)
and fc1's fp32 bias. The route follows from the input alone:

- a bf16 tensor on the card runs ``csrc/activation.cu`` (one read of the
  product, one write of the activation), bit-equal to the plain version;
- an fp32 tensor, or any tensor on the CPU, runs the plain version
  (``bias_gelu_plain``: ``Dense``'s bias add in the compute dtype, then
  ``exact_gelu``), which stays the definition;
- any other tensor on the card (fp16, a non-contiguous view) raises.

The kernel replaces no TPU kernel: the JAX package leaves this formula to
XLA, which fuses it into fc1's epilogue; run eagerly on the card it was
some 26 fp32 passes over [rows, 3072] (``csrc/activation.cu`` has the
numerics and the bound).

Gradients: where an input wants one, the kernel runs inside
``_BiasGelu``, whose backward recomputes the plain version under
autograd, as ``cuda_attention._EvalAttention`` does for K1-K4.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the calls that
took the plain version; neither is one of the attention kernels' counters.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LAUNCHES = {"bias_gelu": 0}
PLAIN_CALLS = {"bias_gelu": 0}


def reset_launch_counts() -> None:
    LAUNCHES["bias_gelu"] = 0
    PLAIN_CALLS["bias_gelu"] = 0


def exact_gelu(x):
    """Erf-based GELU. float32: the exact erf form. Other dtypes: the JAX
    package's rational erf (Abramowitz & Stegun 7.1.26) evaluated in
    float32 and cast back, reproduced term for term."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    x32 = x.float()
    u = x32.abs() * 0.7071067811865476
    t = 1.0 / (1.0 + 0.3275911 * u)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(x32) * (1.0 - poly * torch.exp(-u * u))
    return (0.5 * x32 * (1.0 + erf)).to(x.dtype)


def bias_gelu_plain(product, bias=None):
    """``exact_gelu`` of ``Dense``'s output: the bias cast to the product's
    dtype and added in it, then the GELU."""
    if bias is not None:
        product = product + bias.to(product.dtype)
    return exact_gelu(product)


def _check_kernel_inputs(product, bias) -> None:
    if product.dtype != torch.bfloat16:
        raise ValueError(f"bias_gelu kernel takes bfloat16 on the card; got "
                         f"{product.dtype}")
    if product.ndim < 1 or not product.is_contiguous():
        raise ValueError("bias_gelu kernel takes a contiguous product; got "
                         f"shape {tuple(product.shape)}, strides "
                         f"{tuple(product.stride())}")
    if bias is None:
        return
    if bias.dtype != torch.float32 or bias.device != product.device:
        raise ValueError(f"bias must be float32 on {product.device}; got "
                         f"{bias.dtype} on {bias.device}")
    if bias.shape != product.shape[-1:] or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous [{product.shape[-1]}]; "
                         f"got shape {tuple(bias.shape)}")


def _kernel_forward(product, bias):
    """One launch of ``csrc/activation.cu`` on the current stream."""
    from candidate_reranking_cir_tpu_torch.ops.build import (
        load_activation_library,
    )

    _check_kernel_inputs(product, bias)
    out = torch.empty_like(product)
    n = product.shape[-1]
    rows = product.numel() // n if n else 0
    if rows == 0:
        return out
    err = load_activation_library().crc_bias_gelu(
        product.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), rows, n,
        torch.cuda.current_stream(product.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bias_gelu kernel launch failed: code {err} (a "
                           "cudaError, or -1 for an empty shape)")
    LAUNCHES["bias_gelu"] += 1
    return out


class _BiasGelu(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain version recomputed under
    autograd."""

    @staticmethod
    def forward(ctx, product, bias):
        ctx.save_for_backward(product, bias)
        return _kernel_forward(product, bias)

    @staticmethod
    def backward(ctx, g):
        product, bias = ctx.saved_tensors
        needs = ctx.needs_input_grad
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip((product, bias), needs)]
        with torch.enable_grad():
            out = bias_gelu_plain(*inputs)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if n else None for n in needs)


def bias_gelu(product, bias=None):
    """``exact_gelu(product + bias)`` as ``Dense`` and ``exact_gelu`` compute
    it: ``product`` fc1's output without its bias [.., n] in the compute
    dtype, ``bias`` fc1's fp32 bias [n] or None. Returns the activation in
    the product's dtype."""
    if product.device.type == "cpu" or product.dtype == torch.float32:
        PLAIN_CALLS["bias_gelu"] += 1
        return bias_gelu_plain(product, bias)
    wants_grad = product.requires_grad or (bias is not None
                                           and bias.requires_grad)
    if torch.is_grad_enabled() and wants_grad:
        return _BiasGelu.apply(product, bias)
    return _kernel_forward(product, bias)
