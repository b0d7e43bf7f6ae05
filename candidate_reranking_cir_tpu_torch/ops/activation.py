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
``registry.PlainBackward``, whose backward recomputes the plain version
under autograd. ``registry`` counts the launches ("G1") and the calls that
took the plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from candidate_reranking_cir_tpu_torch.ops import build, registry
from candidate_reranking_cir_tpu_torch.ops.registry import FUSED, PLAIN_CALLS


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
    _check_kernel_inputs(product, bias)
    out = torch.empty_like(product)
    n = product.shape[-1]
    rows = product.numel() // n if n else 0
    if rows == 0:
        return out
    err = build.load("activation").crc_bias_gelu(
        product.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), rows, n,
        torch.cuda.current_stream(product.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bias_gelu kernel launch failed: code {err} (a "
                           "cudaError, or -1 for an empty shape)")
    FUSED["G1"] += 1
    return out


def bias_gelu(product, bias=None):
    """``exact_gelu(product + bias)`` as ``Dense`` and ``exact_gelu`` compute
    it: ``product`` fc1's output without its bias [.., n] in the compute
    dtype, ``bias`` fc1's fp32 bias [n] or None. Returns the activation in
    the product's dtype."""
    if product.device.type == "cpu" or product.dtype == torch.float32:
        PLAIN_CALLS["G1"] += 1
        return bias_gelu_plain(product, bias)
    return registry.run(_kernel_forward, bias_gelu_plain, product, bias)
