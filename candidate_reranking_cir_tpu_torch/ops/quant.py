"""int8 feature banks (port of the JAX package's ``ops/quant.py``).

The stage-II corpus bank ([N, 577, 768] token features, 2.04 GB in bf16
at CIRR-val's 2,297 images) is the largest object at evaluation and
serving time. Symmetric per-token int8 halves it: each (image, token) row
keeps an fp32 scale max|x| / 127, so an element moves by at most half a
step, max|row| / 254. ``take_rows`` is the one gather point of the
schedulers for both kinds of bank: an int8 bank is dequantized after the
gather, so only the gathered rows are ever held in bf16.

The arithmetic is the JAX package's, op for op (an fp32 amax, the scale
max(amax, 1e-12) / 127, round half to even, a clip to +-127), so ``q`` and
``scale`` equal JAX's bit for bit on the CPU. XLA compiles the division by
the constant 127 into a product with its fp32 reciprocal, so the port
multiplies by that reciprocal too (a true division differs in the last bit
of about one scale in 25).
"""
from __future__ import annotations

import torch

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


class Int8Bank:
    """Quantized [N, M, W] bank: ``q`` int8 [N, M, W] and per-(N, M) fp32
    ``scale`` [N, M, 1]."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4

    def to(self, device) -> "Int8Bank":
        """Both tensors on ``device`` (the bank itself when already
        there)."""
        return Int8Bank(self.q.to(device), self.scale.to(device))


def _quantize_chunk(x: torch.Tensor):
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.inference_mode()
def quantize_bank(feats: torch.Tensor, *, chunk: int = 512) -> Int8Bank:
    """[N, ..., W] float -> symmetric per-last-axis-row int8 (scale =
    max|x| / 127), on the bank's device.

    Quantizes ``chunk`` leading rows at a time into preallocated outputs,
    so the transient peak stays near bank + int8 output: a whole-bank pass
    would hold several full fp32 temporaries."""
    q = torch.empty(feats.shape, dtype=torch.int8, device=feats.device)
    scale = torch.empty((*feats.shape[:-1], 1), dtype=torch.float32,
                        device=feats.device)
    for s in range(0, feats.shape[0], chunk):
        q[s:s + chunk], scale[s:s + chunk] = _quantize_chunk(
            feats[s:s + chunk])
    return Int8Bank(q=q, scale=scale)


def dequantize(bank: Int8Bank, dtype=torch.bfloat16) -> torch.Tensor:
    return (bank.q.float() * bank.scale).to(dtype)


def take_rows(bank, idx, dtype=None) -> torch.Tensor:
    """Gather bank rows by leading-axis index (an int, or an integer tensor
    of any shape); an int8 bank is dequantized after the gather (to
    ``dtype``, default bf16). A plain tensor keeps its dtype unless
    ``dtype`` is given: a full-precision bank must not lose precision
    quietly."""
    if isinstance(bank, Int8Bank):
        return (bank.q[idx].float() * bank.scale[idx]).to(
            dtype or torch.bfloat16)
    rows = bank[idx]
    return rows.to(dtype) if dtype is not None else rows


def bank_len(bank) -> int:
    return bank.q.shape[0] if isinstance(bank, Int8Bank) else bank.shape[0]
