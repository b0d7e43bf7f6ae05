"""Kernel families by name, and the card's peaks.

The families follow the port's smoke script (``kernel_family``): the
port's attention kernels (eval K1-K4, training K6-K9, their tensor-core
and fp32-FMA bodies), cuBLAS's products, copies, and everything else
(elementwise work, norms, gathers, reductions, the optimizer)."""
from __future__ import annotations

# NVIDIA's data sheet for one H100 SXM, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

ATTENTION = "attention"
GEMM = "gemm"
COPIES = "copies"
OTHER = "elementwise"

# substrings of the port's attention kernels (csrc/attention*.cu[h])
ATTENTION_NAMES = (
    "attn_fwd_tc_kernel", "attn_fwd_kernel",
    "attn_train_fwd_tc_kernel", "attn_train_fwd_kernel",
    "attn_train_fwd_folded_tc_kernel", "attn_train_fwd_folded_kernel",
    "attn_train_bwd_tc_rows_kernel", "attn_train_bwd_tc_keys_kernel",
    "attn_bwd_tc_rows_kernel", "attn_bwd_tc_keys_kernel",
    "attn_bwd_rows_kernel", "attn_bwd_keys_kernel",
    "attn_bwd_rows_folded_kernel", "attn_bwd_keys_folded_kernel",
)
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")


def family(name: str) -> str:
    if any(s in name for s in ATTENTION_NAMES):
        return ATTENTION
    low = name.lower()
    if any(s in low for s in GEMM_NAMES):
        return GEMM
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return COPIES
    return OTHER


def least_seconds(flops: float, n_bytes: float) -> float:
    """The least time the card needs: the larger of the operations at the
    bf16 peak and the bytes at HBM's."""
    return max(flops / PEAK_BF16_FLOPS, n_bytes / HBM_BYTES_PER_S)
