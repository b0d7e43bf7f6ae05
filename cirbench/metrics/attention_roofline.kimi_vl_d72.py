"""The least time the traced call's MoonViT self-attention needs (its
operations at 989 TFLOP/s or its bytes at 3.35 TB/s, whichever is larger;
16 heads counted at 72 lanes, ``cirbench/counts/kimi_vl.py``) over the
device time of the attention kernel's 72-wide instantiation in that call
(``attn_fwd_tc_kernel<.., .., 72>``)."""
from cirbench.counts import kernels


def read(run: dict):
    names = run["trace"].get("kernels_us") or {}
    us = sum(t for name, t in names.items()
             if "attn_fwd_tc_kernel<" in name and ", 72>" in name)
    work = run["work"]
    if not us or "d72_attn_flops" not in work:
        return None
    least = kernels.least_seconds(work["d72_attn_flops"],
                                  work["d72_attn_bytes"])
    return 100.0 * least / (us / 1e6)
