"""The least time the traced call's ViT-g self-attention needs (its
operations at 989 TFLOP/s or its bytes at 3.35 TB/s, whichever is larger;
16 heads counted at 88 lanes, ``cirbench/counts/blip2.py``) over the
device time of the attention kernel's 88-wide instantiation in that call
(``attn_fwd_tc_kernel<.., .., 88>``)."""
from cirbench.counts import kernels


def read(run: dict):
    names = run["trace"].get("kernels_us") or {}
    us = sum(t for name, t in names.items()
             if "attn_fwd_tc_kernel<" in name and ", 88>" in name)
    work = run["work"]
    if not us or "d88_attn_flops" not in work:
        return None
    least = kernels.least_seconds(work["d88_attn_flops"],
                                  work["d88_attn_bytes"])
    return 100.0 * least / (us / 1e6)
