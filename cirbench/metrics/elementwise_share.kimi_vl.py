"""The share of the traced Kimi-VL call's device time (kernels and copies)
in kernels that are neither products (cuBLAS, the grouped experts'
CUTLASS GEMM), nor the port's attention kernels, nor the latent
attention's fused SDPA kernels (cuDNN or flash, whose names hold 'sdpa'
or 'flash'): the eager glue of norms, rotary, gathers, concatenations and
casts. ``elementwise_share.eval`` counts the SDPA kernels as glue."""
from cirbench.counts import kernels


def read(run: dict):
    names = run["trace"].get("kernels_us")
    if not names:
        return None
    glue = sum(us for name, us in names.items()
               if kernels.family(name) == kernels.OTHER
               and not any(s in name.lower() for s in ("sdpa", "flash")))
    return 100.0 * glue / sum(names.values())
