"""The least time the traced call's attention needs (its operations at
989 TFLOP/s or its bytes at 3.35 TB/s, whichever is larger; counted from
the work at real lengths, ``cirbench/counts/blip.py``) over the device
time of the port's attention kernels in that call."""
from cirbench.counts import kernels


def read(run: dict):
    fam = run["trace"].get("families_us")
    if not fam or not fam.get(kernels.ATTENTION):
        return None
    work = run["work"]
    least = kernels.least_seconds(work["attn_flops"], work["attn_bytes"])
    return 100.0 * least / (fam[kernels.ATTENTION] / 1e6)
