"""The least time the traced stretch's attention needs (its answered
requests' attention operations at 989 TFLOP/s or bytes at 3.35 TB/s,
whichever is larger; ``cirbench/counts/blip.py``) over the device time of
the port's attention kernels in that stretch."""
from cirbench.counts import kernels


def read(run: dict):
    fam = run["trace"].get("families_us")
    traced = run.get("traced")
    if not fam or not fam.get(kernels.ATTENTION) or not traced:
        return None
    done = sum(r.get("status") == 200 for r in traced["records"])
    work = run["work"]
    least = kernels.least_seconds(done * work["attn_flops"],
                                  done * work["attn_bytes"])
    return 100.0 * least / (fam[kernels.ATTENTION] / 1e6)
