"""The share of device time in kernels outside the products (cuBLAS) and
the port's attention kernels, over all device time (kernels and copies),
in the traced call."""
from cirbench.counts import kernels


def read(run: dict):
    fam = run["trace"].get("families_us")
    if not fam:
        return None
    total = sum(fam.values())
    return 100.0 * fam.get(kernels.OTHER, 0.0) / total
